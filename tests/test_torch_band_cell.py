"""The banded deployment ``wfa_nw_x4_o6_e2_bw100`` (WFA's long-read pairs
in BWA-MEM's band of 100) through ``Aligner.banded_nw_batch`` on the CPU's
plain versions.

The configuration's own file gives the scoring and the band; the
benchmark's ``pairs`` generator gives 600 bp pairs with 5% edits.  On
them, at the configuration's band, at a band of 8 (which these pairs'
paths still keep to), at a band of 3 that they leave, and on a pair whose
corner lies outside the band (-2^30),
``banded_nw_batch``'s scores and ends must equal the benchmark's plain
reference (``benchmark/reference/sweep.py``) exactly, and where the band
holds the path the unbanded ``align_many`` score.  With spans on, the
band's counters must read the benchmark's count of in-band cells
(``roofline.cells``) and a swept count no smaller.  A fault planted in
``Aligner._alignments_from`` must reach the banded results, whose flags
stay the JAX package's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parasail_rs_tpu as ref  # noqa: E402

import parasail_rs_tpu_torch as port  # noqa: E402
from parasail_rs_tpu_torch.engine.aligner import Aligner  # noqa: E402
from parasail_rs_tpu_torch.utils import stages  # noqa: E402
from parasail_rs_tpu_torch.utils.shapes import length_bucket  # noqa: E402

from benchmark import harness, roofline  # noqa: E402
from benchmark.entries.system import builder, matrix  # noqa: E402
from benchmark.reference import sweep  # noqa: E402
from benchmark.traffic import pairs  # noqa: E402
from benchmark.traffic.request import Request  # noqa: E402

from test_torch_engine import _seqs, _summary, matrix_for  # noqa: E402

CONFIG = harness.load_json(harness.HERE, "configs",
                           "wfa_nw_x4_o6_e2_bw100.json")
SEED = 2**31 + 25
MIX = {"generator": "pairs", "entry": "banded_nw_batch", "length": 600,
       "partner": "errors", "pool": 4, "per_call": 4, "keep_random": 1,
       "sample": {"size": 4}}
NEG = -(1 << 30)


def _pairs():
    req = pairs.make(CONFIG, MIX, SEED).request(0)
    return list(req.queries), list(req.refs)


def _case(name):
    """(queries, refs, bandwidth) of a case."""
    qs, rs = _pairs()
    if name == "bw100":
        return qs, rs, CONFIG["scoring"]["bandwidth"]
    if name in ("bw8", "bw3"):
        return qs, rs, int(name[2:])
    # the corner (600, 450) lies 150 off the diagonal
    return qs[:1] + qs, [rs[0][:450]] + rs, CONFIG["scoring"]["bandwidth"]


CASES = ["bw100", "bw8", "bw3", "corner"]


def _scoring(bw):
    return dict(CONFIG["scoring"], bandwidth=bw)


def _aligner(scoring):
    return builder(scoring, "cpu").matrix(matrix(scoring["matrix"])).build()


def _answers(res):
    return [(a.get_score(), a.get_end_query(), a.get_end_ref())
            for a in res]


def test_configuration_is_the_wfa_scoring_in_bwa_mems_band():
    base = harness.load_json(harness.HERE, "configs", "wfa_nw_x4_o6_e2.json")
    assert CONFIG["scoring"] == dict(base["scoring"], bandwidth=100)
    for k in ("sequences", "errors", "gap_mapping"):
        assert CONFIG[k] == base[k]
    assert CONFIG["reduced"] == []


@pytest.mark.parametrize("case", CASES)
def test_banded_answers_equal_the_reference(case):
    qs, rs, bw = _case(case)
    got = _answers(_aligner(_scoring(bw)).banded_nw_batch(qs, rs))
    want = sweep.align(list(zip(qs, rs)), _scoring(bw), cigar=False)
    assert got == [w[:3] for w in want]
    if case == "corner":
        assert got[0] == (NEG, len(qs[0]) - 1, 449)
    if case == "bw3":
        # the band cuts a path: a pair whose corner it reaches scores
        # below its unbanded score
        full = _aligner(dict(CONFIG["scoring"], bandwidth=None))
        unbanded = [a.get_score() for a in full.align_many(qs, rs)]
        assert any(NEG < g[0] < u for g, u in zip(got, unbanded))


@pytest.mark.parametrize("case", ["bw100", "corner"])
def test_band_that_holds_the_path_gives_the_unbanded_score(case):
    qs, rs, bw = _case(case)
    if case == "corner":        # the pairs whose corner the band reaches
        qs, rs = qs[1:], rs[1:]
    banded = _aligner(_scoring(bw)).banded_nw_batch(qs, rs)
    full = _aligner(dict(CONFIG["scoring"], bandwidth=None)).align_many(
        qs, rs)
    assert _answers(banded) == _answers(full)
    assert max(abs(len(q) - len(r)) for q, r in zip(qs, rs)) <= bw


@pytest.mark.parametrize("case", CASES)
def test_band_counters_read_the_in_band_cells(case):
    qs, rs, bw = _case(case)
    al = _aligner(_scoring(bw))
    with stages.measuring():
        al.banded_nw_batch(qs, rs)
        snap = stages.snapshot()
    req = Request(refs=rs, rlens=np.array([len(r) for r in rs]),
                  qlens=np.array([len(q) for q in qs]), queries=qs)
    band = snap["count.cells_band"]["n"]
    swept = snap["count.cells_band_swept"]["n"]
    assert band == roofline.cells(req, _scoring(bw)) > 0
    # on the CPU the plain version sweeps every padded cell
    assert swept >= band
    assert swept == (len(rs) * length_bucket(max(map(len, qs)))
                     * length_bucket(max(map(len, rs))))


@pytest.mark.parametrize("fault", ["score", "half"])
def test_fault_planted_in_the_builder_reaches_the_band(fault, monkeypatch):
    qs, rs, bw = _case("bw100")
    al = _aligner(_scoring(bw))
    sound = _answers(al.banded_nw_batch(qs, rs))
    orig = Aligner._alignments_from

    def faulty(self, out, qlens, rlens):
        out = {k: np.array(v, copy=True) for k, v in out.items()}
        if fault == "score":
            out["score"] += 1
        else:
            for k in ("score", "end_query", "end_ref"):
                out[k][len(rlens) // 2:] = 0
        return orig(self, out, qlens, rlens)

    monkeypatch.setattr(Aligner, "_alignments_from", faulty)
    altered = _answers(al.banded_nw_batch(qs, rs))
    if fault == "score":
        assert altered == [(s + 1, q, r) for s, q, r in sound]
    else:
        half = len(rs) // 2
        assert altered[:half] == sound[:half]
        assert altered[half:] == [(0, 0, 0)] * (len(rs) - half)


DNA = ref.Matrix.create(b"ACGT", 0, -4)


@pytest.mark.parametrize("setters", [(), ("use_stats",), ("use_table",),
                                     ("local",)],
                         ids=["score", "stats", "table", "local"])
def test_banded_flags_stay_the_references(setters):
    qs, rs = _seqs(41, b"ACGT", 5, 10, 40), _seqs(42, b"ACGT", 5, 10, 40)

    def make(b):
        b = b.matrix(matrix_for(b, DNA)).gap_open(8).gap_extend(2)
        for s in setters:
            b = getattr(b, s)()
        return b.bandwidth(6)

    p = make(port.Aligner.new()).device("cpu").build()
    r = make(ref.Aligner.new()).build()
    got = p.banded_nw_batch(qs, rs)
    assert _summary(got) == _summary(r.banded_nw_batch(qs, rs))
    assert all(a.is_banded() and a.is_global() and not a.is_saturated()
               for a in got)
