"""The port's length bins over index arrays (``engine.binning``) against
the reference's per-pair loop.

``binning.plan_bins`` must return ``batch.plan_bins``' bins list for
list: the same (qp, rp), the same order, the same indices in the same
order, so that ``merge_bins``, the launches and every answer stay as
they were.  The cases are the benchmark's length sets (the search's
log-normal entries under the 20 standard query lengths, the 100 bp
pairs), tests/test_torch_engine_many.py's mixed pairs, every rung of the
ladder and its neighbours, and caps that split groups.  Then
``_shape_bins`` under each caller's parameters, and the three binned
methods with the per-pair loop made to raise.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parasail_rs_tpu as ref  # noqa: E402
from parasail_rs_tpu import batch as ref_batch  # noqa: E402
from parasail_rs_tpu.golden import model as golden  # noqa: E402

import parasail_rs_tpu_torch as port  # noqa: E402
from parasail_rs_tpu_torch import batch  # noqa: E402
from parasail_rs_tpu_torch.engine import binning  # noqa: E402
from parasail_rs_tpu_torch.utils.shapes import length_bucket  # noqa: E402

from test_torch_engine import BLOSUM62, PROTEIN, _seqs  # noqa: E402
from test_torch_engine_ssw import (  # noqa: E402
    _both,
    _planted,
    _port_profile,
    _ssw,
)

# the 20 standard queries' lengths (benchmark/configs/swissprot_sw_blosum62)
QUERIES = [144, 189, 222, 375, 464, 567, 657, 729, 850, 1000, 1500, 2005,
           2504, 3005, 3564, 4061, 4548, 4743, 5147, 5478]


def _entries(seed, n):
    """Swiss-Prot-like entry lengths: log-normal, mean 361, sigma 0.75,
    clipped to [2, 35,213]."""
    rng = np.random.default_rng(seed)
    mu = np.log(361) - 0.75 ** 2 / 2
    return np.clip(np.round(rng.lognormal(mu, 0.75, n)), 2, 35_213) \
        .astype(np.int64).tolist()


def _rungs_and_neighbours(top):
    rungs = [16]
    while rungs[-1] < top:
        rungs.append(length_bucket(rungs[-1] + 1))
    return sorted({max(0, r + d) for r in rungs for d in (-1, 0, 1)})


def _cases():
    """name -> (query lengths or one int, reference lengths)."""
    rng = np.random.default_rng(3)
    edge = _rungs_and_neighbours(1 << 17) + [35_212, 35_213, 35_214, 65_536,
                                            65_537, 100_000]
    out = {f"profile_{q}": (q, _entries(q, 4096)) for q in
           (144, 567, 2005, 5478)}
    out["per_pair_queries"] = (
        [QUERIES[i] for i in rng.integers(0, 20, 2048)], _entries(7, 2048))
    wfa = rng.integers(95, 106, (2, 8192)).tolist()
    out["wfa_100bp"] = (wfa[0], wfa[1])
    out["mixed_70x120"] = (rng.integers(1, 70, 500).tolist(),
                           rng.integers(1, 120, 500).tolist())
    out["ladder_edges"] = (edge, edge[::-1])
    out["ladder_edges_by_profile"] = (65_537, edge)
    out["one_pair"] = ([37], [1000])
    out["empty"] = ([], [])
    return out


CASES = _cases()
# (max_cells, lane_quantum): the two caps of the callers, and one that
# splits a group of 128 x 128 tiles into launches of 4
CAPS = [(1 << 28, 1), (1 << 33, 128), (1 << 16, 1), (1 << 16, 128)]


def _per_pair(qlens, n):
    return [qlens] * n if isinstance(qlens, int) else qlens


@pytest.mark.parametrize("cap", CAPS, ids=lambda c: f"{c[0]:#x}_q{c[1]}")
@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_equals_the_per_pair_loop(name, cap):
    qlens, rlens = CASES[name]
    max_cells, quantum = cap
    got = binning.plan_bins(qlens, rlens, max_cells=max_cells,
                            lane_quantum=quantum)
    qall = _per_pair(qlens, len(rlens))
    want = batch.plan_bins(qall, rlens, max_cells=max_cells,
                           lane_quantum=quantum)
    assert got == want
    assert all(type(i) is int for b in got for i in b.indices)
    theirs = ref_batch.plan_bins(qall, rlens, max_cells=max_cells,
                                 lane_quantum=quantum)
    assert [(b.qp, b.rp, b.indices) for b in got] == \
        [(b.qp, b.rp, b.indices) for b in theirs]
    # the lengths as arrays, a profile's length repeated: the same plan
    assert binning.plan_bins(np.asarray(qall, np.int64),
                             np.asarray(rlens, np.int64),
                             max_cells=max_cells, lane_quantum=quantum) == got


def test_a_small_cap_splits_groups():
    qlens, rlens = CASES["profile_144"]
    plan = binning.plan_bins(qlens, rlens, max_cells=1 << 16)
    keys = [(b.qp, b.rp) for b in plan]
    assert len(keys) > len(set(keys))


def test_bucket_equals_length_bucket_to_2_17():
    n = np.arange((1 << 17) + 1)
    ladder = binning._ladder(17)
    got = ladder[binning._rung_of(n, ladder)]
    assert got.tolist() == [length_bucket(int(x)) for x in n]


def test_ladder_is_length_buckets_own():
    ladder = binning._ladder(20).tolist()
    assert ladder[:8] == [16, 24, 32, 48, 64, 96, 128, 192]
    assert ladder[-1] >= 1 << 20 > ladder[-2]
    assert all(length_bucket(r) == r for r in ladder)
    with pytest.raises(ValueError):
        binning._ladder(20)[0] = 8          # shared: read-only


# -- _shape_bins under each caller's parameters -------------------------------


def _stub_card(monkeypatch, total_memory):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: SimpleNamespace(
                            total_memory=total_memory))


# caller -> (cell_sized, plane_on, the cap and launch limit it implies)
CALLERS = {
    "align_many_score": (False, None, 1 << 33, 128, 8),
    "align_many_trace": (True, None, 1 << 28, 1, 16),
    "align_cigars_cpu": (True, torch.device("cpu"), 1 << 28, 1, 16),
    "align_cigars_card": (True, torch.device("cuda"), 20 << 30, 1, 16),
}


@pytest.mark.parametrize("case", ["profile_567", "profile_5478",
                                  "per_pair_queries", "mixed_70x120",
                                  "ladder_edges", "wfa_100bp", "empty"])
@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_shape_bins_equals_merged_per_pair_plan(caller, case, monkeypatch):
    _stub_card(monkeypatch, 80 << 30)
    cell_sized, plane_on, cap, quantum, launches = CALLERS[caller]
    qlens, rlens = CASES[case]
    got = binning._shape_bins(qlens, rlens, cell_sized,
                              plane_on=plane_on)
    want = batch.merge_bins(
        batch.plan_bins(_per_pair(qlens, len(rlens)), rlens, max_cells=cap,
                        lane_quantum=quantum),
        max_launches=launches, max_cells=cap)
    assert got == want


# -- the binned methods never run the per-pair loop ---------------------------


@pytest.fixture
def no_loop(monkeypatch):
    """``batch.plan_bins`` raises wherever it is reached from."""
    def loop(*args, **kwargs):
        raise AssertionError("the per-pair plan ran")

    from parasail_rs_tpu_torch.batch import scheduler

    monkeypatch.setattr(batch, "plan_bins", loop)
    monkeypatch.setattr(scheduler, "plan_bins", loop)


def _golden(qs, rs, mode):
    return [(g.score, g.end_query, g.end_ref) for g in (
        golden.align_seqs(q, r, BLOSUM62, 11, 1, mode)
        for q, r in zip(qs, rs))]


@pytest.mark.parametrize("outputs", ["score", "stats", "trace"])
def test_align_many_without_the_loop(outputs, no_loop):
    qs, rs = _seqs(1, PROTEIN, 24, 1, 70), _seqs(2, PROTEIN, 24, 1, 120)
    b = (port.Aligner.new().matrix(port.Matrix.from_name("blosum62"))
         .gap_open(11).gap_extend(1).local().device("cpu"))
    if outputs != "score":
        b = getattr(b, f"use_{outputs}")()
    p = b.build()
    many = p.align_many(qs, rs, max_cells=1 << 16)
    got = [(a.get_score(), a.get_end_query(), a.get_end_ref()) for a in many]
    assert got == _golden(qs, rs, "sw")
    assert got == [(a.get_score(), a.get_end_query(), a.get_end_ref())
                   for a in p.align_batch(qs, rs)]


def test_align_many_profile_without_the_loop(no_loop):
    q = _seqs(23, PROTEIN, 1, 48, 49)[0]
    rs = _seqs(24, PROTEIN, 40, 20, 400)
    prof = port.Profile.new(q, False, port.Matrix.from_name("blosum62"))
    p = (port.Aligner.new().profile(prof).gap_open(11).gap_extend(1)
         .local().device("cpu").build())
    many = p.align_many(None, rs, max_cells=1 << 14)
    got = [(a.get_score(), a.get_end_query(), a.get_end_ref()) for a in many]
    assert got == _golden([q] * len(rs), rs, "sw")


@pytest.mark.parametrize("mode", ["nw", "semi_global", "local"])
def test_align_cigars_without_the_loop(mode, no_loop):
    qs = (_seqs(71, b"ACGT", 4, 4, 10) + _seqs(72, b"ACGT", 4, 200, 400) +
          _seqs(73, b"ACGT", 4, 30, 60))
    rs = (_seqs(74, b"ACGT", 4, 4, 10) + _seqs(75, b"ACGT", 4, 200, 400) +
          _seqs(76, b"ACGT", 4, 30, 60))
    b = port.Aligner.new().gap_open(4).gap_extend(1).device("cpu")
    if mode != "nw":
        b = getattr(b, mode)()
    alns, cigs = b.build().align_cigars(qs, rs)
    tr = b.use_trace().build()
    want = tr.align_batch(qs, rs)
    assert cigs == [a.get_cigar(q, r) for a, q, r in zip(want, qs, rs)]
    assert [(a.get_score(), a.get_end_query(), a.get_end_ref())
            for a in alns] == [(a.get_score(), a.get_end_query(),
                                a.get_end_ref()) for a in want]


def test_ssw_batch_windowed_without_the_loop(no_loop):
    # tests/test_torch_engine_ssw.py's windowed case: three binned passes
    qs, rs = _planted(7)
    r, p = _both(BLOSUM62, 11, 1)
    assert _ssw(p.ssw_batch(qs, rs, windowed=True)) == \
        _ssw(r.ssw_batch(qs, rs, windowed=True))


def test_ssw_batch_windowed_profile_without_the_loop(no_loop):
    # tests/test_torch_engine_ssw.py's 16-bit profile case, windowed
    m = ref.Matrix.create(b"ACGT", 5, -4)
    q = b"ACGT" * 40
    refs = [q, q[:20]]
    r_prof = ref.Profile.new_ssw(q, m, 1)
    r = ref.Aligner.new().profile(r_prof).gap_open(10).gap_extend(1).build()
    p = (port.Aligner.new().profile(_port_profile(r_prof)).gap_open(10)
         .gap_extend(1).device("cpu").build())
    got = p.ssw_batch(None, refs, windowed=True)
    assert [s.score() for s in got] == [800, 100]
    assert _ssw(got) == _ssw(r.ssw_batch(None, refs, windowed=True))
