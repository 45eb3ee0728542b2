"""The check that decides ``correct``: every cell passes at a small size
on the CPU's plain versions, and fails with its controls (the reference
in 8-bit saturating arithmetic, or with the sources' gap open, in the
program's place) and with each fault a cell can have planted under the
timed path.  Not applicable to these cells: a step that returns its
state unchanged (no call carries state) and the exchange between chips
(one chip).  Semantics no cell states yet (semi-global free ends, a
band) run through the same check by overrides."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness, roofline

from .conftest import BENCH, CONTROL, SMALL

CELLS = list(SMALL)
SEED = 2**31 + 11


def _entry(cell):
    mix = harness.merged(harness.cell_spec(cell)[3],
                         SMALL[cell].get("traffic"))
    return harness.load_module("entries", mix["entry"])


# the cells whose answers carry a CIGAR, and those that run a batch
CIGAR_CELLS = [c for c in CELLS if _entry(c).CIGAR]
GCUPS_CELLS = [c for c in CELLS if any(
    m["name"] == "gcups" for m in harness.metrics_of(BENCH, c, False))]


def _run(cell, device="cpu", trace=False, **kw):
    return harness.run(cell, SEED, 0.3, trace, device=device,
                       overrides=SMALL[cell], **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["compared"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in harness.metrics_of(
        harness.cell_spec(cell)[0], cell, False)}


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if CONTROL[c] == "saturate8"])
def test_control_is_not_correct(cell):
    r = _run(cell, control=True)
    assert not r["correct"]
    assert r["checks"]["score_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_gap_control_is_not_correct(cell):
    # a window of one call, the fewest answers a loaded CPU leaves
    r = harness.run(cell, SEED, 0, False, device="cpu",
                    overrides=SMALL[cell], control="gap")
    assert not r["correct"]
    assert r["checks"]["score_mismatch"]["value"] > 0


def test_an_unknown_control_is_refused():
    with pytest.raises(ValueError):
        _run("wfa.100_e5.cigar", control="int4")


def _patch_outputs(monkeypatch, alter):
    """``alter(out, n)`` on a copy of the columnar outputs of a batch of
    ``n`` pairs, where the port makes its results of them: every
    ``Aligner._alignments_from``, and the band's ``dispatch.slice_pair``
    a pair (``banded_nw_batch``)."""
    from parasail_rs_tpu_torch.engine import dispatch
    from parasail_rs_tpu_torch.engine.aligner import Aligner

    def altered(out, n):
        out = {k: np.array(v, copy=True) for k, v in out.items()}
        alter(out, n)
        return out

    orig = Aligner._alignments_from

    def faulty(self, out, qlens, rlens):
        return orig(self, altered(out, len(rlens)), qlens, rlens)

    orig_slice = dispatch.slice_pair
    seen = {}

    def faulty_slice(out, b, qlen, rlen):
        if seen.get("of") is not out:        # once a batch, not a pair
            seen.update(of=out, to=altered(out, len(out["score"])))
        return orig_slice(seen["to"], b, qlen, rlen)

    monkeypatch.setattr(Aligner, "_alignments_from", faulty)
    monkeypatch.setattr(dispatch, "slice_pair", faulty_slice)


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(cell, monkeypatch):
    def alter(out, n):
        out["score"] += 1

    _patch_outputs(monkeypatch, alter)
    r = _run(cell)
    assert not r["correct"] and r["checks"]["score_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", GCUPS_CELLS)
def test_half_of_the_batch_left_out(cell, monkeypatch):
    def alter(out, n):
        for k in ("score", "end_query", "end_ref"):
            out[k][n // 2:] = 0

    _patch_outputs(monkeypatch, alter)
    r = _run(cell)
    assert not r["correct"]


@pytest.mark.parametrize("cell", CIGAR_CELLS)
def test_cigar_altered_where_produced(cell, monkeypatch):
    import parasail_rs_tpu_torch.constants as constants
    from parasail_rs_tpu_torch.engine.result import Alignment

    orig_batch = constants.cigar_strings_batch
    orig_one = Alignment.get_cigar

    def flip(c):
        return c.replace("=", "X", 1) if "=" in c else c + "1I"

    monkeypatch.setattr(constants, "cigar_strings_batch",
                        lambda *a: [flip(c) for c in orig_batch(*a)])
    monkeypatch.setattr(Alignment, "get_cigar",
                        lambda self, q, r: flip(orig_one(self, q, r)))
    r = _run(cell)
    assert not r["correct"] and r["checks"]["cigar_mismatch"]["value"] > 0


def test_a_call_that_raises_is_an_answer_that_never_comes(monkeypatch):
    from parasail_rs_tpu_torch.engine.aligner import Aligner

    calls = {"n": 0}
    orig = Aligner.align_cigars

    def sometimes(self, q, r):
        calls["n"] += 1
        if calls["n"] == 2:          # the first call of the window
            raise RuntimeError("planted failure")
        return orig(self, q, r)

    monkeypatch.setattr(Aligner, "align_cigars", sometimes)
    r = _run("wfa.10k_e5.cigar", log=open("/dev/null", "w"))
    assert r["failed"] > 0 and not r["correct"]
    assert r["checks"]["failed_alignments"]["value"] == r["failed"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_layers(cell):
    r = _run(cell, trace=True)
    assert r["correct"]
    names = {m["name"] for m in harness.metrics_of(
        harness.cell_spec(cell)[0], cell, True)}
    # on the CPU the device's metrics find nothing to read
    assert set(r["metrics"]) <= names
    assert not any(k.startswith(("device.", "kernels")) for k in r["metrics"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_small(cell, cuda_device):
    r = _run(cell, device=cuda_device)
    assert r["correct"], r["checks"]
    t = _run(cell, device=cuda_device, trace=True)
    assert t["correct"] and t["device"]["busy_s"] > 0
    assert "breakdown" in t
    c = _run(cell, device=cuda_device, control=CONTROL[cell])
    assert not c["correct"]


# -- semantics no cell states yet, through the whole run ---------------------


@pytest.mark.parametrize("free", [[], ["db", "de"], ["qb", "qe"]],
                         ids=["sg", "sg_dx", "sg_qx"])
def test_semi_global_runs_through_the_harness(free):
    # a match reward: under WFA's match 0 plain sg's best is an empty
    # alignment, which no gap moves
    over = harness.merged(SMALL["wfa.10k_e5.cigar"], {
        "config": {"scoring": {"mode": "sg", "free": free, "matrix": {
            "alphabet": "ACGT", "match": 2, "mismatch": -4}}}})
    r = harness.run("wfa.10k_e5.cigar", SEED, 0.3, False, device="cpu",
                    overrides=over)
    assert r["correct"], r["checks"]
    assert r["compared"] > 0 and "cigar_mismatch" in r["checks"]
    c = harness.run("wfa.10k_e5.cigar", SEED, 0.3, False, device="cpu",
                    overrides=over, control="gap")
    assert not c["correct"] and c["checks"]["score_mismatch"]["value"] > 0


def _in_band_brute_force(req, bw):
    n = 0
    for q, r in map(req.pair, range(req.n)):
        i, j = np.indices((len(q), len(r)))
        n += int((np.abs(i - j) <= bw).sum())
    return n


@pytest.mark.parametrize("bw", [8, 64])
def test_banded_entry_runs_through_the_harness(bw, monkeypatch):
    seen = []

    class Spy(harness.Reading):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)

    monkeypatch.setattr(harness, "Reading", Spy)
    over = harness.merged(SMALL["wfa.10k_e5.score"], {
        "config": {"scoring": {"bandwidth": bw}},
        "traffic": {"entry": "banded_nw_batch"}})
    r = harness.run("wfa.10k_e5.score", SEED, 0.3, False, device="cpu",
                    overrides=over)
    assert r["correct"], r["checks"]
    (reading,) = seen
    _, _, config, mix = harness.cell_spec("wfa.10k_e5.score")
    config = harness.merged(config, over.get("config"))
    mix = harness.merged(mix, over["traffic"])
    traffic = harness.load_module("traffic", mix["generator"]).make(
        config, mix, SEED)
    reqs = [traffic.request(c) for c in range(reading.calls)]
    assert reading.cells == sum(_in_band_brute_force(q, bw) for q in reqs)
    assert reading.cells < sum(q.cells() for q in reqs)
    assert reading.cells == sum(roofline.cells(q, config["scoring"])
                                for q in reqs)
