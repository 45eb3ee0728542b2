"""The metrics that read the program's own spans and counters, and the
score-only cell ``wfa.10k_e5.score``: its check on the CPU's plain
versions, and on the card the launch counter against the kernels a
capture of the same call holds."""

from __future__ import annotations

import os
import re

import numpy as np
import pytest

from benchmark import harness, tracing

from .conftest import BENCH, SMALL

SEED = 2**31 + 11
CELL = "wfa.10k_e5.score"
# the score cell on the card at 1,100 bp, so that its bins take the
# segment route as at 10 kbp
CARD_SCORE = {"traffic": {"length": 1100, "pool": 8, "per_call": 4,
                          "sample": {"size": 4}}}
METRICS = {m["name"]: m for m in BENCH["end_to_end"] + BENCH["per_layer"]}
# the batch cells are those that report ``gcups``, the single-pair ones
# those that report ``p95_ms``
BATCH_CELLS = METRICS["gcups"]["workloads"]
SINGLE_CELLS = METRICS["p95_ms"]["workloads"]
PROGRAM_METRICS = ["host.bins_us_per_pair", "bins.real_cell_share",
                   "dispatch.launches_per_call", "host.fetch_us_per_pair"]
# the cells each list held when this was written: a cell may join a
# list, none may drop out of it unnoticed
_BATCHES = ["swissprot.search", "wfa.10k_e5.cigar", "swissprot.hits.cigar",
            CELL, "wfa.100_e5.cigar", "swissprot.search.short"]
LISTED = {"gcups": _BATCHES, "kernels_roofline": _BATCHES,
          "device.idle_share": _BATCHES,
          **{name: _BATCHES for name in PROGRAM_METRICS},
          "host.walk_ms.single": ["wfa.1k_e5.single"]}


def _reader(name):
    return harness.load_module("metrics", name)


def _run(cell, device="cpu", trace=False, overrides=None, **kw):
    return harness.run(cell, SEED, 0.3, trace, device=device,
                       overrides=overrides or SMALL[cell], **kw)


# -- the readers -----------------------------------------------------------

SNAP = {"bins": {"ms": 20.0, "calls": 9}, "pack": {"ms": 30.0, "calls": 4},
        "fetch.start": {"ms": 4.0, "calls": 4},
        "fetch.wait": {"ms": 900.0, "calls": 4},
        "fetch.copy": {"ms": 6.0, "calls": 4},
        "walk.host": {"ms": 50.0, "calls": 10},
        "count.bins": {"n": 4}, "count.launches": {"n": 12},
        "count.cells_real": {"n": 300}, "count.cells_padded": {"n": 400}}

# metric: (its value on SNAP over 1,000 alignments in 10 calls, the keys
# whose absence leaves it nothing to read)
READS = {"host.bins_us_per_pair": (20.0, ["bins"]),
         "bins.real_cell_share": (75.0, ["count.cells_real",
                                         "count.cells_padded"]),
         "dispatch.launches_per_call": (1.2, ["count.launches"]),
         "host.fetch_us_per_pair": (10.0, ["fetch.start", "fetch.copy"]),
         "host.walk_ms.single": (5.0, ["walk.host"])}


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_on_a_snapshot(name):
    want, _ = READS[name]
    r = harness.Reading(stages=dict(SNAP), alignments=1000, calls=10)
    assert _reader(name).read(r) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_finds_nothing_without_its_keys(name):
    _, keys = READS[name]
    st = {k: v for k, v in SNAP.items() if k not in keys}
    assert _reader(name).read(harness.Reading(
        stages=st, alignments=1000, calls=10)) is None
    assert _reader(name).read(harness.Reading(
        stages=None, alignments=1000, calls=10)) is None
    # the parent's stages: one ``fetch`` mixing the wait with the copy
    assert _reader(name).read(harness.Reading(
        stages={"fetch": {"ms": 9.0, "calls": 3},
                "pack": {"ms": 1.0, "calls": 3}},
        alignments=1000, calls=10)) is None


def test_fetch_reader_leaves_the_wait_out():
    st = {"fetch.copy": {"ms": 6.0, "calls": 4},
          "fetch.wait": {"ms": 900.0, "calls": 4}}
    r = harness.Reading(stages=st, alignments=1000)
    assert _reader("host.fetch_us_per_pair").read(r) == pytest.approx(6.0)


def test_new_metrics_are_listed_where_their_stages_open():
    for name in ("kernels_roofline", "device.idle_share"):
        assert sorted(METRICS[name]["workloads"]) == sorted(BATCH_CELLS)
    for name in PROGRAM_METRICS:
        assert set(METRICS[name]["workloads"]) <= set(BATCH_CELLS), name
    assert set(METRICS["host.walk_ms.single"]["workloads"]) <= set(
        SINGLE_CELLS)
    for name, cells in LISTED.items():
        assert set(cells) <= set(METRICS[name]["workloads"]), name


# -- the score-only cell on the CPU ------------------------------------------


def _segments(monkeypatch):
    """The segment route at the CPU's small sizes, two segments a pair."""
    from parasail_rs_tpu_torch.engine import dispatch

    monkeypatch.setattr(dispatch, "SEGMENT_MIN_CELLS", 1 << 12)
    monkeypatch.setitem(dispatch.SEGMENT_COLS, "score", 512)


@pytest.mark.parametrize("route", ["one_shot", "segments"])
def test_score_cell_sound_run_is_correct(route, monkeypatch):
    if route == "segments":
        _segments(monkeypatch)
    r = _run(CELL)
    assert r["correct"], r["checks"]
    assert r["compared"] > 0 and r["failed"] == 0
    assert "cigar_mismatch" not in r["checks"]
    assert set(r["metrics"]) == {"gcups", "setup_s"}


def test_score_cell_control_is_not_correct():
    r = _run(CELL, control=True)
    assert not r["correct"]
    assert r["checks"]["score_mismatch"]["value"] > 0


@pytest.mark.parametrize("fault", ["score", "half"])
def test_score_cell_catches_a_fault_where_produced(fault, monkeypatch):
    from parasail_rs_tpu_torch.engine.aligner import Aligner

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
    assert not _run(CELL)["correct"]


# -- the traced runs read the program's spans and counters ------------------


@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_traced_batch_cell_reads_the_program(cell):
    r = _run(cell, trace=True)
    assert r["correct"]
    got = r["metrics"]
    # each metric in the cells of its own list; no CUDA kernel runs on
    # the CPU, so the launch counter stays empty
    for name in ("host.bins_us_per_pair", "bins.real_cell_share",
                 "host.fetch_us_per_pair"):
        if cell in METRICS[name]["workloads"]:
            assert got[name]["value"] > 0, name
    if cell in METRICS["bins.real_cell_share"]["workloads"]:
        assert 0 < got["bins.real_cell_share"]["value"] <= 100
    assert "dispatch.launches_per_call" not in got


def test_traced_single_cell_reads_the_host_walk():
    for cell in METRICS["host.walk_ms.single"]["workloads"]:
        r = _run(cell, trace=True)
        assert r["correct"]
        assert r["metrics"]["host.walk_ms.single"]["value"] > 0


def test_traced_segment_route_counts_its_cells(monkeypatch):
    _segments(monkeypatch)
    r = _run(CELL, trace=True)
    assert r["correct"]
    assert 0 < r["metrics"]["bins.real_cell_share"]["value"] < 100


# -- on the card -----------------------------------------------------------

CSRC = os.path.join(harness.ROOT, "parasail_rs_tpu_torch", "csrc")


def kernel_names() -> set[str]:
    """The port's own kernels: every ``__global__`` function in csrc."""
    names = set()
    for f in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, f)) as fh:
            src = fh.read()
        for m in re.finditer(r"__global__", src):
            calls = re.findall(r"(\w+)\s*\(", src[m.end():m.end() + 200])
            names.add(next(c for c in calls if c != "__launch_bounds__"))
    return names


def test_kernel_names_are_the_csrc_kernels():
    assert kernel_names() == {"short_kernel", "short_kernel_one",
                              "segment_kernel", "band_kernel",
                              "trace_walk_kernel"}


def _mixed_pairs(n, seed):
    """DNA pairs of 60-1,200 bp: the short form, the block kernel and,
    past 1,024 bp, the segment route."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    lens = rng.choice([60, 200, 400, 1200], n)
    qs = [alpha[rng.integers(0, 4, int(k))].tobytes() for k in lens]
    rs = [q[:len(q) // 2] + alpha[rng.integers(0, 4, 7)].tobytes()
          + q[len(q) // 2:] for q in qs]
    return qs, rs


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["align_many", "align_cigars"])
def test_launch_counter_equals_the_ports_kernels(call, cuda_device):
    import torch

    from benchmark.entries.system import builder, matrix
    from parasail_rs_tpu_torch.utils import stages

    scoring = harness.load_json(harness.HERE, "configs",
                                "wfa_nw_x4_o6_e2.json")["scoring"]
    al = builder(scoring, cuda_device).matrix(
        matrix(scoring["matrix"])).build()
    qs, rs = _mixed_pairs(40, 3)
    fn = getattr(al, call)
    fn(qs, rs)                                   # builds and warms
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with stages.measuring(), torch.profiler.profile(activities=acts) as prof:
        fn(qs, rs)
        torch.cuda.synchronize()
    launches = stages.snapshot()["count.launches"]["n"]
    names = kernel_names()
    pattern = re.compile(r"(?<!\w)(%s)[<(]" % "|".join(sorted(names)))
    ours = [e.name for e in tracing.events_of(prof)
            if e.kind == "kernel" and pattern.search(e.name)]
    assert ours and launches == len(ours), (launches, ours)
    stages.reset()


@pytest.mark.cuda
def test_score_cell_on_the_card_small(cuda_device):
    r = _run(CELL, device=cuda_device, overrides=CARD_SCORE)
    assert r["correct"], r["checks"]
    t = _run(CELL, device=cuda_device, trace=True, overrides=CARD_SCORE)
    assert t["correct"] and t["device"]["busy_s"] > 0
    for name in PROGRAM_METRICS + ["kernels_roofline", "device.idle_share"]:
        assert name in t["metrics"], name
    c = _run(CELL, device=cuda_device, control=True, overrides=CARD_SCORE)
    assert not c["correct"]
