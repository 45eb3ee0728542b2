"""The port's host spans and counters (``utils.stages``).

Off, a stage and a counter record nothing and open no region; on, each
stage is timed and opened as ``stage.<name>`` on torch's profiler (and
as an NVTX range where CUDA is available), no stage opens inside another
on any public path, and the counters hold each batch's bins and cells.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import parasail_rs_tpu_torch as port  # noqa: E402
from parasail_rs_tpu_torch.engine import dispatch  # noqa: E402
from parasail_rs_tpu_torch.engine.binning import _shape_bins  # noqa: E402
from parasail_rs_tpu_torch.utils import profiling, stages  # noqa: E402

BLOSUM62 = port.Matrix.from_name("blosum62")


@pytest.fixture
def spans():
    """Spans on and cleared for the test, off and cleared after it."""
    stages.enable(True)
    stages.reset()
    yield stages
    stages.enable(False)
    stages.reset()


@pytest.fixture
def spans_off():
    stages.enable(False)
    stages.reset()
    yield stages
    stages.reset()


def _nvtx_calls(monkeypatch, available: bool):
    """NVTX calls recorded instead of made, CUDA's availability as given."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(profiling, "_NVTX", None)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", calls.append)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append("pop"))
    return calls


def _mixed(n, seed):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)

    def seq(k):
        return alpha[rng.integers(0, 20, k)].tobytes()

    lens = rng.choice([7, 20, 45, 90, 150], n)
    return ([seq(int(k)) for k in lens],
            [seq(int(k) + int(rng.integers(-5, 30))) for k in lens])


def _sw(**kw):
    b = (port.Aligner.new().matrix(BLOSUM62).gap_open(11).gap_extend(1)
         .local().device("cpu"))
    return b.use_trace().build() if kw.get("trace") else b.build()


def _nw_dna(trace=False):
    b = (port.Aligner.new().matrix(port.Matrix.create("ACGT", 2, -3))
         .gap_open(5).gap_extend(2).global_().device("cpu"))
    return b.use_trace().build() if trace else b.build()


def _dna(n, length, seed):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    qs = [alpha[rng.integers(0, 4, length)].tobytes() for _ in range(n)]
    rs = [q[:length // 2] + alpha[rng.integers(0, 4, 5)].tobytes()
          + q[length // 2:] for q in qs]
    return qs, rs


# -- the facility ----------------------------------------------------------


def test_spans_off_record_nothing_and_open_no_region(spans_off,
                                                     monkeypatch):
    calls = _nvtx_calls(monkeypatch, True)
    with stages.stage("pack"):
        stages.count("bins", 3)
    assert calls == [] and stages.snapshot() == {}
    assert stages.stage("pack") is stages.stage("build")   # one shared no-op
    # a whole pipeline under torch's profiler opens no stage region
    qs, rs = _mixed(12, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(profiling, "_NVTX", None)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _sw().align_many(qs, rs, max_cells=1 << 14)
        _sw(trace=True).align(qs[0], rs[0]).get_cigar(qs[0], rs[0])
    names = {e.key for e in prof.key_averages()}
    assert not any(n.startswith("stage.") for n in names)
    assert "pt.call.align_many" in names and "pt.call.align" in names
    assert stages.snapshot() == {}


def test_spans_off_never_call_record_function(spans_off, monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    with stages.stage("dispatch"):
        pass
    _sw().align_many(*_mixed(6, 2))
    assert stages.snapshot() == {}


def test_spans_on_time_each_stage_and_name_it(spans, monkeypatch):
    calls = _nvtx_calls(monkeypatch, False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with stages.stage("pack"):
            torch.ones(8).sum()
        with stages.stage("pack"):
            pass
        with stages.stage("build"):
            pass
    snap = stages.snapshot()
    assert snap["pack"]["calls"] == 2 and snap["build"]["calls"] == 1
    assert snap["pack"]["ms"] >= 0
    names = {e.key for e in prof.key_averages()}
    assert {"stage.pack", "stage.build"} <= names
    assert calls == []


def test_spans_on_push_nvtx_where_cuda_is(spans, monkeypatch):
    calls = _nvtx_calls(monkeypatch, True)
    with stages.stage("fetch.wait"):
        assert calls == ["stage.fetch.wait"]
    assert calls == ["stage.fetch.wait", "pop"]
    with pytest.raises(ValueError):
        with stages.stage("fetch.copy"):
            raise ValueError
    assert calls[2:] == ["stage.fetch.copy", "pop"]
    assert stages.snapshot()["fetch.copy"]["calls"] == 1


def test_cuda_availability_is_read_once(monkeypatch):
    asked = []
    monkeypatch.setattr(profiling, "_NVTX", None)
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: asked.append(1) or False)
    for _ in range(5):
        with profiling.trace_region("pt.test.region"):
            pass
    assert asked == [1]


def test_counters_snapshot_and_reset(spans):
    stages.count("launches")
    stages.count("launches", 2)
    stages.count("cells_real", 10)
    with stages.stage("bins"):
        pass
    snap = stages.snapshot()
    assert snap["count.launches"] == {"n": 3}
    assert snap["count.cells_real"] == {"n": 10}
    assert set(snap["bins"]) == {"ms", "calls"}
    stages.reset()
    assert stages.snapshot() == {}


def test_measuring_restores_the_previous_state(spans_off):
    with stages.measuring():
        assert stages.enabled
        stages.count("bins")
    assert not stages.enabled
    assert stages.snapshot() == {"count.bins": {"n": 1}}


# -- stages are disjoint on every public path ------------------------------


def _stage_events(prof):
    """(name, start, end, thread) of every ``stage.*`` region."""
    return [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events() if e.name.startswith("stage.")]


def _nested(events):
    """Pairs of stage regions of one thread where one holds the other."""
    out = []
    for i, (na, a0, a1, ta) in enumerate(events):
        for nb, b0, b1, tb in events[i + 1:]:
            if ta == tb and ((a0 <= b0 and b1 <= a1) or
                             (b0 <= a0 and a1 <= b1)):
                out.append((na, nb))
    return out


def _align_many(monkeypatch):
    qs, rs = _mixed(24, 3)
    return lambda: _sw().align_many(qs, rs, max_cells=1 << 14)


def _align_cigars(monkeypatch):
    qs, rs = _mixed(24, 4)
    return lambda: _sw().align_cigars(qs, rs)


def _align_get_cigar(monkeypatch):
    qs, rs = _mixed(2, 5)

    def run():
        a = _sw(trace=True).align(qs[0], rs[0])
        a.get_cigar(qs[0], rs[0])
        a.get_traceback_strings(qs[0], rs[0])

    return run


def _segments_score(monkeypatch):
    monkeypatch.setattr(dispatch, "SEGMENT_MIN_CELLS", 16 * 16)
    monkeypatch.setitem(dispatch.SEGMENT_COLS, "score", 32)
    qs, rs = _dna(6, 80, 6)
    return lambda: _nw_dna().align_many(qs, rs)


def _segments_trace(monkeypatch):
    monkeypatch.setattr(dispatch, "TRACE_ONE_SHOT_BYTES", 1)
    monkeypatch.setitem(dispatch.SEGMENT_COLS, "trace", 32)
    qs, rs = _dna(3, 70, 7)

    def run():
        al = _nw_dna(trace=True)
        al.cigars(al.align_batch(qs, rs), qs, rs)

    return run


PATHS = {"align_many": (_align_many, {"bins", "pack", "dispatch",
                                      "fetch.start", "fetch.copy", "build"}),
         "align_cigars": (_align_cigars, {"bins", "pack", "dispatch", "walk",
                                          "fetch.start", "fetch.copy",
                                          "build", "encode"}),
         "align_get_cigar": (_align_get_cigar, {"pack", "dispatch",
                                                "fetch.start", "fetch.copy",
                                                "build", "walk.host"}),
         "segments_score": (_segments_score, {"bins", "pack", "dispatch",
                                              "fetch.start", "fetch.copy",
                                              "build"}),
         "segments_trace": (_segments_trace, {"pack", "dispatch",
                                              "fetch.start", "fetch.copy",
                                              "build", "walk.host"})}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_stage_opens_inside_another(path, spans, monkeypatch):
    make, want = PATHS[path]
    run = make(monkeypatch)
    _nvtx_calls(monkeypatch, False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    events = _stage_events(prof)
    assert {n[len("stage."):] for n, *_ in events} == want
    assert _nested(events) == []
    snap = stages.snapshot()
    assert want <= set(snap)
    # every region is a stage the clock timed, once each
    for name in want:
        assert snap[name]["calls"] == sum(
            n == "stage." + name for n, *_ in events)


def test_nested_regions_are_found():
    assert _nested([("stage.a", 0, 10, 1), ("stage.b", 2, 3, 1)])
    assert not _nested([("stage.a", 0, 10, 1), ("stage.b", 2, 3, 2)])
    assert not _nested([("stage.a", 0, 2, 1), ("stage.b", 1, 3, 1)])


# -- the counters ------------------------------------------------------------


def _expected(qs, rs, bins, profile_len=None):
    qlens = ([profile_len] * len(rs) if profile_len is not None
             else [len(q) for q in qs])
    real = sum(q * len(r) for q, r in zip(qlens, rs))
    padded = sum(len(b.indices) * b.qp * b.rp for b in bins)
    return real, padded, len(bins)


CASES = {
    "align_many": lambda qs, rs: (
        lambda: _sw().align_many(qs, rs, max_cells=1 << 14),
        _shape_bins([len(q) for q in qs], [len(r) for r in rs], False,
                    1 << 14), None),
    "align_cigars": lambda qs, rs: (
        lambda: _sw().align_cigars(qs, rs),
        _shape_bins([len(q) for q in qs], [len(r) for r in rs], True),
        None),
    "profile_align_many": lambda qs, rs: (
        lambda: (port.Aligner.new().profile(
            port.Profile.new(qs[0], False, BLOSUM62)).gap_open(11)
            .gap_extend(1).local().device("cpu").build()
            .align_many(None, rs, max_cells=1 << 14)),
        _shape_bins([len(qs[0])] * len(rs), [len(r) for r in rs], False,
                    1 << 14), len(qs[0])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_counters_hold_the_bins_and_their_cells(case, spans):
    qs, rs = _mixed(30, 8)
    run, bins, plen = CASES[case](qs, rs)
    assert len(bins) > 1
    run()
    snap = stages.snapshot()
    real, padded, nbins = _expected(qs, rs, bins, plen)
    assert snap["count.cells_real"]["n"] == real
    assert snap["count.cells_padded"]["n"] == padded
    assert snap["count.bins"]["n"] == nbins
    assert 0 < real < padded
    # no CUDA kernel ran on the CPU
    assert "count.launches" not in snap


def test_counters_stay_empty_with_spans_off(spans_off):
    qs, rs = _mixed(30, 9)
    _sw().align_many(qs, rs, max_cells=1 << 14)
    _sw().align_cigars(qs, rs)
    assert stages.snapshot() == {}


def test_segment_route_counts_one_bin(spans, monkeypatch):
    monkeypatch.setattr(dispatch, "SEGMENT_MIN_CELLS", 16 * 16)
    monkeypatch.setitem(dispatch.SEGMENT_COLS, "score", 32)
    qs, rs = _dna(5, 80, 10)
    al = _nw_dna()
    al.align_batch(qs, rs)
    assert al.route_counter == {("torch_segments", "long pairs"): 1}
    snap = stages.snapshot()
    assert snap["count.bins"] == {"n": 1}
    batch = dispatch.pack_pairs(al.matrix, qs, rs, device="cpu")[0]
    assert snap["count.cells_padded"]["n"] == 5 * batch.qp * batch.rp
