"""Batch results as one two-slot ``Alignment`` a pair over a shared
``BatchRecord``, and the cyclic collector paused once a public call.

Every result a batch path builds (``align_many``, ``align_batch`` of each
output class, ``align_cigars``, ``banded_nw_batch``, ``ssw_batch``'s
windows) must show, getter for getter, what the plain per-pair
construction gives: ``dispatch.slice_pair`` of the batch's columns and
the flag dict of the pair's saturation bit.  A batch of n pairs
allocates n tracked objects and a few more; a call of at least
``gcpause.MIN_PAIRS`` pairs runs every bin with the collector paused and
puts it back as it found it; a smaller call never touches it.
"""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parasail_rs_tpu_torch as port  # noqa: E402
from parasail_rs_tpu_torch import errors  # noqa: E402
from parasail_rs_tpu_torch.engine import aligner as aligner_mod  # noqa: E402
from parasail_rs_tpu_torch.engine import dispatch  # noqa: E402
from parasail_rs_tpu_torch.engine.aligner import Aligner  # noqa: E402
from parasail_rs_tpu_torch.engine.result import (  # noqa: E402
    Alignment,
    PairFields,
)
from parasail_rs_tpu_torch.golden.model import walk_trace  # noqa: E402
from parasail_rs_tpu_torch.utils import gcpause, stages  # noqa: E402

from test_torch_engine import PREDICATES, PROTEIN, _seqs  # noqa: E402

BLOSUM62 = port.Matrix.from_name("blosum62")
# 8-bit lanes and a match of 10: a pair of more than 12 equal letters
# saturates, a shorter one does not
SAT_DNA = port.Matrix.create("ACGT", 10, -1)

# predicate -> the flag it reads
FLAG_OF = {p: p[3:] for p in PREDICATES}
FLAG_OF.update(is_global="nw", is_semi_global="sg", is_local="sw")

# getter -> (the field it reads, the flags any one of which allows it,
# the error it raises otherwise); None: no guard
SCALARS = {"get_score": ("score", None, None),
           "get_end_query": ("end_query", None, None),
           "get_end_ref": ("end_ref", None, None),
           "get_matches": ("matches", ("stats",), errors.NoStats),
           "get_similar": ("similar", ("stats",), errors.NoStats),
           "get_length": ("length", ("stats",), errors.NoStats)}
TABLES = {"get_score_table": ("score_table", ("table", "stats_table"),
                              errors.NoTable),
          **{f"get_{k}_table": (f"{k}_table", ("stats_table",),
                                errors.NoStatsTable)
             for k in ("matches", "similar", "length")},
          "get_trace_table": ("trace_table", ("trace",), errors.NoTrace)}
ROWCOLS = {"get_score_row": ("score_row", ("rowcol", "stats_rowcol")),
           "get_score_col": ("score_col", ("rowcol", "stats_rowcol")),
           **{f"get_{k}_{e}": (f"{k}_{e}", ("stats_rowcol",))
              for k in ("matches", "similar", "length")
              for e in ("row", "col")}}


def _capture(monkeypatch):
    """Every ``_alignments`` call's arguments and results, in order."""
    seen = []
    orig = aligner_mod._alignments

    def recording(out, qlens, rlens, flags, matrix, free, mode):
        res = orig(out, qlens, rlens, flags, matrix, free, mode)
        seen.append((out, qlens, rlens, flags, matrix, free, mode, res))
        return res

    monkeypatch.setattr(aligner_mod, "_alignments", recording)
    return seen


def _expect_guarded(a, name, want, allowed, err):
    if allowed is None or any(a.flags[f] for f in allowed):
        got = getattr(a, name)()
        got = got.as_array() if hasattr(got, "as_array") else got
        assert np.array_equal(np.asarray(got), np.asarray(want)), name
        assert np.asarray(got).shape == np.asarray(want).shape, name
    else:
        with pytest.raises(err):
            getattr(a, name)()


def _check_batch(out, qlens, rlens, flags, matrix, free, mode, res,
                 pairs=None):
    """Each result against the plain per-pair construction."""
    assert isinstance(res, list) and len(res) == len(rlens)
    sat = out.get("saturated")
    for b, a in enumerate(res):
        assert type(a) is Alignment
        want = dispatch.slice_pair(out, b, qlens[b], rlens[b])
        saturated = bool(sat is not None and sat[b])
        assert a.flags is flags[saturated]
        assert (a.query_len, a.ref_len) == (qlens[b], rlens[b])
        assert a.matrix is matrix and a.free == free and a.mode == mode
        f = a.fields
        assert isinstance(f, PairFields)
        assert sorted(f.keys()) == sorted(want) == sorted(f)
        for k, v in want.items():
            assert k in f
            for got in (f[k], f.get(k)):
                assert np.asarray(got).shape == np.asarray(v).shape, k
                assert np.array_equal(got, v), k
        assert "absent" not in f and f.get("absent") is None
        assert f.get("absent", 7) == 7
        with pytest.raises(KeyError):
            f["absent"]
        for p, flag in FLAG_OF.items():
            assert getattr(a, p)() is bool(flags[saturated][flag]), p
        assert a.is_saturated() is saturated
        for name, (k, allowed, err) in SCALARS.items():
            _expect_guarded(a, name, want.get(k), allowed, err)
        for name, (k, allowed, err) in TABLES.items():
            _expect_guarded(a, name, want.get(k), allowed, err)
        for name, (k, allowed) in ROWCOLS.items():
            _expect_guarded(a, name, want.get(k), allowed, errors.NoRowCol)
        if a.is_trace() and pairs is not None:
            q, r = pairs[b]
            walk = walk_trace(want["trace_table"], q, r,
                              int(want["end_query"]), int(want["end_ref"]),
                              mode, free)
            assert a.get_cigar(q, r) == walk.cigar_string()
        elif not a.is_trace():
            with pytest.raises(errors.NoTrace):
                a.get_cigar(b"A", b"A")


def _mixed_saturating():
    """Pairs of 4-8 and of 24-40 equal letters: two bins, the first
    never saturated at 8 bits, the second always."""
    rng = np.random.default_rng(5)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    seqs = [alpha[rng.integers(0, 4, int(n))].tobytes()
            for n in [*rng.integers(4, 9, 6), *rng.integers(24, 41, 6)]]
    order = rng.permutation(len(seqs))
    return [seqs[i] for i in order], [seqs[i] for i in order]


def _sw(*setters, matrix=BLOSUM62):
    b = (port.Aligner.new().matrix(matrix).gap_open(11).gap_extend(1)
         .local().device("cpu"))
    for s in setters:
        getattr(b, s)()
    return b.build()


def _protein(n=10):
    return _seqs(31, PROTEIN, n, 1, 40), _seqs(32, PROTEIN, n, 1, 60)


def _align_many_saturating(seen):
    qs, rs = _mixed_saturating()
    al = (port.Aligner.new().matrix(SAT_DNA).gap_open(3).gap_extend(1)
          .local().solution_width(8).device("cpu").build())
    res = al.align_many(qs, rs)
    sats = [a.is_saturated() for a in res]
    assert any(sats) and not all(sats)
    assert len(seen) >= 2        # a bin that saturates and one that does not
    return res, list(zip(qs, rs))


def _align_batch(setters):
    def run(seen):
        qs, rs = _protein()
        return _sw(*setters).align_batch(qs, rs), list(zip(qs, rs))
    return run


def _align_cigars(seen):
    qs, rs = _protein()
    alns, cigars = _sw().align_cigars(qs, rs)
    assert isinstance(alns, list) and isinstance(cigars, list)
    traced = _sw("use_trace").align_batch(qs, rs)
    assert cigars == [t.get_cigar(q, r) for t, q, r in zip(traced, qs, rs)]
    return alns, list(zip(qs, rs))


def _banded(seen):
    qs, rs = _seqs(33, b"ACGT", 8, 10, 30), _seqs(34, b"ACGT", 8, 10, 30)
    al = (port.Aligner.new().matrix(port.Matrix.create("ACGT", 2, -3))
          .gap_open(5).gap_extend(2).bandwidth(6).device("cpu").build())
    res = al.banded_nw_batch(qs, rs)
    assert all(a.is_banded() and a.is_global() for a in res)
    return res, list(zip(qs, rs))


def _ssw_window(seen):
    qs, rs = _protein(8)
    al = _sw()
    windowed = al.ssw_batch(qs, rs, windowed=True)
    one_pass = al.ssw_batch(qs, rs, windowed=False)
    assert [(w.score(), w.ref_end(), w.query_end()) for w in windowed] == \
        [(o.score(), o.ref_end(), o.query_end()) for o in one_pass]
    # the window pass's first align_many: its results carry ``promoted``
    assert "promoted" in seen[0][-1][0].fields
    return seen[0][-1], list(zip(qs, rs))


CASES = {"align_many_saturating": _align_many_saturating,
         **{f"align_batch_{c}": _align_batch(s) for c, s in (
             ("score", ()), ("table", ("use_table",)),
             ("rowcol", ("use_last_rowcol",)), ("trace", ("use_trace",)),
             ("stats_table", ("use_stats", "use_table")),
             ("stats_rowcol", ("use_stats", "use_last_rowcol")))},
         "align_cigars": _align_cigars,
         "banded_nw_batch": _banded,
         "ssw_batch_window": _ssw_window}


@pytest.mark.parametrize("case", sorted(CASES))
def test_results_equal_the_plain_construction(case, monkeypatch):
    seen = _capture(monkeypatch)
    res, pairs = CASES[case](seen)
    assert seen
    by_id = {}
    for *args, built in seen:
        _check_batch(*args, built)
        by_id.update((id(a), a) for a in built)
    # what the call returned is what the batches built, and a pair's
    # trace walks as golden walks the plain plane
    assert all(by_id.get(id(a)) is a for a in res)
    if case == "align_batch_trace":
        (args,) = [s[:7] for s in seen]
        _check_batch(*args, res, pairs=pairs)


def test_repr_names_every_field():
    a = _sw().align(b"ACDEF", b"ACDF")
    text = repr(a)
    for name in ("fields=PairFields(", "flags=", "query_len=5",
                 "ref_len=4", "matrix=", "free=", "mode='sw'"):
        assert name in text


def _batch_out(n, seed=0):
    rng = np.random.default_rng(seed)
    out = {"score": rng.integers(0, 99, n).astype(np.int32),
           "end_query": rng.integers(0, 9, n).astype(np.int32),
           "end_ref": rng.integers(0, 9, n).astype(np.int32),
           "saturated": rng.random(n) < 0.5,
           "promoted": rng.random(n) < 0.5}
    return out, [10] * n, [12] * n, ({"saturated": False},
                                     {"saturated": True})


@pytest.mark.parametrize("n", [1, 300, 5000])
def test_a_batch_allocates_one_tracked_object_a_pair(n):
    out, qlens, rlens, flags = _batch_out(n)
    was = gc.isenabled()
    gc.disable()
    try:
        c0 = gc.get_count()[0]
        res = aligner_mod._alignments(out, qlens, rlens, flags, None,
                                      (False,) * 4, "sw")
        grew = gc.get_count()[0] - c0
    finally:
        if was:
            gc.enable()
    assert len(res) == n
    assert grew <= n + 16, grew
    assert [a.get_score() for a in res] == out["score"].tolist()
    assert [a.is_saturated() for a in res] == out["saturated"].tolist()


# -- the collector's pause ------------------------------------------------


@pytest.fixture
def small_pause(monkeypatch):
    """A pause for calls of 8 pairs or more."""
    monkeypatch.setattr(gcpause, "MIN_PAIRS", 8)


@pytest.fixture
def spans():
    stages.enable(True)
    stages.reset()
    yield stages
    stages.enable(False)
    stages.reset()


# pairs a call, and a gen-0 threshold above what a call allocates before
# its first bin (about a hundred tracked objects with spans on) and well
# below what its results hold
N_PAIRS, THRESHOLD = 800, 200


def _calls():
    qs = _seqs(41, PROTEIN, N_PAIRS, 1, 50)
    rs = _seqs(42, PROTEIN, N_PAIRS, 1, 90)
    al = _sw()
    return {"align_many": lambda: al.align_many(qs, rs),
            "align_cigars": lambda: al.align_cigars(qs, rs)}


@pytest.fixture
def starts_inside(monkeypatch):
    """Each collection that starts while a public method's own body runs
    (``gc.callbacks``), and whether the collector was on as it started;
    the threshold is put back after the test."""
    inside, starts = [], []

    def cb(phase, info):
        if phase == "start" and inside:
            starts.append(gc.isenabled())

    for name in ("align_many", "align_cigars"):
        raw = getattr(Aligner, name).__wrapped__

        def body(*args, _raw=raw, **kwargs):
            inside.append(1)
            try:
                return _raw(*args, **kwargs)
            finally:
                inside.pop()

        body.__name__ = name
        monkeypatch.setattr(Aligner, name, aligner_mod._call_region(body))
    old = gc.get_threshold()
    gc.callbacks.append(cb)
    try:
        yield starts
    finally:
        gc.set_threshold(*old)
        gc.callbacks.remove(cb)


def _run_counted(run, starts):
    """``run()`` once warm, then once from an empty generation 0 under
    THRESHOLD; the spans' snapshot of the second."""
    run()
    stages.reset()
    gc.collect()
    starts.clear()
    gc.set_threshold(THRESHOLD, 10, 10)
    run()
    return stages.snapshot()


@pytest.mark.parametrize("call", ["align_many", "align_cigars"])
def test_no_collection_starts_while_a_call_is_paused(call, small_pause,
                                                     starts_inside, spans):
    # the pause spans every bin; the collection it deferred may start as
    # it ends, the call's only one
    assert gc.isenabled()
    snap = _run_counted(_calls()[call], starts_inside)
    assert snap["count.bins"]["n"] >= 2
    assert all(starts_inside) and len(starts_inside) <= 1
    assert snap["count.gc_collections"]["n"] == len(starts_inside)
    assert gc.isenabled()


@pytest.mark.parametrize("call", ["align_many", "align_cigars"])
def test_the_same_call_collects_with_the_collector_on(call, starts_inside,
                                                      spans):
    # N_PAIRS < MIN_PAIRS: nothing pauses, and the counter holds what
    # started inside the call
    snap = _run_counted(_calls()[call], starts_inside)
    assert len(starts_inside) >= 3
    assert snap["count.gc_collections"]["n"] == len(starts_inside)


def test_a_nested_public_call_counts_once(spans, monkeypatch):
    orig = Aligner._submit

    def collecting(self, batch, walk=False):
        gc.collect(0)
        return orig(self, batch, walk)

    monkeypatch.setattr(Aligner, "_submit", collecting)
    _sw().align(b"HEAGAWGHEE", b"PAWHEAE")      # align -> align_batch
    assert stages.snapshot()["count.gc_collections"] == {"n": 1}


def test_spans_off_count_nothing(monkeypatch):
    stages.enable(False)
    stages.reset()
    monkeypatch.setattr(aligner_mod, "_collections", lambda: 1 / 0)
    _sw().align_many(*_many_bins(), max_cells=1 << 14)
    assert stages.snapshot() == {}


def _many_bins():
    """Mixed lengths that ``max_cells`` splits into several bins."""
    return _seqs(43, PROTEIN, 24, 1, 70), _seqs(44, PROTEIN, 24, 1, 120)


def test_collector_restored_after_an_error_in_a_bin(small_pause,
                                                    monkeypatch):
    qs, rs = _many_bins()
    orig = Aligner._submit
    calls, enabled = [], []

    def failing(self, batch, walk=False):
        calls.append(1)
        enabled.append(gc.isenabled())
        if len(calls) == 2:
            raise RuntimeError("launch failed")
        return orig(self, batch, walk)

    monkeypatch.setattr(Aligner, "_submit", failing)
    assert gc.isenabled()
    with pytest.raises(RuntimeError, match="launch failed"):
        _sw().align_many(qs, rs, max_cells=1 << 14)
    assert enabled == [False, False]          # both bins inside the pause
    assert gc.isenabled()


def test_collector_left_off_where_it_was_off(small_pause, monkeypatch):
    qs, rs = _many_bins()
    gc.disable()
    try:
        _sw().align_many(qs, rs, max_cells=1 << 14)
        assert not gc.isenabled()
        monkeypatch.setattr(Aligner, "_submit", lambda *a, **k: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            _sw().align_many(qs, rs, max_cells=1 << 14)
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_small_calls_never_touch_the_collector(monkeypatch):
    def refused():
        raise AssertionError("gc.disable() on a small call")

    monkeypatch.setattr(gc, "disable", refused)
    al = _sw("use_trace")
    q, r = b"HEAGAWGHEE", b"PAWHEAE"
    assert al.align(q, r).get_cigar(q, r)
    qs, rs = _protein(64)
    assert len(_sw().align_many(qs, rs)) == 64
    assert len(_sw().align_cigars(qs, rs)[1]) == 64


def test_collections_per_call_reader():
    from benchmark import harness

    reader = harness.load_module("metrics", "host.gc_collections_per_call")
    snap = {"count.gc_collections": {"n": 30}, "count.bins": {"n": 4}}
    assert reader.read(harness.Reading(stages=snap, calls=10)) == 3.0
    # the parent's program has no such counter: nothing to read
    assert reader.read(harness.Reading(stages={"count.bins": {"n": 4}},
                                       calls=10)) is None
    assert reader.read(harness.Reading(stages=None, calls=10)) is None
    assert reader.read(harness.Reading(stages=snap, calls=0)) is None
