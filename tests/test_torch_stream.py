"""The port's ``StreamingAligner`` on the CPU against the reference's.

The reference's stream tests (``test_streaming_aligner``,
``test_streaming_submit_many``, ``test_streaming_per_bucket_resolution``
in tests/test_engine.py, ``test_streaming_interleaved_lifecycle`` in
tests/test_scheduler.py) run here on the port, and each holds the port's
handles to the reference's ``StreamingAligner`` on the same seeded pairs
and to the port's own ``align_batch``.  Then the cases the port adds: a
trace bucket (CIGARs), a table bucket, a long bucket on the segment
route, an error in one bucket's build, a failed launch, and the threads
that launch.

The pairs' lengths keep to two padded shapes (24 and 32) so that the
reference compiles few kernels on the CPU; everything compared is an
integer or a string, so every comparison is exact.  The ``cuda`` test
runs a stream on the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_stream.py``.
"""

import threading
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parasail_rs_tpu as ref  # noqa: E402

import parasail_rs_tpu_torch as port  # noqa: E402
from parasail_rs_tpu_torch.engine import StreamingAligner  # noqa: E402
from parasail_rs_tpu_torch.engine import dispatch  # noqa: E402
from parasail_rs_tpu_torch.utils.shapes import length_bucket  # noqa: E402

from test_torch_engine import PROTEIN, _summary, port_matrix  # noqa: E402
from test_torch_engine_stats import _views  # noqa: E402

DNA = ref.Matrix.create(b"ACGT", 2, -3)
BLOSUM62 = ref.Matrix.from_name("blosum62")
CPU_ROUTE = ("torch_plain", "batch on the cpu")
FETCH_THREAD = "parasail-stream-fetch"


def _pairs(seed, n, lo=17, hi=32, alphabet=b"ACGT"):
    """n seeded pairs whose sides pad to 24 or 32."""
    rng = np.random.default_rng(seed)
    alpha = list(alphabet)

    def one():
        return rng.choice(alpha, size=rng.integers(lo, hi + 1)) \
            .astype("uint8").tobytes()
    return [(one(), one()) for _ in range(n)]


def _both(setters, matrix=DNA, open_=4, ext=1, mode="local", profile=None):
    """The same aligner in the reference and in the port (on the CPU)."""
    r = getattr(ref.Aligner.new().matrix(matrix).gap_open(open_)
                .gap_extend(ext), mode)()
    p = getattr(port.Aligner.new().matrix(port_matrix(matrix))
                .gap_open(open_).gap_extend(ext), mode)()
    if profile is not None:
        r = r.profile(ref.Profile.new(profile, False, matrix))
        p = p.profile(port.Profile.new(profile, False, port_matrix(matrix)))
    for s in setters:
        r, p = getattr(r, s)(), getattr(p, s)()
    return r.build(), p.device("cpu").build()


def _reference_stream(aligner, qs, rs, flush_size):
    from parasail_rs_tpu.engine.stream import StreamingAligner as RefStream

    with RefStream(aligner, flush_size=flush_size) as st:
        hs = st.submit_many(qs, rs)
        st.flush()
        return [h.result(timeout=120) for h in hs]


def _results(handles):
    return [h.result(timeout=60) for h in handles]


# -- the reference's stream tests, on the port --------------------------------


def test_streaming_aligner():
    pairs = _pairs(41, 57)
    qs, rs = [q for q, _ in pairs], [r for _, r in pairs]
    r, p = _both(["use_stats"])
    stream = StreamingAligner(p, flush_size=16)
    handles = [stream.submit(q, s) for q, s in pairs]
    stream.flush()
    assert all(h.done() for h in handles)
    got = _views(_results(handles))
    assert got == _views(p.align_batch(qs, rs))
    assert got == _views(_reference_stream(r, qs, rs, 16))
    assert set(p.route_counter) == {CPU_ROUTE}

    # result() on a pending handle launches its bucket
    stream2 = StreamingAligner(p, flush_size=1000)
    h = stream2.submit(b"ACGT", b"ACGT")
    assert not h.done()
    assert h.result().get_score() == p.align(b"ACGT", b"ACGT").get_score()
    stream.close()
    stream2.close()


def test_streaming_submit_many():
    """Bulk submit matches the per-pair loop: same results, input order,
    flush thresholds respected (a group larger than flush_size splits
    into several launches)."""
    pairs = _pairs(43, 73)
    qs, rs = [q for q, _ in pairs], [r for _, r in pairs]
    r, p = _both(["use_stats"])
    expected = _views(p.align_batch(qs, rs))
    assert expected == _views(r.align_batch(qs, rs))
    launches = []
    real = dispatch.submit

    def counted(batch, **kw):
        launches.append(batch.size)
        return real(batch, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dispatch, "submit", counted)
        with StreamingAligner(p, flush_size=16) as stream:
            handles = stream.submit_many(qs, rs)
            stream.flush()
            assert len(handles) == len(pairs)
            assert _views(_results(handles)) == expected
    sizes = Counter((length_bucket(len(q)), length_bucket(len(s)))
                    for q, s in pairs)
    assert sorted(launches) == sorted(
        b for n in sizes.values() for b in [16] * (n // 16) + [n % 16]
        if b)
    assert max(sizes.values()) > 16

    # mixing bulk and per-pair submission into the same buckets
    with StreamingAligner(p, flush_size=16) as stream:
        h1 = stream.submit(qs[0], rs[0])
        hs = stream.submit_many(qs[1:5], rs[1:5])
        stream.flush()
        assert _views(_results([h1, *hs])) == expected[:5]

    # profile-held queries: the queries argument is ignored / may be None
    rp, pp = _both([], profile=qs[0])
    with StreamingAligner(pp, flush_size=8) as stream:
        hs = stream.submit_many(None, rs[:6])
        stream.flush()
        got = _summary(_results(hs))
    assert got == _summary(pp.align_batch(None, rs[:6]))
    assert got == _summary(_reference_stream(rp, None, rs[:6], 8))
    with StreamingAligner(pp, flush_size=8) as stream:
        assert _summary(_results(stream.submit_many(qs[:6], rs[:6]))) == got


def test_streaming_per_bucket_resolution():
    """result() resolves only its own bucket (other buckets keep
    accumulating), and a full bucket resolves on the fetch thread with no
    flush() call."""
    r, p = _both([])
    launched = []
    real = dispatch.submit

    def counted(batch, **kw):
        launched.append((batch.qp, batch.rp, batch.size))
        return real(batch, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dispatch, "submit", counted)
        with StreamingAligner(p, flush_size=4) as stream:
            # bucket A: short pairs (fills: 4 submissions -> launch)
            ha = [stream.submit(b"ACGT", b"ACGTA") for _ in range(4)]
            # buckets B and C: longer pairs (one submission each, partial)
            hb = stream.submit(b"ACGT" * 30, b"ACGTA" * 30)
            hc = stream.submit(b"ACGT" * 10, b"ACGTA" * 10)
            deadline = time.time() + 30
            while not all(h.done() for h in ha) and time.time() < deadline:
                time.sleep(0.01)
            assert all(h.done() for h in ha)
            assert not hb.done() and not hc.done()
            assert launched == [(16, 16, 4)]
            # resolving B's handle launches ONLY bucket B
            want = r.align(b"ACGT" * 30, b"ACGTA" * 30)
            assert _summary([hb.result(timeout=60)]) == _summary([want])
            assert launched == [(16, 16, 4), (128, 192, 1)]
            assert not hc.done()
            assert _summary(_results(ha)) == \
                _summary([r.align(b"ACGT", b"ACGTA")] * 4)

    # interleaved submit / result across buckets
    with StreamingAligner(p, flush_size=8) as s:
        out = []
        for i in range(20):
            q = b"ACGT" * (1 + i % 3)
            t = b"ACGTA" * (1 + i % 5)
            out.append((q, t, s.submit(q, t)))
            if i % 7 == 6:
                qq, tt, hh = out[i - 3]
                assert hh.result(timeout=60).get_score() == \
                    p.align(qq, tt).get_score()
        got = _summary(_results([h for _, _, h in out]))
    qs, ts = [q for q, _, _ in out], [t for _, t, _ in out]
    assert got == _summary(p.align_batch(qs, ts))
    assert got == _summary(r.align_batch(qs, ts))


def test_streaming_interleaved_lifecycle():
    """submit -> flush -> submit -> close keeps resolving correctly."""
    pairs = _pairs(29, 90, lo=25, hi=32, alphabet=PROTEIN)
    qs, rs = [q for q, _ in pairs], [r for _, r in pairs]
    r, p = _both([], matrix=BLOSUM62, open_=11)
    want = _summary(p.align_batch(qs, rs))
    assert want == _summary(_reference_stream(r, qs, rs, 16))
    st = StreamingAligner(p, flush_size=16)
    try:
        h1 = st.submit_many(qs[:40], rs[:40])
        st.flush()
        assert _summary(_results(h1)) == want[:40]
        h2 = st.submit_many(qs[40:], rs[40:])
        st.flush()
        assert _summary(_results(h2)) == want[40:]
    finally:
        st.close()
    # close() after a full drain: handles stay resolved, the thread ends
    assert h2[-1].done()
    assert not st._fetcher.is_alive()


# -- the port's own cases -----------------------------------------------------


def test_trace_bucket_cigars():
    pairs = _pairs(51, 20)
    qs, rs = [q for q, _ in pairs], [r for _, r in pairs]
    r, p = _both(["use_trace"], mode="semi_global")
    with StreamingAligner(p, flush_size=8) as st:
        got = _results(st.submit_many(qs, rs))
    want = p.align_batch(qs, rs)
    assert _summary(got) == _summary(want)
    cigars = p.cigars(got, qs, rs)
    assert cigars == p.cigars(want, qs, rs)
    theirs = _reference_stream(r, qs, rs, 8)
    assert _summary(got) == _summary(theirs)
    assert cigars == r.cigars(theirs, qs, rs)
    assert [a.is_trace() for a in got] == [True] * len(got)


def test_table_bucket():
    pairs = _pairs(53, 12)
    qs, rs = [q for q, _ in pairs], [r for _, r in pairs]
    r, p = _both(["use_stats", "use_table"])
    with StreamingAligner(p, flush_size=8) as st:
        got = _views(_results(st.submit_many(qs, rs)))
    assert got == _views(p.align_batch(qs, rs))
    assert got == _views(r.align_batch(qs, rs))


@pytest.fixture
def short_segments(monkeypatch):
    """Segments of 128 columns, and every batch of 64 x 64 padded cells
    or more on the segment route."""
    monkeypatch.setattr(dispatch, "SEGMENT_COLS",
                        {"score": 128, "stats": 128, "trace": 64})
    monkeypatch.setattr(dispatch, "SEGMENT_MIN_CELLS", 64 * 64)
    monkeypatch.setattr(dispatch, "TRACE_ONE_SHOT_BYTES", 64 * 64)


def test_long_bucket_on_segments(short_segments):
    rng = np.random.default_rng(57)
    qs = [rng.choice(list(b"ACGT"), size=int(n)).astype("uint8").tobytes()
          for n in rng.integers(33, 48, size=5)]
    rs = [rng.choice(list(b"ACGT"), size=int(n)).astype("uint8").tobytes()
          for n in rng.integers(300, 384, size=5)]
    r, p = _both(["use_stats"])
    with StreamingAligner(p, flush_size=4) as st:
        got = _views(_results(st.submit_many(qs, rs)))
    assert p.route_counter == {("torch_segments", "long pairs"): 2}
    assert got == _views(p.align_batch(qs, rs))
    assert got == _views(r.align_batch(qs, rs))


def test_build_error_reaches_only_its_bucket(monkeypatch):
    pairs = _pairs(59, 24)
    qs, rs = [q for q, _ in pairs], [r for _, r in pairs]
    _, p = _both([])
    real = p._alignments_from

    def failing(out, qlens, rlens):
        if max(rlens) > 24:
            raise ValueError("build failed")
        return real(out, qlens, rlens)

    want = _summary(p.align_batch(qs, rs))
    monkeypatch.setattr(p, "_alignments_from", failing)
    with StreamingAligner(p, flush_size=4) as st:
        hs = st.submit_many(qs, rs)
        st.flush()
        for h, w, (q, s) in zip(hs, want, pairs):
            assert h.done()
            if len(s) > 24:
                with pytest.raises(ValueError, match="build failed"):
                    h.result(timeout=60)
            else:
                assert _summary([h.result(timeout=60)]) == [w]
    assert any(len(s) > 24 for _, s in pairs)
    assert any(len(s) <= 24 for _, s in pairs)


def test_launch_error_raises_on_the_launching_thread(monkeypatch):
    _, p = _both([])
    # align_batch launches through dispatch.submit too: its answer first
    want = p.align(b"ACGT" * 5, b"ACGT" * 5).get_score()
    real = dispatch.submit
    launched = []

    def failing(batch, **kw):
        if batch.rp == 32:
            raise RuntimeError("launch failed")
        launched.append(batch.size)
        return real(batch, **kw)

    monkeypatch.setattr(dispatch, "submit", failing)
    st = StreamingAligner(p, flush_size=2)
    ok = [st.submit(b"ACGT" * 5, b"ACGT" * 5) for _ in range(2)]
    bad = st.submit(b"ACGT" * 5, b"ACGT" * 7)
    with pytest.raises(RuntimeError, match="launch failed"):
        st.submit(b"ACGT" * 5, b"ACGT" * 7)
    assert bad.done()
    with pytest.raises(RuntimeError, match="launch failed"):
        bad.result(timeout=60)
    assert [h.result(timeout=60).get_score() for h in ok] == [want] * 2
    # a bulk submit launches every full bucket, then raises the first error
    with pytest.raises(RuntimeError, match="launch failed"):
        st.submit_many([b"ACGT" * 5] * 4, [b"ACGT" * 7] * 2 +
                       [b"ACGT" * 5] * 2)
    assert launched == [2, 2]
    st.close()


def test_kernels_launch_only_on_calling_threads(monkeypatch):
    pairs = _pairs(61, 40)
    qs, rs = [q for q, _ in pairs], [r for _, r in pairs]
    _, p = _both([])
    threads = []
    real = dispatch.submit

    def recorded(batch, **kw):
        threads.append(threading.current_thread())
        return real(batch, **kw)

    monkeypatch.setattr(dispatch, "submit", recorded)
    want = _summary(p.align_batch(qs, rs))
    with StreamingAligner(p, flush_size=8) as st:
        hs = st.submit_many(qs[:30], rs[:30])
        tail = [st.submit(q, s) for q, s in zip(qs[30:], rs[30:])]
        first = len(threads)
        # a result() on another thread launches that handle's partial
        # bucket there
        lone = st.submit(b"ACGT" * 10, b"ACGT" * 10)
        got = []
        worker = threading.Thread(target=lambda: got.append(
            lone.result(timeout=60)), name="result-caller")
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive()
        assert got[0].get_score() == p.align(b"ACGT" * 10,
                                             b"ACGT" * 10).get_score()
        st.flush()
        assert _summary(_results(hs + tail)) == want
        fetcher = st._fetcher
    names = {t.name for t in threads}
    assert fetcher not in threads and FETCH_THREAD not in names
    assert names == {threading.main_thread().name, "result-caller"}
    assert threads[:first] == [threading.main_thread()] * first


def test_flagged_pairs_rerun_on_the_fetch_thread_under_the_lock(
        monkeypatch):
    """Buckets that come back from the packed score form with pairs it
    flagged (SW of identical sequences past 32,767, at 100 a match): the
    fetch thread recomputes those pairs through the int32 form while it
    holds the stream's lock, and every result equals ``align_batch``'s.
    On the CPU the packed form is stood in for: the int32 result, its
    flagged pairs' scores wrapped as 16-bit halves would wrap them, and
    ``over16`` beside them."""
    rng = np.random.default_rng(67)
    same = rng.choice(list(b"ACGT"), size=400).astype("uint8").tobytes()
    pairs = [(same, same)] * 3 + _pairs(67, 5, lo=300, hi=400)
    qs, rs = [q for q, _ in pairs], [r for _, r in pairs]
    matrix = ref.Matrix.create(b"ACGT", 100, -3)
    _, p = _both([], matrix=matrix, open_=14, ext=1)
    want = _summary(p.align_batch(qs, rs))
    assert sum(w[0] > 32767 for w in want) == 3
    real_run, real_sub = dispatch._run, dispatch._sub_batch
    st = StreamingAligner(p, flush_size=2)
    reruns = []

    def packed_run(batch, **kw):
        res = real_run(batch, **kw)
        if kw["outputs"] != "score":
            return res
        guard = 2 * (14 + 1 + 100) + 2
        over = res["score"].abs() > 32767 - guard
        return {**res, "over16": over.to(torch.int32),
                "score": torch.where(over, res["score"] - 65536,
                                     res["score"])}

    def recorded(batch, idx):
        reruns.append((threading.current_thread().name,
                       st._lock._is_owned(), len(idx)))
        return real_sub(batch, idx)

    monkeypatch.setattr(dispatch, "_run", packed_run)
    monkeypatch.setattr(dispatch, "_sub_batch", recorded)
    with st:
        got = _summary(_results(st.submit_many(qs, rs)))
    assert got == want
    assert reruns and {(t, held) for t, held, _ in reruns} == {
        (FETCH_THREAD, True)}
    assert sum(n for _, _, n in reruns) == 3


def test_many_threads_submit_and_resolve(monkeypatch):
    """Sixteen threads (more than the cores that run the tests) submit
    pairs and read results at once, with the interpreter switching
    threads every microsecond: every pair is launched exactly once and
    every result is its own."""
    import sys

    pairs = _pairs(71, 160)
    _, p = _both([])
    want = _summary(p.align_batch([q for q, _ in pairs],
                                  [s for _, s in pairs]))
    launched = []
    real = dispatch.submit

    def counted(batch, **kw):
        launched.append(batch.size)
        return real(batch, **kw)

    monkeypatch.setattr(dispatch, "submit", counted)
    got = [None] * len(pairs)
    errors = []
    st = StreamingAligner(p, flush_size=4)

    def worker(k):
        try:
            mine = list(range(k, len(pairs), 16))
            hs = [st.submit(*pairs[i]) for i in mine]
            for i, h in zip(mine, hs):
                got[i] = _summary([h.result(timeout=60)])[0]
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        st.close()
    assert not any(w.is_alive() for w in workers) and errors == []
    assert got == want
    assert sum(launched) == len(pairs)


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_stream_matches_align_batch(cuda_device):
    from parasail_rs_tpu_torch.ops import scan_kernel as tk

    pairs = _pairs(67, 300, lo=140, hi=160, alphabet=PROTEIN)
    qs, rs = [q for q, _ in pairs], [r for _, r in pairs]
    card = (port.Aligner.new().matrix(port_matrix(BLOSUM62)).gap_open(11)
            .gap_extend(1).local().use_stats().device(cuda_device).build())
    before = tk.SHORT_LAUNCHES["stats"]
    with StreamingAligner(card, flush_size=128) as st:
        got = _views(_results(st.submit_many(qs, rs)))
    assert tk.SHORT_LAUNCHES["stats"] == before + 3
    assert set(card.route_counter) == {("cuda_kernel", "")}
    assert got == _views(card.align_batch(qs, rs))
