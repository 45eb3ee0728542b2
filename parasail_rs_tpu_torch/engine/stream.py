"""Streaming executor: serving over an unbounded pair stream, on torch.

The port of ``parasail_rs_tpu.engine.stream``.  Submissions accumulate
into length-binned buckets (``utils.shapes.length_bucket`` of each side);
each full bucket is packed and launched at once through
:func:`dispatch.submit`, whose per-pair results start their pinned,
non-blocking copy to the host before it returns, and a daemon fetch
thread resolves each bucket as its copy lands: the host pack of the next
bucket, the card's sweep of the current one and the result build of the
previous one overlap.

    stream = StreamingAligner(aligner, flush_size=2048)
    handles = [stream.submit(q, r) for q, r in pairs]
    for h in handles:          # resolves per bucket, in completion order
        h.result().get_score()

``Handle.result()`` launches only the bucket holding that pair (if it has
not filled yet) and waits only for that bucket; ``flush()`` launches
every partial bucket and waits for all (the end-of-stream barrier).

Kernels launch under the stream's lock, on the threads that call
``submit``, ``submit_many``, ``flush`` or ``Handle.result``.  The fetch
thread waits on each copy's CUDA event, reads pinned memory and builds
the results; it launches and allocates on the card only where the
packed score form flagged pairs of a bucket (``dispatch.PendingResult``'s
rerun through the int32 form), and then under the stream's lock, which
it releases before it waits for the rerun's copy.  Such a bucket waits
for the work enqueued before its rerun.  The classes with planes (trace, table, rowcol) and width-64
batches that need the host's int64 merge are fetched by
:func:`dispatch.submit` already, on the launching thread, as in
``Aligner.align_many``: their :class:`dispatch.PendingResult` carries
the host results.  An error in one bucket's fetch or build reaches
every handle of that bucket through ``result()`` and no other; an error
of a launch raises on the launching thread and reaches that bucket's
handles too.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field

import numpy as np

from ..utils.shapes import length_bucket


@dataclass(eq=False)
class Handle:
    """Future-like handle for one submitted pair."""

    _stream: "StreamingAligner"
    # its bucket's event: one a bucket, which resolves as a whole
    _event: threading.Event
    _bucket_key: tuple
    _value: object = None
    _done: bool = False
    _error: BaseException | None = None

    def done(self) -> bool:
        return self._done

    def result(self, timeout: float | None = None):
        """This pair's Alignment.

        Launches the pair's own bucket if it is still accumulating, then
        waits for that bucket alone; other buckets keep streaming.
        """
        if not self._done:
            self._stream._ensure_dispatched(self)
            if not self._event.wait(timeout):
                raise TimeoutError("alignment result not ready")
        if self._error is not None:
            raise self._error
        return self._value


@dataclass(eq=False)
class _Bucket:
    qp: int
    rp: int
    queries: list = field(default_factory=list)
    references: list = field(default_factory=list)
    handles: list = field(default_factory=list)
    # shared by every handle of the bucket, set once all hold their value
    event: threading.Event = field(default_factory=threading.Event)

    @property
    def size(self) -> int:
        return len(self.references)

    def resolve(self, values=None, error: BaseException | None = None):
        """Give every handle its value (or the error), then fire the
        event: a waiter never wakes to an unfilled slot."""
        for k, h in enumerate(self.handles):
            h._value = None if values is None else values[k]
            h._error = error
            h._done = True
        self.event.set()


class StreamingAligner:
    """Length-binned asynchronous batcher around an :class:`Aligner`.

    ``flush_size`` bounds pairs per kernel launch; ``max_cells`` bounds
    padded DP cells per launch (memory / latency).  Safe for one producer
    thread plus any number of threads calling ``Handle.result()``.
    """

    def __init__(self, aligner, flush_size: int = 2048,
                 max_cells: int = 1 << 28):
        from ..native import packer, walker

        self._aligner = aligner
        self._flush_size = flush_size
        self._max_cells = max_cells
        self._buckets: dict[tuple[int, int], _Bucket] = {}
        self._lock = threading.RLock()
        self._inflight: list[threading.Event] = []
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        # build (or load) the native libraries here, not on a later
        # launching thread or in a result's get_cigar
        packer.available()
        if aligner.key.outputs == "trace":
            walker.available()
        self._fetcher = threading.Thread(
            target=self._fetch_loop, daemon=True,
            name="parasail-stream-fetch")
        self._fetcher.start()

    def _bucket(self, key) -> _Bucket:
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = self._buckets[key] = _Bucket(qp=key[0], rp=key[1])
        return bucket

    def submit(self, query, reference) -> Handle:
        """Queue one pair; launches a kernel when its bucket fills."""
        a = self._aligner
        if not a.profile.is_null:
            query = None
        qlen = a.profile.query_len if query is None else len(query)
        key = (length_bucket(qlen), length_bucket(len(reference)))
        with self._lock:
            bucket = self._bucket(key)
            h = Handle(self, bucket.event, key)
            bucket.queries.append(query)
            bucket.references.append(reference)
            bucket.handles.append(h)
            cells = bucket.size * bucket.qp * bucket.rp
            if bucket.size >= self._flush_size or cells >= self._max_cells:
                self._launch(self._buckets.pop(key))
        return h

    def submit_many(self, queries, references) -> list[Handle]:
        """Bulk :meth:`submit`: one call for a whole list of pairs.

        The same semantics as submitting each pair in a loop (same
        binning, same flush thresholds, handles in input order), with the
        bucket keys computed in numpy and one event a bucket.  ``queries``
        may be None when the aligner holds a profile.
        """
        a = self._aligner
        refs = list(references)
        n = len(refs)
        if not a.profile.is_null:
            queries = None
        if queries is None:
            if a.profile.is_null:
                from ..errors import QueryRequired

                raise QueryRequired(
                    "Query sequences are required without a profile.")
            qlist = None
            qlens = np.full(n, a.profile.query_len, np.int64)
        else:
            qlist = list(queries)
            qlens = np.fromiter((len(q) for q in qlist), np.int64, n)
        rlens = np.fromiter((len(r) for r in refs), np.int64, n)

        def vbucket(lens):
            u, inv = np.unique(lens, return_inverse=True)
            return np.array([length_bucket(int(x)) for x in u],
                            np.int64)[inv]

        qb = vbucket(qlens)
        rb = vbucket(rlens)
        groups, ginv = np.unique(qb << 32 | rb, return_inverse=True)
        handles: list[Handle | None] = [None] * n
        with self._lock:
            full: list[_Bucket] = []
            for gi in range(len(groups)):
                idx = np.nonzero(ginv == gi)[0]
                key = (int(qb[idx[0]]), int(rb[idx[0]]))
                cap = min(self._flush_size,
                          max(1, self._max_cells // (key[0] * key[1])))
                pos = 0
                while pos < len(idx):
                    bucket = self._bucket(key)
                    take = idx[pos:pos + max(1, cap - bucket.size)]
                    pos += len(take)
                    hs = [Handle(self, bucket.event, key) for _ in take]
                    for i, h in zip(take.tolist(), hs):
                        handles[i] = h
                    bucket.queries.extend(
                        [None] * len(take) if qlist is None else
                        (qlist[i] for i in take.tolist()))
                    bucket.references.extend(refs[i] for i in take.tolist())
                    bucket.handles.extend(hs)
                    if bucket.size >= cap:
                        full.append(self._buckets.pop(key))
            self._launch_group(full)
        return handles

    def _launch_group(self, buckets: list[_Bucket]) -> None:
        """Launch each bucket in turn; a failed launch does not stop the
        others, and the first error raises once all were tried.  Caller
        holds the lock."""
        first = None
        for bucket in buckets:
            try:
                self._launch(bucket)
            except Exception as e:  # noqa: BLE001 -- raised below
                first = first or e
        if first is not None:
            raise first

    def _ensure_dispatched(self, handle: Handle) -> None:
        """Launch the (partial) bucket holding ``handle`` if it has not
        launched yet; never touches other buckets."""
        with self._lock:
            key = handle._bucket_key
            bucket = self._buckets.get(key)
            if bucket is not None and bucket.event is handle._event:
                self._launch(self._buckets.pop(key))

    def _launch(self, bucket: _Bucket) -> None:
        """Pack one bucket, launch it and queue it for the fetch thread.
        Caller holds the lock.  A failure resolves the bucket's handles
        with the error and raises it here."""
        a = self._aligner
        try:
            batch, qlens, rlens = a._pack(
                None if bucket.queries[0] is None else bucket.queries,
                bucket.references, Qp=bucket.qp, Rp=bucket.rp)
            res = a._submit(batch)
        except Exception as e:
            bucket.resolve(error=e)
            raise
        self._inflight.append(bucket.event)
        self._queue.put((res, qlens, rlens, bucket))

    def _fetch_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            res, qlens, rlens, bucket = item
            try:
                values = self._aligner._alignments_from(
                    res.fetch(lock=self._lock)[0], qlens, rlens)
            except Exception as e:  # noqa: BLE001 -- to this bucket's result()
                bucket.resolve(error=e)
            else:
                bucket.resolve(values)

    def flush(self) -> None:
        """Launch every partial bucket and wait for every launched bucket
        to resolve (end-of-stream barrier)."""
        with self._lock:
            partial = [b for b in self._buckets.values() if b.size]
            self._buckets.clear()
            self._launch_group(partial)
            inflight, self._inflight = self._inflight, []
        for ev in inflight:
            ev.wait()

    def close(self) -> None:
        """Drain and stop the fetch thread."""
        try:
            self.flush()
        finally:
            self._queue.put(None)
            self._fetcher.join(timeout=10)

    def __enter__(self) -> "StreamingAligner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
