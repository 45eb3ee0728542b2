"""Host spans and counters of the port, on the device trace's clock.

One user call crosses these host stages around the card's kernels.  Each
is timed where its work happens and none opens inside another, so their
sum is the host time under a span:

- ``bins``: ``Aligner.align_many`` / ``align_cigars`` read the lengths,
  group the pairs by padded shape (``engine.binning.plan_bins`` /
  ``batch.merge_bins``),
  gather each bin's sequences and put the results back in input order;
- ``pack``: ``dispatch.pack_pairs``, sequences to padded planes and their
  upload;
- ``dispatch``: the route's planning (``dispatch.plan_route``), the
  batch's letter indices and the kernels' enqueue;
- ``walk``: the device walk's enqueue (``align_cigars``, ``ssw``);
- ``fetch.start``: a result block's stack, its pinned buffer and the
  non-blocking copy's enqueue (``dispatch.PendingResult``), and a trace
  segment's copy;
- ``fetch.wait``: the host blocked on the card, on a copy's event;
- ``fetch.copy``: the host's own work once the data is there: views,
  unpacking, the planes' copies, a segmented trace plane's assembly;
- ``build``: result objects (``Aligner._alignments_from``);
- ``encode``: ``align_cigars``' CIGAR strings;
- ``walk.host``: the host walker (``Alignment.get_cigar``,
  ``get_traceback_strings``, ``print_traceback``; ``Aligner.cigars``).

Counters (:func:`count`), counted where the thing happens: ``bins`` (one
a batch, where its route is tallied), ``launches`` (the port's own CUDA
kernel launches), ``cells_real`` (a batch's sum of qlen * rlen),
``cells_padded`` (its B * Qp * Rp), ``cells_band`` (a banded batch's
cells with |i - j| <= bw, of its real lengths), ``cells_band_swept``
(the cells its launch's schedule sweeps: the ring's lanes a step times
its steps, or B * Qp * Rp for the masked full sweep;
``ops.scan_kernel.band_swept``) and ``gc_collections`` (the cyclic
collector's runs that start inside a thread's outermost public call,
``engine.aligner._call_region``); and for the block kernel's score class
(``engine.dispatch.packed_units``, :class:`~..engine.dispatch.PendingResult`)
``score16_pairs`` (pairs a batch launched on the packed 16x2 form),
``score16_reruns`` (of those, pairs its fetch recomputed through the
int32 form) and ``score32_pairs`` (pairs the route sent to the int32 form
directly).

Off by default: then :func:`stage` and :func:`count` cost a call and one
flag test.  On (:func:`enable`, or :func:`measuring` for a block), a stage
adds its wall time to its total and opens its span on the trace as well,
``stage.<name>``: a ``record_function`` while torch's profiler records and
an NVTX range where CUDA is available
(:class:`~parasail_rs_tpu_torch.utils.profiling.trace_region`), opened
before its clock reads and closed after, so that a device trace puts each
idle gap of the card under the span the host was in.  :func:`snapshot`
gives ``{stage: {"ms", "calls"}}`` and ``{"count.<name>": {"n"}}`` since
:func:`reset`.

To look: ``stages.enable(True)``, then run under ``torch.profiler.profile``
(the ``stage.*`` spans beside the ``pt.call.*`` and ``pt.execute.*``
regions and the card's kernels) or under ``nsys profile --trace
cuda,nvtx``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

from . import profiling

enabled = False
_lock = threading.Lock()
_acc: dict[str, float] = defaultdict(float)
_cnt: dict[str, int] = defaultdict(int)


def enable(on: bool = True) -> None:
    global enabled
    enabled = on


def reset() -> None:
    with _lock:
        _acc.clear()
        _cnt.clear()


def record(name: str, seconds: float) -> None:
    with _lock:
        _acc[name] += seconds
        _cnt[name] += 1


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while spans are on."""
    if not enabled:
        return
    with _lock:
        _cnt["count." + name] += int(n)


def snapshot() -> dict[str, dict[str, float]]:
    """{stage: {"ms": total, "calls": n}} and {"count.<name>": {"n":
    total}} accumulated since reset()."""
    with _lock:
        out = {k: {"ms": round(_acc[k] * 1e3, 2), "calls": _cnt[k]}
               for k in sorted(_acc)}
        out.update((k, {"n": _cnt[k]}) for k in sorted(_cnt)
                   if k.startswith("count."))
        return out


class _Off:
    """:func:`stage` while spans are off: enters and leaves, nothing more."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """A stage while spans are on: its region opens before the clock
    reads and closes after it reads again."""

    __slots__ = ("name", "_region", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._region = profiling.trace_region("stage." + self.name)
        self._region.__enter__()
        self._t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        record(self.name, time.perf_counter() - self._t0)
        self._region.__exit__(*exc)
        return False


def stage(name: str):
    """``with stage(name):`` times the block as stage ``name`` and opens
    its ``stage.<name>`` span while spans are on."""
    if not enabled:
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def measuring():
    """Enable + reset for a `with` block; restores the previous state."""
    prev = enabled
    enable(True)
    reset()
    try:
        yield
    finally:
        enable(prev)
