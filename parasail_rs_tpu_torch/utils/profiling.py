"""Profiling and tracing hooks of the port, on torch's profiler.

:mod:`~parasail_rs_tpu_torch.engine.dispatch` names every batch it runs
(``pt.execute.<mode>.<outputs>``), so the card's kernels show up under
that name in a captured trace and, on a card, in Nsight Systems; each
public ``Aligner`` call opens ``pt.call.<method>``, and while
:mod:`~parasail_rs_tpu_torch.utils.stages` is on each host stage opens
``stage.<name>`` through :class:`trace_region` as well.

Usage:
    with profiling.trace_region("align_batch"):
        aligner.align_batch(...)
    with profiling.capture("traces") as prof:   # programmatic capture
        ...
    prof.key_averages()                          # or open the trace file

torch has no live capture server, so :func:`start_server` raises.
"""

from __future__ import annotations

import contextlib
import glob
import os

import torch


# whether trace regions push NVTX ranges: CUDA's availability, read once,
# on the first region (not at import, so that a forked child reads it
# for itself)
_NVTX: bool | None = None


class trace_region:
    """A named region: a ``record_function`` while torch's profiler
    records, and an NVTX range where CUDA is available.  With no capture
    active and no card it costs two flag tests."""

    __slots__ = ("name", "_nvtx", "_record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _NVTX
        if _NVTX is None:
            _NVTX = torch.cuda.is_available()
        self._nvtx = _NVTX
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._record = None
        if torch._C._autograd._profiler_enabled():
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()
        return self

    def __exit__(self, *exc):
        if self._record is not None:
            self._record.__exit__(*exc)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        return False


def start_server(port: int = 9999):
    """torch has no capture server (the JAX profiler's ``start_server``):
    always raises :class:`NotImplementedError`; use :func:`capture`."""
    raise NotImplementedError(
        f"no profiler capture server on port {port}: torch has none; "
        "wrap the calls to trace in profiling.capture(log_dir)")


@contextlib.contextmanager
def capture(log_dir: str):
    """Capture a trace for the duration of the block: host activity, and
    the card's kernels and copies where CUDA is available.  Yields the
    ``torch.profiler.profile`` (``key_averages()``, ``events()``).  On
    exit it writes one Chrome trace, ``<host>_<pid>.<ms>.pt.trace.json``
    (``torch.profiler.tensorboard_trace_handler``'s name, which
    TensorBoard's profiler plugin reads), under ``log_dir``, created if
    missing; :func:`trace_files` lists them."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def trace_files(log_dir: str) -> list[str]:
    """The Chrome traces :func:`capture` wrote under ``log_dir``, oldest
    first."""
    return sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json")),
                  key=os.path.getmtime)
