"""The traced run: torch's profiler over the window, and its reduction to
device busy time, kernel time, and the breakdown.

The profiler records the card's kernels, copies and sets, and the host's
regions: the program's ``pt.execute.*`` batches, its stage clocks
(``utils/stages.py``, each stage also opened as a ``stage.<name>``
region while tracing) and the harness's ``bench.*`` spans.  Nothing is
written to disk: the events are read in memory once the window closes.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

HOST_PREFIXES = ("stage.", "pt.execute", "bench.")
WINDOW = "bench.window"
TOP = 10
NAME_CHARS = 160          # a kernel's name in the breakdown, cut to this


@dataclass
class Event:
    name: str
    start: float          # seconds on the profiler's clock
    end: float
    kind: str             # "kernel", "memcpy", "memset" or "host"


def kind_of(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def union(intervals) -> list[tuple[float, float]]:
    """Merged, sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def gaps(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle intervals of [lo, hi] between merged busy intervals."""
    out, t = [], lo
    for a, b in merged:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def name_gaps(idle, regions) -> dict[str, float]:
    """Idle seconds summed by the innermost host region around each
    gap's midpoint (``host`` where no region is open).  Regions of one
    thread nest, so one sweep with a stack finds each."""
    regions = sorted(regions, key=lambda e: (e.start, -e.end))
    starts = [e.start for e in regions]
    out: dict[str, float] = {}
    stack: list[Event] = []
    k = 0
    for a, b in sorted(idle):
        m = (a + b) / 2
        while k < len(regions) and starts[k] <= m:
            stack = [e for e in stack if e.end >= regions[k].start]
            stack.append(regions[k])
            k += 1
        stack = [e for e in stack if e.end >= m]
        name = stack[-1].name if stack else "host"
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def top(d: dict[str, float], n: int = TOP) -> list[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def reduce(events: list[Event]) -> dict | None:
    """Busy, kernel and window seconds and the breakdown of one traced
    window; None without a window region or any device event in it."""
    windows = [e for e in events if e.kind == "host" and e.name == WINDOW]
    if not windows:
        return None
    lo, hi = windows[0].start, windows[0].end
    device = [e for e in events if e.kind != "host"]
    spans = clip([(e.start, e.end) for e in device], lo, hi)
    if not spans:
        return None
    merged = union(spans)
    by_name: dict[str, float] = {}
    kernel_s = 0.0
    for e in device:
        s = min(e.end, hi) - max(e.start, lo)
        if s <= 0:
            continue
        name = e.name[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + s
        if e.kind == "kernel":
            kernel_s += s
    idle = gaps(merged, lo, hi)
    regions = [e for e in events if e.kind == "host" and e.name != WINDOW]
    return {
        "window_s": hi - lo,
        "busy_s": sum(b - a for a, b in merged),
        "kernel_s": kernel_s,
        "device_ops": top(by_name),
        "idle_gaps": top(name_gaps(idle, regions)),
    }


def events_of(prof) -> list[Event]:
    """The profiler's device operations and the host regions the
    breakdown names, in seconds."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name.startswith(HOST_PREFIXES) or e.is_user_annotation():
                continue        # the device side of a host region
            out.append(Event(name, start, end, kind_of(name)))
        elif name.startswith(HOST_PREFIXES):
            out.append(Event(name, start, end, "host"))
    return out


class Tracer:
    """Profiles a window when on; ``region(name)`` opens a host region.
    While on, the program's stage clocks run and each stage is a
    ``stage.<name>`` region."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self._patched = None

    def region(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def __enter__(self):
        if not self.on:
            return self
        import torch
        from parasail_rs_tpu_torch.utils import stages

        orig = stages.stage

        @contextlib.contextmanager
        def stage(name):
            with torch.profiler.record_function("stage." + name), orig(name):
                yield

        self._patched = (stages, orig)
        stages.stage = stage
        stages.enable(True)
        stages.reset()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        self.prof.__exit__(*exc)
        stages, orig = self._patched
        stages.stage = orig
        stages.enable(False)
        return False

    def stage_totals(self) -> dict:
        from parasail_rs_tpu_torch.utils import stages

        return stages.snapshot()

    def reduce(self) -> dict | None:
        return reduce(events_of(self.prof))

