"""One run of one cell: set-up, the measured window, the check.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration ``configs/<config>.json``, the mix ``traffic/<mix>.json``,
which names its generator ``traffic/<generator>.py`` and its entry
``entries/<entry>.py``, and a reader ``metrics/<metric>.py`` for each
metric.

The window is a closed loop: one caller, the next call once the last
has returned, from the first call until the first return past
``seconds``.  Each call keeps a few answers (drawn from the seed, the
planted homologs of its query, and its longest pair); once the window
has closed, the memory peak read and the system freed, a sample of them
drawn from the seed, the longest kept pair in it, is held to the plain
reference (``reference/sweep.py``), computed on the same device.

A control (``CONTROLS``) puts the reference, broken one way, in the
program's place for what is compared; the check has to fail it.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# every number compared is a count of sampled answers that differ from
# the reference's, so each limit is 0 (an exact comparison)
LIMITS = {"failed_alignments": 0, "score_mismatch": 0, "end_mismatch": 0,
          "cigar_mismatch": 0}

FORBIDDEN = ("jax", "jaxlib", "flax", "parasail_rs_tpu")

# the controls: ``saturate8`` computes in saturating 8-bit arithmetic
# (it differs only past +-127); ``gap`` takes ``gap_open - gap_extend``
# as the open, the sources' ``o`` undoing the configuration's stated
# ``gap_mapping`` (it differs wherever an optimal alignment holds a gap)
CONTROLS = ("saturate8", "gap")


@dataclass
class Reading:
    """What a run measured; the metric readers read it."""

    setup_s: float = 0.0
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    cells: int = 0
    alignments: int = 0
    calls: int = 0
    least_s: float = 0.0
    stages: dict | None = None
    device: dict | None = None


@dataclass
class Kept:
    query: bytes
    ref: bytes
    answer: tuple
    planted: bool
    cells: int


def process_start() -> float:
    """The process's start on ``time.time()``'s clock, from /proc; the
    harness's import time where /proc has none."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py``; a metric's name may hold dots."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merged(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = (merged(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def cell_spec(workload: str):
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = load_json(HERE, "configs", cell["config"] + ".json")
    mix = load_json(HERE, "traffic", cell["traffic"] + ".json")
    return bench, cell, config, mix


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def keep_positions(rng, req, k: int) -> np.ndarray:
    """``k`` positions drawn from the seed, the planted homologs of the
    call's query and the call's longest pair."""
    rand = rng.choice(req.n, min(k, req.n), replace=False)
    longest = np.argmax(np.asarray(req.qlens) * req.rlens)
    return np.unique(np.concatenate([rand, req.planted, [longest]]))


def sample(rng, kept: list[Kept], spec: dict) -> list[Kept]:
    """``spec["size"]`` kept answers drawn from the seed: the longest,
    ``planted_share`` of them planted homologs and the rest from the
    other answers (planted ones only where those run out)."""
    size = int(spec["size"])
    if len(kept) <= size:
        return list(kept)
    longest = max(range(len(kept)), key=lambda i: kept[i].cells)
    chosen = {longest}
    planted = [i for i, k in enumerate(kept) if k.planted and i != longest]
    n_pl = min(len(planted), int(size * spec.get("planted_share", 0.0)))
    if n_pl:
        chosen.update(rng.choice(planted, n_pl, replace=False).tolist())
    for pool in ([i for i, k in enumerate(kept) if not k.planted],
                 range(len(kept))):
        rest = [i for i in pool if i not in chosen]
        n = min(len(rest), size - len(chosen))
        chosen.update(rng.choice(rest, n, replace=False).tolist())
    return [kept[i] for i in sorted(chosen)]


def compare(got: list[tuple], want: list[tuple], cigar: bool) -> dict:
    out = {"score_mismatch": sum(g[0] != w[0] for g, w in zip(got, want)),
           "end_mismatch": sum(tuple(g[1:3]) != tuple(w[1:3])
                               for g, w in zip(got, want))}
    if cigar:
        out["cigar_mismatch"] = sum(g[3] != w[3] for g, w in zip(got, want))
    return out


def forbidden_modules(names=None) -> list[str]:
    """The FORBIDDEN top-level names among ``names`` (default: the
    modules loaded), each module's top-level name compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_info(device) -> dict:
    import torch

    if str(device).startswith("cuda"):
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
                "power_limit": power_limit()}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return info


def power_limit() -> str | None:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def control_name(control) -> str | None:
    """The control a run's ``control`` argument names: False for none,
    True for ``saturate8``."""
    if control is False or control is None:
        return None
    name = "saturate8" if control is True else control
    if name not in CONTROLS:
        raise ValueError(f"control {control!r}: one of {CONTROLS}")
    return name


def control_answers(name: str, pairs, scoring: dict, cigar: bool, device):
    from .reference import sweep

    if name == "gap":
        scoring = dict(scoring,
                       gap_open=scoring["gap_open"] - scoring["gap_extend"])
    return sweep.align(pairs, scoring, cigar=cigar, device=device,
                       saturate8=name == "saturate8")


def synchronize(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", overrides: dict | None = None,
        control: bool | str = False, log=sys.stderr) -> dict:
    """One run; returns the result line as a dict (``checks`` last).

    ``overrides`` merge into the configuration (``"config"``) and the
    mix (``"traffic"``): the CPU tests' small sizes.  ``control`` (a
    name of ``CONTROLS``, True for ``saturate8``) puts that control in
    the program's place for what is compared."""
    from . import roofline
    from .reference import sweep
    from .tracing import Tracer

    t_start = process_start()
    control = control_name(control)
    seed = int(seed) % (1 << 64)
    bench, _, config, mix = cell_spec(workload)
    overrides = overrides or {}
    config = merged(config, overrides.get("config"))
    mix = merged(mix, overrides.get("traffic"))
    gen = load_module("traffic", mix["generator"])
    entry = load_module("entries", mix["entry"])
    readers = {m["name"]: load_module("metrics", m["name"])
               for m in metrics_of(bench, workload, trace)}

    t = [time.time()]
    traffic = gen.make(config, mix, seed)
    t.append(time.time())
    system = entry.build(config, traffic, device)
    t.append(time.time())
    for req in traffic.warmup():
        system.call(req)
    synchronize(device)
    gc.collect()
    t.append(time.time())
    print(f"setup: to the harness {t[0] - t_start:.3f} s, traffic "
          f"{t[1] - t[0]:.3f} s, system {t[2] - t[1]:.3f} s, warm-up "
          f"{t[3] - t[2]:.3f} s", file=log)

    reading = Reading()
    keep_rng = np.random.default_rng([seed, 31])
    k_rand = int(mix["keep_random"])
    scoring = config["scoring"]
    kept: list[Kept] = []
    failed = attempted = 0
    tracer = Tracer(trace)
    clock = time.perf_counter
    with tracer, tracer.region("bench.window"):
        reading.setup_s = time.time() - t_start
        t0 = clock()
        deadline = t0 + seconds
        c = 0
        while True:
            req = traffic.request(c)
            c += 1
            attempted += req.n
            a = clock()
            try:
                with tracer.region("bench.call"):
                    result = system.call(req)
            except Exception:          # an answer that never comes
                failed += req.n
                result = None
                traceback.print_exc(file=log)
            b = clock()
            reading.latencies_s.append(b - a)
            if result is not None:
                with tracer.region("bench.keep"):
                    reading.cells += roofline.cells(req, scoring)
                    reading.alignments += req.n
                    ops, nbytes = roofline.count(req, scoring, entry.CIGAR)
                    reading.least_s += roofline.least_seconds(ops, nbytes)
                    pos = keep_positions(keep_rng, req, k_rand)
                    planted = set(req.planted.tolist())
                    lens = np.asarray(req.qlens) * req.rlens
                    for p, ans in zip(pos.tolist(),
                                      system.answers(req, result, pos)):
                        kept.append(Kept(*req.pair(p), ans, p in planted,
                                         int(lens[p])))
            del result
            if b >= deadline:
                break
        reading.window_s = clock() - t0
    reading.calls = c
    if trace:
        reading.stages = tracer.stage_totals()
        reading.device = tracer.reduce()
    info = device_info(device)
    if trace and reading.device:
        info["busy_s"] = reading.device["busy_s"]
        info["window_s"] = reading.device["window_s"]
    del system, traffic, tracer
    gc.collect()
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.empty_cache()

    t_check = time.time()
    checked = sample(np.random.default_rng([seed, 41]), kept, mix["sample"])
    pairs = [(k.query, k.ref) for k in checked]
    want = sweep.align(pairs, scoring, cigar=entry.CIGAR, device=device)
    got = [k.answer for k in checked]
    if control:
        got = control_answers(control, pairs, scoring, entry.CIGAR, device)
    print(f"window: {reading.calls} calls, {reading.alignments} alignments "
          f"in {reading.window_s:.3f} s; check: {len(checked)} answers in "
          f"{time.time() - t_check:.3f} s", file=log)
    numbers = {"failed_alignments": failed, **compare(got, want, entry.CIGAR)}
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    correct = bool(checked) and all(v["value"] <= v["limit"]
                                    for v in checks.values())

    metrics = {}
    for m in metrics_of(bench, workload, trace):
        v = readers[m["name"]].read(reading)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": info}
    if trace and reading.device:
        out["breakdown"] = {"device_ops": reading.device["device_ops"],
                            "idle_gaps": reading.device["idle_gaps"]}
    out["compared"] = len(checked)
    out["checks"] = checks
    return out


def check_lines(result: dict) -> list[str]:
    return [f"check {k} {v['value']} limit {v['limit']} "
            f"(of {result['compared']} answers compared)"
            for k, v in result["checks"].items()]
