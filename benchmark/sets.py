"""Sets of runs of one cell, for the spreads that bounds are set from.

    python3 benchmark/sets.py --workload <cell> --seeds 11 12 13 \
        --seconds 20 [--trace 0|1] [--sets 2] [--out runs.jsonl]

Runs ``benchmark/run.py`` once per seed in each set, one process after
another, and appends each run's result line (with its set, seed, exit
code and wall seconds) to ``--out``.  Then prints, per set and metric,
the median and the spread: the interquartile distance over the median,
by ``statistics.quantiles(values, n=4)``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark.stats import spread  # noqa: E402


def one(workload, seed, seconds, trace) -> dict:
    t = time.perf_counter()
    p = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], capture_output=True, text=True,
        cwd=os.path.dirname(HERE))
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"seed": seed, "rc": p.returncode,
            "wall_s": time.perf_counter() - t, "result": result,
            "stderr_tail": p.stderr[-3000:]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    by_set: list[list[dict]] = []
    for s in range(args.sets):
        runs = []
        for seed in args.seeds:
            r = one(args.workload, seed, args.seconds, args.trace)
            r["set"] = s
            runs.append(r)
            res = r["result"] or {}
            print(json.dumps({"set": s, "seed": seed, "rc": r["rc"],
                              "wall_s": round(r["wall_s"], 1),
                              "correct": res.get("correct"),
                              "metrics": {k: v["value"] for k, v in
                                          res.get("metrics", {}).items()},
                              "memory_peak_bytes": res.get("device", {}).get(
                                  "memory_peak_bytes")}), flush=True)
            if r["rc"] != 0 or not res:
                print(r["stderr_tail"], file=sys.stderr, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps({"workload": args.workload, **r}) + "\n")
        by_set.append(runs)
    for s, runs in enumerate(by_set):
        vals: dict[str, list[float]] = {}
        for r in runs:
            for k, v in ((r["result"] or {}).get("metrics") or {}).items():
                vals.setdefault(k, []).append(v["value"])
        for k, v in vals.items():
            line = {"set": s, "metric": k, "n": len(v),
                    "median": statistics.median(v)}
            if len(v) >= 2:
                line["spread"] = spread(v)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
