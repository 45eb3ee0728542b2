"""The control of a cell's check, on the card at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--seconds 3] [--control saturate8|gap]

For each seed: a short window of the program at the cell's load, then
the sample a run compares, answered by the control instead of by the
program: the plain reference computed in 8-bit saturating arithmetic
(``saturate8``, the default), or with ``gap_open - gap_extend`` as the
open (``gap``).  Prints one line a seed with the numbers compared; each
has to exceed its limit somewhere for the check to be a check.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", choices=harness.CONTROLS,
                    default="saturate8")
    args = ap.parse_args()
    for seed in args.seeds:
        r = harness.run(args.workload, seed, args.seconds, False,
                        device="cuda", control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "correct": r["correct"],
                          "compared": r["compared"],
                          "checks": {k: v["value"]
                                     for k, v in r["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
