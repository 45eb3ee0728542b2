"""Serving on the PyTorch port: the streaming executor over a pair stream.

Run: python examples/serving_torch.py            (on the CUDA card)
     python examples/serving_torch.py --cpu      (the plain PyTorch versions)
     python examples/serving_torch.py --trace DIR  (also a Chrome trace)

The same stream as examples/serving.py, on ``parasail_rs_tpu_torch``.
"""

import argparse
import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from parasail_rs_tpu_torch.engine import Aligner, StreamingAligner
from parasail_rs_tpu_torch.matrices import Matrix
from parasail_rs_tpu_torch.utils import profiling


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("--trace", metavar="DIR",
                    help="capture a Chrome trace of the stream under DIR")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    rng = np.random.default_rng(0)
    blosum = Matrix.from_name("blosum62")
    aligner = (Aligner.new().matrix(blosum).gap_open(11).gap_extend(1)
               .local().device(device).build())
    alpha = list(b"ARNDCQEGHILKMFPSTWYV")

    def draw():
        return rng.choice(alpha, size=rng.integers(50, 250)).astype(
            "uint8").tobytes()

    pairs = [(draw(), draw()) for _ in range(5000)]
    with (profiling.capture(args.trace) if args.trace
          else contextlib.nullcontext()):
        with StreamingAligner(aligner, flush_size=1024) as stream:
            # kernels launch as buckets fill, here or in result()
            handles = [stream.submit(q, r) for q, r in pairs]
            stream.flush()
            scores = [h.result().get_score() for h in handles]
    print(f"aligned {len(scores)} pairs on {device}; mean score "
          f"{np.mean(scores):.1f}; routes {dict(aligner.route_counter)}")
    if args.trace:
        print(f"trace: {profiling.trace_files(args.trace)[-1]}")

    # Batched CIGAR extraction: one native walk over a whole trace batch.
    tr = (Aligner.new().matrix(blosum).gap_open(11).gap_extend(1)
          .semi_global().use_trace().device(device).build())
    qs = [rng.choice(alpha, size=60).astype("uint8").tobytes()
          for _ in range(256)]
    rs = [rng.choice(alpha, size=60).astype("uint8").tobytes()
          for _ in range(256)]
    cigars = tr.cigars(tr.align_batch(qs, rs), qs, rs)
    print(f"first CIGAR: {cigars[0][:40]}")


if __name__ == "__main__":
    main()
