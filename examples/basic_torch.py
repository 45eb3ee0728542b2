"""Basic usage of the PyTorch port: one-off alignments, traceback, and
batches.

Run: python examples/basic_torch.py          (on the CUDA card)
     python examples/basic_torch.py --cpu    (the plain PyTorch versions)

The same calls as examples/basic.py, on ``parasail_rs_tpu_torch``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from parasail_rs_tpu_torch.prelude import Aligner, Matrix, Profile


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    device = "cpu" if ap.parse_args().cpu else "cuda"

    # One-off local alignment with traceback
    aligner = (Aligner.new().local().use_trace().gap_open(5).gap_extend(2)
               .device(device).build())
    q, r = b"TTTACGTTT", b"GGGACGGGG"
    res = aligner.align(q, r)
    print("score:", res.get_score(), " cigar:", res.get_cigar(q, r))
    res.print_traceback(q, r)

    # Profile reuse: one query against many references, one kernel launch
    matrix = Matrix.from_name("blosum62")
    profile = Profile.new(b"HEAGAWGHEE", True, matrix)
    pa = (Aligner.new().profile(profile).use_stats().gap_open(11)
          .gap_extend(1).local().device(device).build())
    refs = [b"PAWHEAE", b"AWGHEE"]
    for ref, res in zip(refs, pa.align_batch(None, refs)):
        print(ref, "->", res.get_score(), "matches:", res.get_matches())

    # CIGARs with the device walk: the flag plane stays on the device, one
    # copy of scalars and opcodes per chunk
    sw = (Aligner.new().matrix(matrix).gap_open(11).gap_extend(1).local()
          .device(device).build())
    alns, cigars = sw.align_cigars([b"HEAGAWGHEE", b"PAWHEAE"],
                                   [b"PAWHEAE", b"HEAGAWGHEE"])
    for a, c in zip(alns, cigars):
        print("score:", a.get_score(), " cigar:", c)
    print("routes:", dict(sw.route_counter))


if __name__ == "__main__":
    main()
