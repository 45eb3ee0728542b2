"""The PyTorch port's ``dist`` layer: data-parallel batches and
sequence-parallel long pairs.

Run: python examples/distributed_torch.py          (on the CUDA card)
     python examples/distributed_torch.py --cpu    (the plain versions)
     python examples/distributed_torch.py --cpu --processes 2
         (and the dry run: two gloo processes, every class checked)

The paths of examples/distributed.py on ``parasail_rs_tpu_torch``.  In one
process the shards of a mesh are virtual (one device runs them all);
``--processes N`` also runs ``entry.dryrun_multichip(N)``, the same paths
over a ``torch.distributed`` group of N processes (NCCL with a card each,
or gloo with ``--cpu``) checked against golden.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from parasail_rs_tpu_torch import entry
from parasail_rs_tpu_torch.dist import (make_device_mesh, seqpar_align_scan,
                                        seqpar_cigars, sharded_align)
from parasail_rs_tpu_torch.dist.sharded import gather_scores
from parasail_rs_tpu_torch.engine.profile import profile_rows
from parasail_rs_tpu_torch.matrices import Matrix


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("--processes", type=int, default=0,
                    help="also run the dry run over this many processes")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"
    m = Matrix.default()
    rng = np.random.default_rng(1)
    n = 4                                  # virtual shards
    mesh = make_device_mesh(n)

    # Data-parallel: a batch of 8 pairs a shard (one process: the whole
    # batch through the engine's dispatch)
    B, L = 8 * n, 64
    qs = [rng.choice(list(b"ACGT"), size=L).astype("uint8").tobytes()
          for _ in range(B)]
    rs = [rng.choice(list(b"ACGT"), size=L).astype("uint8").tobytes()
          for _ in range(B)]
    prof = np.zeros((B, L, m.size), np.int32)
    qidx = np.full((B, L), -1, np.int32)
    ridx = np.zeros((B, L), np.int32)
    for b, (q, r) in enumerate(zip(qs, rs)):
        prof[b] = profile_rows(m, m.encode(q))
        qidx[b], ridx[b] = m.encode(q), m.encode(r)
    lens = np.full(B, L, np.int32)
    out = sharded_align(mesh, prof, qidx, ridx, lens, lens, open_=5, ext=2,
                        mode="sw", free=(True,) * 4, outputs="stats",
                        device=device)
    print(f"data-parallel ({out.route}):",
          gather_scores(out)["score"][:8], "...")

    # Sequence-parallel: ONE long pair, its reference columns in n shards
    # and its query in chunks of 32 rows, one tile a (chunk, shard)
    Lp = 64 * n
    q = rng.choice(list(b"ACGT"), size=Lp - 5).astype("uint8").tobytes()
    r = rng.choice(list(b"ACGT"), size=Lp - 3).astype("uint8").tobytes()
    prof1 = np.zeros((1, Lp, m.size), np.int32)
    prof1[0, :len(q)] = profile_rows(m, m.encode(q))
    ridx1 = np.zeros((1, Lp), np.int32)
    ridx1[0, :len(r)] = m.encode(r)
    qlen = np.array([len(q)], np.int32)
    rlen = np.array([len(r)], np.int32)
    sp = seqpar_align_scan(prof1, ridx1, qlen, rlen, open_=5, ext=2,
                           mesh=mesh, mode="sw", free=(True,) * 4,
                           q_chunk=32, device=device)
    print("sequence-parallel long-pair score:", int(sp["score"][0]))

    # The same pair with the trace class: each shard's flags, one plane,
    # then the walk on the host
    tr = seqpar_align_scan(prof1, ridx1, qlen, rlen, open_=5, ext=2,
                           mesh=mesh, mode="sw", free=(True,) * 4,
                           q_chunk=32, outputs="trace", device=device)
    cigar = seqpar_cigars(tr, [q], [r], "sw", (True,) * 4)[0]
    print("sequence-parallel CIGAR (first 60 chars):", cigar[:60])
    assert int(tr["score"][0]) == int(sp["score"][0])

    if args.processes:
        entry.dryrun_multichip(args.processes, device)


if __name__ == "__main__":
    main()
