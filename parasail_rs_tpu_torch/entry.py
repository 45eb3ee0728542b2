"""Entry points for a quick check of the port: one forward step, and a dry
run of the ``dist`` layer over several processes.

    python -m parasail_rs_tpu_torch.entry N [--cpu]

The port of ``__graft_entry__.py``.  :func:`entry` is the flagship
forward step, on the same shapes and seed as the reference's.
:func:`dryrun_multichip` starts N processes that join one
``torch.distributed`` group and check the data-parallel and
sequence-parallel paths against golden: NCCL with a card a process (the
default), or gloo on the CPU with ``device="cpu"``, as the reference's dry
run runs on virtual CPU devices.  A host with fewer cards than processes
raises; nothing moves to the CPU unasked.
"""

from __future__ import annotations

import functools
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from .engine.aligner import resolve_device
from .ops.scan_kernel import score_align


def _forward(profile, qidx, ridx, qlen, rlen, **kw) -> dict:
    return score_align(ridx, qlen, rlen, profile=profile, qidx=qidx, **kw)


def entry(device="cuda"):
    """(fn, args): the flagship forward step and its inputs on ``device``.

    The batched affine-gap SW scorer on the reference entry's shapes and
    seed (``__graft_entry__.entry``): 32 pairs, Qp = Rp = 64, a numpy
    seed-0 (32, 64, 24) profile in [-4, 12), lengths 60, SW 11/1, every
    end free, width sat.  ``fn(*args)`` runs ``score_align``: on the card
    the short form's score class, on the CPU its plain version.
    """
    B, Qp, Rp, A = 32, 64, 64, 24
    rng = np.random.default_rng(0)
    profile = rng.integers(-4, 12, size=(B, Qp, A)).astype(np.int32)
    qidx = rng.integers(0, A, size=(B, Qp)).astype(np.int32)
    ridx = rng.integers(0, A, size=(B, Rp)).astype(np.int32)
    qlen = np.full(B, 60, np.int32)
    rlen = np.full(B, 60, np.int32)
    dev = resolve_device(device)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in (profile, qidx, ridx, qlen, rlen))
    fn = functools.partial(_forward, open_=11, ext=1, mode="sw",
                           free=(True,) * 4, outputs="score", width="sat")
    return fn, args


def _check(name, got, want) -> None:
    if got != want:
        raise AssertionError(f"{name}: {got} != golden {want}")


def _worker(addr: str, world: int, rank: int, device: str) -> None:
    """One process of the dry run (rank ``rank`` of ``world``)."""
    import torch.distributed as td

    from . import dist
    from .dist import multihost
    from .dist.sharded import gather_scores
    from .engine.profile import profile_rows
    from .golden import model as golden
    from .matrices import Matrix

    dev = f"cuda:{rank}" if device == "cuda" else "cpu"
    multihost.initialize(addr, world, rank, device=dev)
    mesh = multihost.global_mesh()
    m = Matrix.from_name("blosum62")
    rng = np.random.default_rng(1)          # the same pairs on every rank
    alpha = list(b"ARNDCQEGHILKMFPSTWYV")
    B, Qp, Rp = 4 * world, 32, 32 * world
    profile = np.zeros((B, Qp, m.size), np.int32)
    qidx = np.full((B, Qp), -1, np.int32)
    ridx = np.zeros((B, Rp), np.int32)
    qlen, rlen = np.zeros(B, np.int32), np.zeros(B, np.int32)
    pairs = []
    for b in range(B):
        q = rng.choice(alpha, size=rng.integers(4, Qp + 1)).astype(
            "uint8").tobytes()
        r = rng.choice(alpha, size=rng.integers(4, Rp + 1)).astype(
            "uint8").tobytes()
        pairs.append((q, r))
        qi, ri = m.encode(q), m.encode(r)
        profile[b, :len(qi)] = profile_rows(m, qi)
        qidx[b, :len(qi)] = qi
        ridx[b, :len(ri)] = ri
        qlen[b], rlen[b] = len(qi), len(ri)
    arrays = (profile, qidx, ridx, qlen, rlen)
    sl = slice(rank * 4, rank * 4 + 4)      # this rank's pairs

    def golden_pair(b, open_, ext, mode):
        return golden.align_seqs(*pairs[b], m, open_, ext, mode)

    def check(name, out, open_, ext, mode, outputs):
        for b, (q, r) in enumerate(pairs):
            g = golden_pair(b, open_, ext, mode)
            _check(f"{name} pair {b}", (int(out["score"][b]),
                                        int(out["end_query"][b]),
                                        int(out["end_ref"][b])),
                   (g.score, g.end_query, g.end_ref))
            if outputs == "stats":
                _check(f"{name} pair {b} stats",
                       tuple(int(out[k][b]) for k in ("matches", "similar",
                                                      "length")),
                       (g.matches, g.similar, g.length))
            ql, rl = len(q), len(r)
            if outputs == "trace":
                plane = np.asarray(out["trace_table"][b])[:ql, :rl]
                if not np.array_equal(plane, g.trace_table):
                    raise AssertionError(f"{name} pair {b}: trace flags")
            if outputs == "rowcol":
                _check(f"{name} pair {b} row",
                       np.asarray(out["score_row"][b])[:rl].tolist(),
                       g.score_row.tolist())
                _check(f"{name} pair {b} column",
                       np.asarray(out["score_col"][b])[:ql].tolist(),
                       g.score_col.tolist())

    # data parallelism: the whole batch split over the ranks, and each
    # rank's own slice gathered, in the score, stats, trace and rowcol
    # classes; stats also at open <= ext
    for outputs, (open_, ext) in (("score", (11, 1)), ("stats", (11, 1)),
                                  ("trace", (11, 1)), ("rowcol", (11, 1)),
                                  ("stats", (1, 3)), ("stats", (2, 2))):
        kw = dict(open_=open_, ext=ext, mode="sw", free=(True,) * 4,
                  outputs=outputs, device=dev)
        whole = gather_scores(dist.sharded_align(mesh, *arrays, **kw))
        check(f"sharded_align {outputs} {open_}/{ext}", whole, open_, ext,
              "sw", outputs)
        mine = multihost.align_global(mesh, *(a[sl] for a in arrays), **kw)
        check(f"align_global {outputs} {open_}/{ext}", mine, open_, ext,
              "sw", outputs)

    # sequence parallelism: rank d owns the columns [32 d, 32 d + 32) of
    # every pair; two row chunks, the halo sent and received for each
    for mode, outputs, (open_, ext) in (("sw", "score", (11, 1)),
                                        ("sg", "stats", (1, 3)),
                                        ("nw", "trace", (2, 2))):
        out = dist.seqpar_align_scan(
            profile, ridx, qlen, rlen, qidx, open_=open_, ext=ext,
            mesh=mesh, mode=mode, free=golden.free_flags(mode), q_chunk=16,
            outputs=outputs, device=dev)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        check(f"seqpar_align_scan {mode} {outputs}", out, open_, ext, mode,
              outputs)
    td.destroy_process_group()
    print(f"rank {rank} OK", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = 600.0) -> None:
    """Start ``n_devices`` processes, one group, and check in each the
    data-parallel path (``sharded_align`` and ``align_global`` in the
    score, stats, trace and rowcol classes; stats also at open <= ext)
    and the sequence-parallel path (``seqpar_align_scan`` in the score,
    stats and trace classes, with halo ``send`` / ``recv`` between the
    ranks) against golden.

    ``device="cuda"`` (the default) puts a card on each process and joins
    them over NCCL; with fewer cards than processes it raises.
    ``device="cpu"`` joins them over gloo on the CPU.  Each process has
    ``timeout`` seconds; a failure raises with its output.
    """
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices {n_devices}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device == "cuda" and cards < n:
        raise RuntimeError(
            f"dryrun_multichip({n}) on 'cuda' needs {n} CUDA devices, this "
            f"host has {cards}; pass device='cpu' to run it over gloo on "
            "the CPU")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "2")
    addr = f"localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "parasail_rs_tpu_torch.entry", "--worker",
         addr, str(n), str(rank), device], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env, cwd=root, text=True)
        for rank in range(n)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"rank {rank} OK" not in out:
            raise RuntimeError(f"dry run rank {rank} failed "
                               f"({p.returncode}):\n{out[-4000:]}")
    print(f"dryrun_multichip OK: {n} process(es) over "
          f"{'nccl' if device == 'cuda' else 'gloo'}: sharded_align and "
          "align_global (score, stats, trace, rowcol; stats at 11/1, 1/3, "
          "2/2) and seqpar_align_scan (score, stats, trace), verified "
          "against golden", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        addr, world, rank, device = argv[1:5]
        _worker(addr, int(world), int(rank), device)
        return 0
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo processes on the CPU instead of NCCL on cards")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, "cpu" if args.cpu else "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
