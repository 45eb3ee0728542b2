"""The sequence-parallel fill in plain PyTorch, and the walk of its trace.

The port of ``parasail_rs_tpu.dist.seqpar``.  The reference's module is
the XLA twin of its Pallas route; here :func:`seqpar_align` is the same
pipeline as :func:`~.seqpar_scan.seqpar_align_scan` with the tile
kernel's plain version (:func:`~..ops.scan_kernel.score_rowseg_plain`,
the wavefront with a left boundary, a top boundary and a row offset) on
every device, cards included.  It takes the reference's transposed layout
so that the reference's tests carry over.  The reference's refusal of
stats at gap_open <= gap_extend (seqpar.py:98-104) has no counterpart:
the wavefront carries golden's payloads at every penalty pair.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import scan_kernel as sk
from .seqpar_scan import seqpar_align_scan


def _batch_major(a, perm):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.permute(*perm)
    return np.transpose(np.asarray(a), perm)


def seqpar_align(profile, ridx, qlen, rlen, qidx=None, *, open_, ext, mesh,
                 mode: str, free=(False,) * 4, q_chunk: int = 256,
                 outputs: str = "score", width: str = "32",
                 device=None) -> dict:
    """Score (+ stats / trace) and end coordinates of pairs cut into
    column shards, in plain PyTorch.

    ``profile`` (Qp, A, B), ``ridx`` (Rp, B), ``qidx`` (Qp, B) (required
    for ``outputs="stats"``), ``qlen`` / ``rlen`` (B,): the reference's
    layout.  Otherwise :func:`~.seqpar_scan.seqpar_align_scan`'s contract
    and outputs (``trace_table`` is (B, Qp, Rp))."""
    return seqpar_align_scan(
        _batch_major(profile, (2, 0, 1)), _batch_major(ridx, (1, 0)), qlen,
        rlen, _batch_major(qidx, (1, 0)), open_=open_, ext=ext, mesh=mesh,
        mode=mode, free=free, q_chunk=q_chunk, outputs=outputs, width=width,
        device=device, _tile_fn=sk.score_rowseg_plain)


def seqpar_cigars(out, queries, references, mode,
                  free=(False,) * 4) -> list[str]:
    """Host traceback over a sequence-parallel trace result -> CIGAR
    strings.

    ``out`` is a ``seqpar_align*(..., outputs="trace")`` result; the
    gathered flag plane is walked in ONE native batch
    (native/ptwalk.cc, the walk ``Aligner.cigars`` uses; golden's walk
    when there is no compiler), so the strings are those of the one-device
    path.
    """
    from ..constants import cigar_runs_string
    from ..golden.model import free_flags, walk_trace
    from ..native import walker

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    trace = host(out["trace_table"])
    eq, er, scores = (host(out[k]) for k in ("end_query", "end_ref", "score"))
    live = [b for b in range(len(queries))
            if mode != "sw" or scores[b] > 0]
    ff = free if mode == "sg" else free_flags(mode)
    qb, _, db, _ = ff
    walked = walker.walk_batch(
        [trace[b, :len(queries[b]), :len(references[b])] for b in live],
        [queries[b] for b in live], [references[b] for b in live],
        [int(eq[b]) for b in live], [int(er[b]) for b in live],
        local=mode == "sw", qb=qb, db=db) if live else []
    cigars = [""] * len(queries)
    if walked is not None:
        for k, b in enumerate(live):
            cigars[b] = cigar_runs_string(walked[k][0])
        return cigars
    for b in live:
        q, r = queries[b], references[b]
        walk = walk_trace(trace[b, :len(q), :len(r)], q, r,
                          int(eq[b]), int(er[b]), mode, free)
        cigars[b] = walk.cigar_string()
    return cigars
