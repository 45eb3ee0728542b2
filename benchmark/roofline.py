"""The least time one H100 could take for a window's alignments.

Work is counted from the traffic alone, so it reads the same whatever
implements it.

Operations.  The fewest integer operations the affine-gap recurrence
needs a cell, with every add-then-max that Hopper's DPX instructions
fuse (``__viaddmax_s16x2`` and kin) counted once and a three-way max
(``__vimax3_s16x2``) counted once:

- ``H - open``, shared by the next row's E and the next column's F: 1;
- ``E = max(E - extend, H_up - open)``: 1 fused add-max;
- ``F = max(F - extend, H_left - open)``: 1 fused add-max;
- ``H = max(H_diag + s, E, F[, 0])``: 1 fused add-max and 1 max (a
  three-way max with 0 when local);
- local alignment keeps its running best: 1 max.

So 5 a cell global (``nw``) and 6 local (``sw``).  The substitution
score is a table read, not an operation.  A CIGAR adds one operation a
traceback step, at least ``max(len(q), len(r))`` for a global pair and
counted 0 for a local one, whose path the traffic does not fix.
Computing trace flags is not counted: it is an implementation's choice.

Bytes.  Each sequence byte read once (a shared query once a call), each
result written once: score and two ends (12 bytes), and a CIGAR's ops
(one byte a traceback step).  No trace plane.

Peaks (NVIDIA H100 SXM5): 64 int32 instructions an SM a clock × 132
SMs × 1.98 GHz = 16.73 T/s, times 2 for DPX's 16×2 forms, which every
cell here could use (each score fits 16 bits); HBM3 3.35 TB/s.  The
least time is the larger of operations over the rate and bytes over the
bandwidth.
"""

from __future__ import annotations

import numpy as np

INT_OPS_PER_S = 64 * 132 * 1.98e9
DPX_LANES = 2
HBM_BYTES_PER_S = 3.35e12

OPS_PER_CELL = {"nw": 5, "sw": 6}
RESULT_BYTES = 12


def count(req, mode: str, cigar: bool) -> tuple[float, float]:
    """(operations, bytes) of one request's alignments."""
    qlens = np.broadcast_to(np.asarray(req.qlens, np.int64), req.rlens.shape)
    rlens = np.asarray(req.rlens, np.int64)
    cells = float(np.sum(qlens * rlens))
    ops = cells * OPS_PER_CELL[mode]
    nbytes = float(rlens.sum())
    nbytes += (float(req.qlens) if req.queries is None
               else float(qlens.sum()))
    nbytes += RESULT_BYTES * len(rlens)
    if cigar and mode == "nw":
        steps = float(np.maximum(qlens, rlens).sum())
        ops += steps
        nbytes += steps
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / (INT_OPS_PER_S * DPX_LANES), nbytes / HBM_BYTES_PER_S)
