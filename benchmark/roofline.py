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

So 5 a cell global (``nw``) and semi-global (``sg``), and 6 local
(``sw``).  A semi-global alignment searches its free ends: 1 max a
cell of the last row with a free query end (``qe``), and of the last
column with a free reference end (``de``).  The substitution score is a
table read, not an operation.  A CIGAR adds one operation a traceback
step, at least ``max(len(q), len(r))`` for a global pair and counted 0
for a semi-global or local one, whose path the traffic does not fix.
Computing trace flags is not counted: it is an implementation's choice.

Cells.  Every cell of the ``len(q) × len(r)`` matrix, or with a band
(``bandwidth``, global only) the cells with ``|i - j| <= bandwidth``:
those a banded kernel computes (``cells``).

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

from .reference.sweep import bandwidth, free_ends

INT_OPS_PER_S = 64 * 132 * 1.98e9
DPX_LANES = 2
HBM_BYTES_PER_S = 3.35e12

OPS_PER_CELL = {"nw": 5, "sg": 5, "sw": 6}
RESULT_BYTES = 12


def _lens(req):
    qlens = np.broadcast_to(np.asarray(req.qlens, np.int64), req.rlens.shape)
    return qlens, np.asarray(req.rlens, np.int64)


def _left_of(x, n):
    """``sum(clip(t, 0, n) for t < x)``, elementwise."""
    a = np.clip(x - 1, 0, n)
    return a * (a + 1) // 2 + n * np.maximum(x - 1 - n, 0)


def _at_most(m, n, k):
    """Cells ``(i, j)`` of an ``m × n`` matrix with ``j - i <= k``: row
    ``i`` holds ``clip(i + k + 1, 0, n)`` of them."""
    return _left_of(k + 1 + m, n) - _left_of(k + 1, n)


def band_cells(m, n, bw: int):
    """Cells ``(i, j)`` of each ``m × n`` matrix with ``|i - j| <= bw``."""
    return _at_most(m, n, bw) - _at_most(m, n, -bw - 1)


def cells(req, scoring: dict) -> int:
    """The DP cells the request's alignments compute: ``req.cells()``,
    or with a band the in-band cells."""
    bw = bandwidth(scoring)
    if bw is None:
        return req.cells()
    return int(np.sum(band_cells(*_lens(req), bw)))


def count(req, scoring: dict, cigar: bool) -> tuple[float, float]:
    """(operations, bytes) of one request's alignments."""
    mode = scoring["mode"]
    qlens, rlens = _lens(req)
    ops = float(cells(req, scoring)) * OPS_PER_CELL[mode]
    if mode == "sg":
        _, qe, _, de = free_ends(scoring)
        ops += float(qe * rlens.sum() + de * qlens.sum())
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
