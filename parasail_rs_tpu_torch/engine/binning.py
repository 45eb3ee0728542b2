"""The length bins of a batch, planned over whole index arrays.

The reference's ``batch.plan_bins`` buckets every pair's two lengths in
a Python loop, ``utils.shapes.length_bucket`` twice a pair, each a walk
up the ladder of 16, 24, 32, 48, ...; on a database search that loop
held the card idle longer than any other host stage.  :func:`plan_bins`
returns the same bins, list for list, from numpy: each length's bucket
is a ``searchsorted`` over the ladder's rungs, the groups come from one
stable sort of a combined key, and only the bins themselves are Python
objects.  A profile's query length is taken once, not once a pair.

:func:`_shape_bins` is every binned call's plan: the reference's merged
bins under the caller's caps, the cap of a trace plane that stays on a
card sized by its memory (:func:`_plane_cells`); :func:`split_bins` cuts
walked bins into launches of a bounded number of pairs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..batch import Bin, merge_bins
from ..utils.shapes import length_bucket


@functools.lru_cache(maxsize=None)
def _ladder(bits: int) -> np.ndarray:
    """``length_bucket``'s rungs from 16 up to the first at or past
    2**bits (read-only: every caller shares it)."""
    rungs = [length_bucket(0)]
    while rungs[-1] < 1 << bits:
        rungs.append(length_bucket(rungs[-1] + 1))
    out = np.array(rungs, np.int64)
    out.setflags(write=False)
    return out


def lengths(seqs) -> np.ndarray:
    """The sequences' lengths as int64, without a Python list between."""
    return np.fromiter(map(len, seqs), np.int64, len(seqs))


def _rung_of(lens: np.ndarray, ladder: np.ndarray) -> np.ndarray:
    """Index into ``ladder`` of each length's bucket: its first rung at or
    above the length (a length of 16 or less takes rung 0, 16)."""
    return np.searchsorted(ladder, lens, side="left")


def plan_bins(qlens, rlens, *, max_cells: int = 1 << 28,
              lane_quantum: int = 1) -> list[Bin]:
    """``batch.plan_bins``' bins, equal to them list for list.

    Args:
      qlens: the pairs' query lengths, or one int: the length every pair's
        query has (a profile).
      rlens: the pairs' reference lengths.
      max_cells, lane_quantum: as ``batch.plan_bins``.

    Groups run in the order of their first pair (the reference's dict
    order), each group's indices ascending; a group splits into launches
    of ``max(lane_quantum, max(1, max_cells // (qp * rp)))`` pairs, and
    the bins sort stably by (-qp * rp, -len(indices)).
    """
    rl = np.asarray(rlens, np.int64).reshape(-1)
    n = len(rl)
    if n == 0:
        return []
    one_q = isinstance(qlens, (int, np.integer))
    ql = np.asarray(qlens, np.int64).reshape(-1)
    longest = max(int(ql.max()), int(rl.max()), 0)
    ladder = _ladder(longest.bit_length())
    rr = _rung_of(rl, ladder)
    if one_q:
        qr = int(_rung_of(ql, ladder)[0])
        key = rr
    else:
        qr = _rung_of(ql, ladder)
        key = qr * len(ladder) + rr
    # keys stay under 2^14 (a ladder to 2^62 has 117 rungs): a 16-bit key
    # takes numpy's radix sort, a sixth of the 64-bit merge sort's time
    order = np.argsort(key.astype(np.int16), kind="stable")
    skey = key[order]
    starts = np.flatnonzero(np.r_[True, skey[1:] != skey[:-1]])
    # groups in the order of their first pair: a group's first index is
    # its least, the first in its stretch of the stable sort
    firsts = order[starts]
    rps = ladder[rr[firsts]].tolist()
    qps = ([int(ladder[qr])] * len(rps) if one_q
           else ladder[qr[firsts]].tolist())
    members = order.tolist()
    bounds = starts.tolist() + [n]
    bins: list[Bin] = []
    for g in np.argsort(firsts).tolist():
        qp, rp, end = qps[g], rps[g], bounds[g + 1]
        per_launch = max(lane_quantum, max(1, max_cells // (qp * rp)))
        for off in range(bounds[g], end, per_launch):
            bins.append(Bin(qp=qp, rp=rp, indices=members[
                off:min(off + per_launch, end)]))
    bins.sort(key=lambda b: (-b.qp * b.rp, -len(b.indices)))
    return bins


def _plane_cells(device) -> int:
    """The cell cap of a launch whose trace plane, a byte a cell, stays
    on ``device``: a quarter of a CUDA device's total memory (a property
    of the device, so every call plans alike; the rest holds the walk's
    opcode rows, the allocator's slack and the caller's tensors), never
    below the reference's 2^28; the reference's 2^28 on the CPU, whose
    plane is host memory, and where ``device`` is None (the plane
    crosses to the host).  The reference's cap was chosen for a TPU
    v5e's 16 GB: on an 80 GB card it held one 10 kbp pair a launch."""
    if device is None or device.type != "cuda":
        return 1 << 28
    return max(1 << 28,
               torch.cuda.get_device_properties(device).total_memory // 4)


def _shape_bins(qlens, rlens, cell_sized: bool, max_cells=None, *,
                plane_on=None):
    """The reference's length bins (``parasail_rs_tpu.batch``), planned
    over index arrays (:func:`plan_bins`; ``qlens`` is one int where
    every query has that length, a profile's): for the classes with
    cell-sized planes (trace, table), at most 2^28 cells a launch in 16
    launches; for the rest 2^33 cells in groups of 128 pairs, in 8
    launches.  ``plane_on`` is the device a cell-sized trace plane stays
    on, its walk running there and fetching only opcodes
    (``align_cigars``, ``ssw_batch``); its cap is then
    :func:`_plane_cells`' (a quarter of a card's memory).  None, the
    default, is a plane that crosses to the host, under the reference's
    cap.  ``max_cells`` overrides the cell cap."""
    if max_cells is None:
        max_cells = _plane_cells(plane_on) if cell_sized else (1 << 33)
    return merge_bins(
        plan_bins(qlens, rlens, max_cells=max_cells,
                  lane_quantum=1 if cell_sized else 128),
        max_launches=16 if cell_sized else 8, max_cells=max_cells)


def split_bins(bins: list[Bin], most: int) -> list[Bin]:
    """``bins`` in launches of at most ``most`` pairs: each bin's indices
    cut in order, its pieces where it stood."""
    return [Bin(qp=b.qp, rp=b.rp, indices=b.indices[i:i + most])
            for b in bins for i in range(0, len(b.indices), most)]
