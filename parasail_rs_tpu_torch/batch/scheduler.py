"""Length-binning batch scheduler.

The reference processes one pair per call and leaves batching to user
threads (SURVEY.md §2.3).  On TPU the cost model inverts: every kernel
launch processes a dense (B, Qp, Rp) tile, so mixed-length workloads
(BASELINE.json config 5: 100bp-10kbp) must be binned by padded shape —
padding a 100bp pair into a 10kbp tile wastes 99.99% of the lanes.

``plan_bins`` groups pair indices by their (query, reference) length
buckets (utils.shapes.length_bucket ladder: <= ~33% padding waste) and
splits oversized groups so one launch never exceeds ``max_cells`` DP
cells — bounding both device memory and launch latency.  Bins are
emitted largest-bucket-first so the big compilations happen before the
many small launches.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.shapes import length_bucket


@dataclass
class Bin:
    """One kernel launch: pairs sharing a padded (Qp, Rp) tile."""

    qp: int
    rp: int
    indices: list[int]


def plan_bins(
    qlens,
    rlens,
    *,
    max_cells: int = 1 << 28,
    lane_quantum: int = 1,
) -> list[Bin]:
    """Group pair indices into shape bins.

    Args:
      qlens, rlens: per-pair sequence lengths.
      max_cells: cap on B*Qp*Rp per launch (device memory / latency bound).
      lane_quantum: round bin sizes up to this multiple where possible by
        merging (the Pallas kernel wants multiples of 128 lanes; smaller
        remainders still dispatch, padded by the engine).

    Returns bins covering every index exactly once.
    """
    groups: dict[tuple[int, int], list[int]] = {}
    for i, (ql, rl) in enumerate(zip(qlens, rlens)):
        key = (length_bucket(int(ql)), length_bucket(int(rl)))
        groups.setdefault(key, []).append(i)

    bins: list[Bin] = []
    for (qp, rp), idxs in groups.items():
        per_launch = max(lane_quantum, max(1, max_cells // (qp * rp)))
        for off in range(0, len(idxs), per_launch):
            bins.append(Bin(qp=qp, rp=rp, indices=idxs[off:off + per_launch]))
    bins.sort(key=lambda b: (-b.qp * b.rp, -len(b.indices)))
    return bins


def merge_bins(bins: list[Bin], *, max_launches: int,
               max_cells: int = 1 << 28) -> list[Bin]:
    """Greedily merge bins until at most ``max_launches`` remain.

    A mixed-length workload can hit dozens of (qbucket, rbucket)
    combinations — one kernel launch each, at a per-launch cost (host
    dispatch + channel latency) that dwarfs the kernel time of a
    nearly-empty bin.  Merging bins trades padded DP cells (a merged
    bin runs at the elementwise max of the two shapes) for launches;
    each step picks the pair with the smallest added padded-cell cost,
    honoring ``max_cells``.

    Exactness is unaffected: the engine masks padded lanes/columns, so
    a pair computes identically in any bin whose tile covers it.
    """
    if len(bins) <= max_launches:
        return bins
    # Vectorized greedy: each step evaluates every candidate pair with
    # numpy outer ops instead of a Python double loop.  The pure-Python
    # scan (with len*qp*rp recomputed through dataclass attribute
    # access) cost ~170 ms of HOST time per 256-pair mixed batch — more
    # than the kernels it was scheduling (cfg5 probe, 2026-08-20).
    import numpy as np

    qs = np.array([b.qp for b in bins], np.int64)
    rs = np.array([b.rp for b in bins], np.int64)
    ns = np.array([len(b.indices) for b in bins], np.int64)
    idxs = [list(b.indices) for b in bins]
    while len(qs) > max_launches:
        qp2 = np.maximum.outer(qs, qs)
        rp2 = np.maximum.outer(rs, rs)
        merged = (ns[:, None] + ns[None, :]) * qp2 * rp2
        cel = ns * qs * rs
        extra = merged - cel[:, None] - cel[None, :]
        bad = (merged > max_cells) | np.tri(len(qs), dtype=bool)
        extra[bad] = np.iinfo(np.int64).max
        k = int(extra.argmin())
        i, j = divmod(k, len(qs))
        if bad[i, j]:
            break  # nothing merges under max_cells
        qs[i], rs[i], ns[i] = qp2[i, j], rp2[i, j], ns[i] + ns[j]
        idxs[i] = idxs[i] + idxs[j]
        keep = np.arange(len(qs)) != j
        qs, rs, ns = qs[keep], rs[keep], ns[keep]
        idxs.pop(j)
    bins = [Bin(qp=int(q), rp=int(r), indices=ix)
            for q, r, ix in zip(qs, rs, idxs)]
    bins.sort(key=lambda b: (-b.qp * b.rp, -len(b.indices)))
    return bins
