"""Data-parallel alignment over a process group.

The port of ``parasail_rs_tpu.dist.sharded``.  The reference shards a
pair batch over a device mesh under ``shard_map``; here every rank of a
``torch.distributed`` group takes a contiguous slice of the batch, packs
it as a :class:`~..engine.dispatch.PairBatch` and runs the engine's own
:func:`~..engine.dispatch.execute` on it, so every output class and the
segment route for long pairs come with it, and the per-pair outputs are
all-gathered (:func:`gather_scores`).  With no group, or a group of one
rank, it is ``execute`` on the whole batch.

What the reference's version has and this one does not, each for the
reason ROADMAP.md gives under "Not ported": padding the batch to ``ndev x
128`` lanes (sharded.py:175-186; the kernels take any B, odd batches
split unevenly), the int8 score gate (:73), the ``WAVEFRONT_TPU_MAX_SPAN``
gate (:67) and ``PT_FORCE_PALLAS`` (:69, :86).  Its ``trace_walk`` route
(:61-72, :103-122: stats at gap_open <= gap_extend through the trace
kernel and the walk's stats mode, ``ops/trace_walk.py::device_walk_stats``)
has no counterpart either: the port's stats kernels carry golden's
payloads literally and serve every penalty pair in one pass, so nothing
in the port calls a stats mode of the walk, and none is ported.
"""

from __future__ import annotations

import types
from dataclasses import dataclass

import numpy as np
import torch

from ..engine import dispatch
from ..engine.aligner import resolve_device


@dataclass(frozen=True)
class DeviceMesh:
    """``size`` shards and, optionally, the ``torch.distributed`` process
    group whose ranks are the shards.  With no group the shards are
    virtual: one process runs them all on one device."""

    size: int
    group: object | None = None

    @property
    def world(self) -> int:
        """Ranks of the group; 1 with no group."""
        if self.group is None:
            return 1
        import torch.distributed as td

        return td.get_world_size(self.group)

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as td

        return td.get_rank(self.group)


def make_device_mesh(n_devices: int | None = None, group=None) -> DeviceMesh:
    """A 1-D mesh of ``n_devices`` shards (default: the group's ranks, or
    1), over ``group`` if one is given.  A group of more than one rank
    must have exactly ``n_devices`` ranks."""
    mesh = DeviceMesh(1, group)
    n = mesh.world if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices {n_devices}")
    if mesh.world > 1 and n != mesh.world:
        raise ValueError(f"a mesh of {n} shards over a group of "
                         f"{mesh.world} ranks")
    return DeviceMesh(n, group)


def plan_sharded_route(*, outputs: str, gap_open: int, gap_extend: int,
                       score_values=None, Qp: int, Rp: int, shard_batch: int,
                       device=None) -> str:
    """The route a shard of ``shard_batch`` pairs padded to (Qp, Rp)
    takes: what the engine's :func:`~..engine.dispatch.plan_route` picks
    for it, ``cuda_kernel`` / ``cuda_segments`` / ``cuda_chunked`` on a
    card, ``torch_plain`` / ``torch_segments`` / ``torch_chunked`` on the
    CPU.  ``score_values`` is accepted for the
    reference's signature: no route depends on the scores' range
    (the reference's int8 gate, sharded.py:73), nor on the penalties (its
    ``trace_walk`` route, :61-72; see the module docstring)."""
    dev = resolve_device("cuda" if device is None else device)
    shard = types.SimpleNamespace(device=dev, qp=int(Qp), rp=int(Rp),
                                  size=int(shard_batch))
    return dispatch.plan_route(shard, outputs, gap_open, gap_extend)[0]


class ShardedResult(dict):
    """One rank's outputs (host numpy arrays by name), with the mesh they
    were computed over and the route they took."""

    mesh: DeviceMesh | None = None
    route: str = ""


def _bounds(B: int, parts: int) -> list[int]:
    """Contiguous near-even split of B pairs: part k is
    [bounds[k], bounds[k + 1])."""
    base, extra = divmod(B, parts)
    out = [0]
    for k in range(parts):
        out.append(out[-1] + base + (k < extra))
    return out


def run_local(profile, qidx, ridx, qlen, rlen, *, open_, ext, mode, free,
              outputs, width, route, device) -> ShardedResult:
    """This process's pairs through the engine's dispatch, on ``device``.
    ``route`` is ``"auto"`` or the route the shape must take (else
    ValueError: the device and the shape pick the route, the caller
    cannot force another)."""
    dev = resolve_device("cuda" if device is None else device)

    def tensor(a):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=torch.int32).contiguous()
        return dispatch.upload(np.asarray(a, np.int32), dev)

    batch = dispatch.PairBatch(
        profile=tensor(profile), qidx=tensor(qidx), ridx=tensor(ridx),
        qlen=dispatch._np(qlen), rlen=dispatch._np(rlen), device=dev)
    planned = dispatch.plan_route(batch, outputs, int(open_), int(ext))[0]
    if route not in ("auto", planned):
        raise ValueError(f"route {route!r}: this batch on {dev} takes "
                         f"{planned!r}")
    res = ShardedResult(dispatch.execute(
        batch, gap_open=int(open_), gap_extend=int(ext), mode=mode,
        free=tuple(bool(x) for x in free), outputs=outputs, width=width))
    res.route = planned
    return res


def sharded_align(mesh: DeviceMesh, profile, qidx, ridx, qlen, rlen, *,
                  open_, ext, mode, free, outputs, width="32", route="auto",
                  device=None) -> ShardedResult:
    """Align a batch with its pairs split over ``mesh``'s ranks.

    ``profile`` (B or 1, Qp, A), ``qidx`` (B or 1, Qp), ``ridx`` (B, Rp),
    ``qlen`` / ``rlen`` (B,): the WHOLE batch, the same on every rank
    (numpy arrays or tensors).  Rank r aligns pairs
    [bounds[r], bounds[r + 1]) of a near-even contiguous split; a
    ``profile`` / ``qidx`` with a leading 1 (one query against many
    references) is shared, not split.  Returns this rank's outputs, host
    numpy arrays as :func:`~..engine.dispatch.execute` gives them, with
    ``.route``; :func:`gather_scores` makes them whole again.  ``device``
    None means the card.
    """
    ridx_n = ridx if isinstance(ridx, torch.Tensor) else np.asarray(ridx)
    B = ridx_n.shape[0]
    lo, hi = 0, B
    if mesh.world > 1:
        bounds = _bounds(B, mesh.world)
        lo, hi = bounds[mesh.rank], bounds[mesh.rank + 1]

    def part(a):
        return a if a is None or a.shape[0] == 1 else a[lo:hi]

    res = run_local(part(profile), part(qidx), ridx_n[lo:hi], qlen[lo:hi],
                    rlen[lo:hi], open_=open_, ext=ext, mode=mode, free=free,
                    outputs=outputs, width=width, route=route, device=device)
    res.mesh = mesh
    return res


def gather_scores(out: dict, mesh: DeviceMesh | None = None) -> dict:
    """Every rank's per-pair outputs, concatenated in rank order, as host
    numpy arrays on every rank (``all_gather_object`` over the mesh's
    group; a mesh of one rank returns ``out``'s arrays as they are)."""
    mesh = mesh if mesh is not None else getattr(out, "mesh", None)
    host = {k: dispatch._np(v) for k, v in out.items()}
    if mesh is None or mesh.world == 1:
        return host
    import torch.distributed as td

    parts = [None] * mesh.world
    td.all_gather_object(parts, host, group=mesh.group)
    return {k: np.concatenate([p[k] for p in parts]) for k in host}
