"""Sequence-parallel fill over the tile kernel.

The port of ``parasail_rs_tpu.dist.seqpar_scan``.  The reference axis of
a batch of long pairs is cut into D contiguous column shards, the query
axis into S chunks of ``q_chunk`` rows, and every (row chunk x column
shard) tile is one :func:`~..ops.scan_kernel.score_rowseg` call: on a
card one launch of the tile kernel (``csrc/scan_rowseg.cu``), on the CPU
its plain version.  Two state flows, as in the reference
(seqpar_scan.py:3-17):

- rightward, shard d to shard d + 1: the tile's last H / F column, the
  corner words and the stats payloads;
- downward, on the same shard: H and E of the tile's last row per column
  (the reference carries a prefix-max seed where the port carries E; see
  ``csrc/score_cell.cuh``, "the tile form").

Shard d runs chunk t at superstep t + d.  With a process group of D
ranks (``mesh.group``), rank d owns shard d, runs its S tiles in order,
receives each tile's left state from rank d - 1 and sends its right state
to rank d + 1 (``torch.distributed`` ``recv`` / ``isend``: NCCL between
GPUs, gloo on the CPU), and the accumulators and trace shards are
all-gathered at the end.  The reference's idle tiles, which exist there
because ``shard_map`` runs one traced program on every device, have no
counterpart.  With no group, or a group of one rank, the D shards are
virtual: one process runs all S x D tiles in superstep order on one
device and hands tensors over instead of messages.  Both forms run the
same tile function and the same final merge.

One card shows that this path is correct, not that it scales.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.aligner import resolve_device
from ..ops import scan_kernel as sk

# a shard's (batch, Qp, Rp / D) int8 flags beyond this decline the trace
# class (the reference's bound, seqpar_scan.py:80-83)
TRACE_SHARD_BYTES = 4 << 30


def seqpar_scan_fits(q_chunk: int, Rp: int, n_devices: int, outputs: str,
                     A: int, Qp: int | None = None, batch: int = 1,
                     gap_open: int | None = None,
                     gap_extend: int | None = None) -> bool:
    """Can :func:`seqpar_align_scan` serve this configuration?

    The shape gates of the reference's ``seqpar_scan_fits``: the output
    class, ``Rp`` divisible by the shards, ``Qp`` (if given) by
    ``q_chunk``, and for the trace class a shard's flags within
    :data:`TRACE_SHARD_BYTES`.  ``A``, ``gap_open`` and ``gap_extend`` are
    accepted for the reference's signature and gate nothing:
    """
    # no A > 32 gate (seqpar_scan.py:73): the table sits in shared or
    # global memory as int32, any alphabet
    # no q_chunk % 8 gate (:75): a tile's rows need not fill a sublane
    # no stats gate at gap_open <= gap_extend (:77-79): the stats cell
    # follows golden's ties at every penalty pair
    # no rowseg_plan gate (:84): a tile needs no on-chip memory plan
    if outputs not in sk.SEGMENT_OUTPUTS:
        return False
    if q_chunk < 1 or n_devices < 1 or Rp < n_devices or Rp % n_devices:
        return False
    if Qp is not None and Qp % q_chunk:
        return False
    if outputs == "trace" and Qp is not None:
        if batch * Qp * (Rp // n_devices) > TRACE_SHARD_BYTES:
            return False
    return True


def _tensor(a, device):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32).contiguous()
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a), np.int32)).to(device)


_HALO = ("h", "f", "stats", "t")


def _pack_halo(state):
    """A tile's right-going state as one int32 message."""
    return torch.cat([state[k].reshape(-1) for k in _HALO if k in state])


def _unpack_halo(buf, B, qc, stats):
    shapes = {"h": (B, qc), "f": (B, qc), "t": (B, 4)}
    if stats:
        shapes["stats"] = (6, B, qc)
    out, at = {}, 0
    for k in _HALO:
        if k in shapes:
            n = int(np.prod(shapes[k]))
            out[k] = buf[at:at + n].reshape(shapes[k]).contiguous()
            at += n
    return out


def pipeline(tile_fn, ridx, qlen, rlen, *, mesh, q_chunk, subs, kw):
    """Run the S x D tiles of a sequence-parallel fill through
    ``tile_fn`` (:func:`~..ops.scan_kernel.score_rowseg` or its plain
    version) and return ``(acc, trace)``: the merged (B, 8) accumulator
    and, for the trace class, the (B, Qp, Rp) int8 plane (else None), on
    ``ridx``'s device.  ``subs`` are the substitution keywords over the
    whole padded query, ``kw`` the alignment's (open_, ext, mode, free,
    width, outputs)."""
    dev = ridx.device
    B, Rp = ridx.shape
    Qp = (subs["qidx"] if subs.get("profile") is None
          else subs["profile"]).shape[1]
    D, qc = mesh.size, int(q_chunk)
    if Rp % D or Qp % qc:
        raise ValueError(f"Rp = {Rp} must divide by the {D} shards and "
                         f"Qp = {Qp} by q_chunk = {qc}")
    C, S = Rp // D, Qp // qc
    outputs = kw["outputs"]
    stats, trace = outputs == "stats", outputs == "trace"
    bkw = dict(open_=kw["open_"], ext=kw["ext"], mode=kw["mode"],
               free=kw["free"], outputs=outputs, device=dev)

    def shard(d):
        return ridx[:, d * C:(d + 1) * C].contiguous()

    def run(d, t, cols, halo, acc, down):
        """Tile (shard d, chunk t); returns (right state, acc, down, tile)."""
        if d == 0:
            halo = sk.rowseg_left_border(B, t * qc, qc, **bkw)
        if t == 0:
            down = sk.rowseg_top_border(B, d * C, C, **bkw)
        _, new, down, tile = tile_fn(
            cols, qlen, rlen, dict(halo, acc=acc), down, row_offset=t * qc,
            q_chunk=qc, col_offset=d * C, **kw, **subs)
        acc = new.pop("acc")
        return new, acc, down, tile

    def keep(buf, t, tile):  # a tile's flags into its shard's (B, Qp, C)
        if trace:
            buf[:, t * qc:(t + 1) * qc] = tile

    def flags(cols):
        return torch.empty((B, Qp, cols), dtype=torch.int8, device=dev)

    plane = None
    if mesh.world > 1:
        import torch.distributed as td

        d, group = mesh.rank, mesh.group
        ranks = td.get_process_group_ranks(group)
        cols = shard(d)
        acc, down, sent = sk.acc_init(B, Qp, kw["mode"], dev), None, []
        mine = flags(C) if trace else None
        words = (2 + (6 if stats else 0)) * B * qc + 4 * B
        for t in range(S):
            halo = None
            if d > 0:
                buf = torch.empty(words, dtype=torch.int32, device=dev)
                td.recv(buf, src=ranks[d - 1], group=group)
                halo = _unpack_halo(buf, B, qc, stats)
            new, acc, down, tile = run(d, t, cols, halo, acc, down)
            if d < D - 1:
                msg = _pack_halo(new)
                # the message must outlive the send
                sent.append((td.isend(msg, dst=ranks[d + 1], group=group),
                             msg))
            keep(mine, t, tile)
        for req, _ in sent:
            req.wait()
        accs = [torch.empty_like(acc) for _ in range(D)]
        td.all_gather(accs, acc, group=group)
        if trace:
            planes = [torch.empty_like(mine) for _ in range(D)]
            td.all_gather(planes, mine, group=group)
            plane = torch.cat(planes, dim=2)
    else:
        cols = [shard(d) for d in range(D)]
        accs = [sk.acc_init(B, Qp, kw["mode"], dev) for _ in range(D)]
        downs, halos = [None] * D, [None] * (D + 1)
        # the shards' flags side by side: one plane, no copy at the end
        plane = flags(Rp) if trace else None
        for s in range(S + D - 1):
            # right to left: a shard reads the halo its left neighbour
            # made one superstep earlier before that neighbour makes the
            # next one
            for d in range(min(D - 1, s), -1, -1):
                t = s - d
                if t >= S:
                    break
                halos[d + 1], accs[d], downs[d], tile = run(
                    d, t, cols[d], halos[d], accs[d], downs[d])
                keep(plane[:, :, d * C:(d + 1) * C] if trace else None, t,
                     tile)
    acc = accs[0]
    for other in accs[1:]:
        acc = sk.merge_acc(acc, other)
    return acc, plane


def seqpar_align_scan(profile, ridx, qlen, rlen, qidx=None, *, open_, ext,
                      mesh, mode: str, free=(False,) * 4, q_chunk: int = 256,
                      outputs: str = "score", width: str = "32", device=None,
                      table=None, _tile_fn=None) -> dict:
    """Sequence-parallel alignment of a batch of long pairs through the
    tile kernel.

    ``profile`` (B or 1, Qp, A) substitution rows, or ``table`` (A, A)
    with ``qidx`` (B or 1, Qp) letters; ``ridx`` (B, Rp), ``qlen`` /
    ``rlen`` (B,); ``qidx`` is required for ``outputs="stats"``: numpy
    arrays or tensors, int32.  ``mesh`` is :func:`~.sharded.
    make_device_mesh`'s; ``Rp`` must divide by its shards and ``Qp`` by
    ``q_chunk`` (:func:`seqpar_scan_fits`).  ``device`` None means the
    card; every rank of a group passes the same whole inputs and gets the
    same whole result.

    Returns tensors on the device: ``score``, ``end_query``, ``end_ref``,
    ``saturated`` (+ ``promoted`` at width ``sat``), for the stats class
    ``matches`` / ``similar`` / ``length``, for the trace class
    ``trace_table`` (B, Qp, Rp) int8.  Bit for bit what one sweep over
    the whole pairs gives, at every penalty pair and alphabet: the
    reference's advice to fall back to another implementation outside its
    kernel's envelope has no counterpart, and a CUDA device runs the
    kernel or raises.
    """
    if outputs not in sk.SEGMENT_OUTPUTS:
        raise ValueError(f"outputs {outputs!r}: the sequence-parallel fill "
                         f"serves {sk.SEGMENT_OUTPUTS}")
    if outputs == "stats" and qidx is None:
        raise ValueError("outputs='stats' needs the mapped query indices "
                         "(qidx): matches are counted against them")
    dev = resolve_device("cuda" if device is None else device)
    ridx, qlen, rlen = (_tensor(x, dev) for x in (ridx, qlen, rlen))
    if table is not None:
        subs = {"table": _tensor(table, dev), "qidx": _tensor(qidx, dev)}
        if subs["qidx"] is None:
            raise ValueError("the table form needs qidx")
        Qp, A = subs["qidx"].shape[1], subs["table"].shape[0]
    else:
        subs = {"profile": _tensor(profile, dev)}
        if outputs == "stats":
            subs["qidx"] = _tensor(qidx, dev)
        Qp, A = subs["profile"].shape[1:]
    B, Rp = ridx.shape
    if not seqpar_scan_fits(q_chunk, Rp, mesh.size, outputs, A, Qp=Qp,
                            batch=B):
        raise ValueError(
            f"the sequence-parallel fill cannot serve (q_chunk={q_chunk}, "
            f"Qp={Qp}, Rp={Rp}, D={mesh.size}, {outputs}, batch={B})")
    kw = dict(open_=int(open_), ext=int(ext), mode=mode,
              free=tuple(bool(x) for x in free), width=width,
              outputs=outputs)
    acc, plane = pipeline(_tile_fn or sk.score_rowseg, ridx, qlen, rlen,
                          mesh=mesh, q_chunk=q_chunk, subs=subs, kw=kw)
    out = sk.acc_outputs(acc, qlen, rlen, Qp, **kw)
    if plane is not None:
        out["trace_table"] = plane
    return out
