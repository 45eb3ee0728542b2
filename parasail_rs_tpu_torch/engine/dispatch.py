"""Host-side batch assembly and kernel dispatch, on torch tensors.

The port of ``parasail_rs_tpu.engine.dispatch`` for every output class of
``align`` / ``align_batch``: pack a batch of byte sequences into padded
uint8 planes (the reference's native packer), upload them once to the
aligner's device, map bytes to letter indices there, run
:func:`~parasail_rs_tpu_torch.ops.scan_kernel.score_align` over the whole
batch, and fetch the per-pair scalars in one pinned, non-blocking
transfer (:class:`PendingResult`) and each plane (trace, table, row,
column) in one copy of its own.  ``banded=True`` with ``bandwidth`` runs
the banded mode (kernel K1e) in any class and mode; ``Aligner.banded_nw``
runs its NW score form.  :func:`submit` is every batch's launch: it
returns a :class:`PendingResult` without waiting for the card where only
per-pair scalars (or a walk's opcodes) come back, so a caller packs and
launches every bin before the first fetch; :func:`execute` is
``submit(...).fetch()[0]``.  ``submit(walk=True)`` runs the trace class
in one launch and walks its plane on the card
(:func:`~parasail_rs_tpu_torch.ops.trace_walk.device_walk`): only the
scalars, the begins and the opcode rows leave it.

Routes: ``"cuda_kernel"`` for a batch on a CUDA device (the hand-written
one-shot kernel), ``"torch_plain"`` for a batch on the CPU (the plain
PyTorch version); and for long pairs ``"cuda_segments"`` /
``"torch_segments"``: :func:`execute_segments` runs the reference left to
right in segments through
:func:`~parasail_rs_tpu_torch.ops.scan_kernel.score_segment`, carrying
the sweep's state from launch to launch (the port of the reference's
``_execute_pallas_streamed``); and ``"cuda_chunked"`` /
``"torch_chunked"``: one launch of
:func:`~parasail_rs_tpu_torch.ops.scan_kernel.score_chunked` (a block of
warps per pair over all of its columns, every output class) for long
pairs that need one launch or whose class has no segment form.
:func:`plan_route` says which.  On the card the block kernel's score
class (on those two routes, and on the one-shot route past the short
form) runs packed (two pairs a lane on 16x2 DPX, :func:`packed_units`)
wherever the penalties and scores leave it a 16-bit band;
:class:`PendingResult` recomputes, at fetch, every pair the packed form
flagged, through the int32 form.  There is no
fallback between routes and no CPU route for a batch that was asked to
run on a card: a failure raises.  Every decision is tallied in
:data:`ROUTE_COUNTS` and reported to the caller.
"""

from __future__ import annotations

import contextlib
import logging
from collections import Counter

import numpy as np
import torch

from ..utils import profiling, stages
from ..utils.gcpause import gc_pause
from ..utils.shapes import length_bucket

from ..ops.scan_kernel import (OUTPUTS, SEGMENT_OUTPUTS, band_cells,
                               band_form, band_swept, packed_usable,
                               pair_units, score_align, score_chunked,
                               score_segment, short_plan)
from ..ops.wavefront import STATS_CLASSES, STATS_KEYS

log = logging.getLogger("parasail_rs_tpu_torch")

# Tally of routing decisions in this process, keyed (route, reason).
# Per-aligner tallies live on Aligner.route_counter.
ROUTE_COUNTS: Counter = Counter()
# Pairs of this process that the packed form flagged and a fetch computed
# again through the int32 form (PendingResult), and the batches they came
# in: whatever the spans, so that a check can account for the launches.
RERUN16 = Counter()


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def encode(mapper: torch.Tensor, bytes2d: torch.Tensor, lens: torch.Tensor,
           fill: int) -> torch.Tensor:
    """uint8 sequence bytes -> int32 letter indices, ``fill`` beyond each
    row's length (the reference's ``_device_encode``)."""
    mask = (torch.arange(bytes2d.shape[1], device=bytes2d.device)[None, :]
            < lens[:, None])
    idx = mapper[bytes2d.long()]
    return torch.where(mask, idx, torch.full_like(idx, fill))


class PairBatch:
    """Padded tensors for a batch of pairs, on one device.

    ``table`` (A, A) is set for square matrices and ``profile``
    (1 or B, Qp, A) otherwise.  Batches from :func:`pack_pairs` carry the
    uint8 ``qbytes`` / ``rbytes`` planes and the byte ``mapper``; ``qidx``
    (fill -1) and ``ridx`` (fill 0) encode from them on first use, on the
    device.  ``qlen`` / ``rlen`` are host int32 arrays; ``qlen_t`` /
    ``rlen_t`` their device copies.  ``query`` is a shared profile's
    query bytes, which the device walk compares (host bytes, not
    uploaded unless a walk asks).  ``score_bound`` is the largest |score|
    of the table or profile, from the host's matrix (None: read off the
    card on first use).
    """

    def __init__(self, profile, qidx, ridx, qlen, rlen, table=None,
                 qbytes=None, rbytes=None, mapper=None, query=None, *,
                 device, score_bound=None):
        self.device = torch.device(device)
        self.profile = profile
        self._qidx = qidx
        self._ridx = ridx
        self.qlen = np.asarray(qlen, np.int32)
        self.rlen = np.asarray(rlen, np.int32)
        # pinned and non-blocking: a pageable copy would wait for the
        # work already queued, and chunks of one call could not overlap
        self.qlen_t = upload(self.qlen, self.device)
        self.rlen_t = upload(self.rlen, self.device)
        self.table = table
        self.qbytes = qbytes
        self.rbytes = rbytes
        self.mapper = mapper
        self.query = query
        self._score_bound = score_bound

    @property
    def score_bound(self) -> int:
        if self._score_bound is None:
            v = self.score_values
            self._score_bound = int(v.abs().max()) if v.numel() else 0
        return self._score_bound

    @property
    def qidx(self) -> torch.Tensor:
        if self._qidx is None:
            self._qidx = encode(self.mapper, self.qbytes, self.qlen_t, -1)
        return self._qidx

    @property
    def ridx(self) -> torch.Tensor:
        if self._ridx is None:
            self._ridx = encode(self.mapper, self.rbytes, self.rlen_t, 0)
        return self._ridx

    @property
    def score_values(self) -> torch.Tensor:
        return self.table if self.table is not None else self.profile

    @property
    def size(self) -> int:
        return len(self.rlen)

    @property
    def qp(self) -> int:
        """Padded query length."""
        if self.profile is not None:
            return int(self.profile.shape[1])
        q = self._qidx if self._qidx is not None else self.qbytes
        return int(q.shape[1])

    @property
    def rp(self) -> int:
        """Padded reference length."""
        r = self._ridx if self._ridx is not None else self.rbytes
        return int(r.shape[1])


def _pack_side(seqs, P):
    """Sequences -> (padded (B, P') uint8, (B,) int32 lens, P'), through
    the reference's native packer, with its numpy formulation where the
    packer cannot serve (no compiler, non-bytes items)."""
    from ..errors import InteriorNulByte
    from ..native import packer

    packed = packer.pack_side(seqs, P, length_bucket)
    if packed is None:
        seqs = [s.encode() if isinstance(s, str)
                else (s if type(s) is bytes else bytes(s)) for s in seqs]
        packed = packer.pack_side(seqs, P, length_bucket)
    if packed is not None:
        return packed
    B = len(seqs)
    joined = b"".join(seqs)
    if 0 in joined:
        raise InteriorNulByte("sequence contains an interior NUL byte")
    lens = np.fromiter((len(s) for s in seqs), np.int32, B)
    P = P or length_bucket(int(lens.max()) if B else 1)
    mask = np.arange(P)[None, :] < lens[:, None]
    padded = np.zeros((B, P), np.uint8)
    padded[mask] = np.frombuffer(joined, np.uint8)
    return padded, lens, P


def _pack_sides(sides, device):
    """Each side's sequences, ``(seqs, P)`` pairs, into one host buffer,
    side after side as contiguous (B, P') planes:
    ``[(device plane, lens, P')]``.  The native fill writes the buffer in
    place, a large side with streamed stores (``native/fill.py``),
    pinned for a card, where torch's host allocator hands the same block
    back call after call: fresh padded arrays and their concatenation
    each call (50 MB for 1,024 pairs of 10 kbp) made that batch's pack
    about 3x slower on an H100 machine's host (PERF.md §6).  On a card
    each side's plane starts its upload as soon as it is filled, while
    the next side fills.  A side the fill cannot serve packs through
    :func:`_pack_side` (the packer's fill, or its numpy formulation) and
    is copied in."""
    from ..errors import InteriorNulByte
    from ..native import fill, packer

    lib = packer._load()
    plans = []
    for seqs, P in sides:
        lens = np.empty(len(seqs), np.int32)
        mx = (lib.pt_pack_lens(seqs, len(seqs), lens.ctypes.data)
              if lib is not None and type(seqs) is list else -1)
        plans.append(_pack_side(seqs, P) if mx < 0 else
                     (None, lens, P or length_bucket(int(mx) if len(seqs)
                                                     else 1)))
    sizes = [len(lens) * P for _, lens, P in plans]
    card = device.type == "cuda"
    if card:
        host = torch.empty(sum(sizes), dtype=torch.uint8,
                           pin_memory=sum(sizes) > 0)
        flat = host.numpy()
        dev = torch.empty(sum(sizes), dtype=torch.uint8, device=device)
    else:
        flat = np.empty(sum(sizes), np.uint8)
        host = dev = torch.from_numpy(flat)
    out, off = [], 0
    for (seqs, _), (padded, lens, P), n in zip(sides, plans, sizes):
        plane = flat[off:off + n].reshape(len(lens), P)
        if padded is None:
            rc = fill.fill(seqs, P, plane)
            if rc == -2:
                raise InteriorNulByte("sequence contains an interior NUL "
                                      "byte")
            if rc != 0:             # no library, or a row past P
                padded = _pack_side(seqs, P)[0]
        if padded is not None:
            plane[...] = padded
        if card and n:
            dev[off:off + n].copy_(host[off:off + n], non_blocking=True)
        out.append((off, lens, P))
        off += n
    return [(dev[o:o + len(lens) * P].view(len(lens), P), lens, P)
            for o, lens, P in out]


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def pack_pairs(matrix, queries, references, profile=None, Qp=None, Rp=None,
               *, device):
    """Byte sequences -> :class:`PairBatch` on ``device``.

    ``profile`` set means profile reuse: the query tensors are stored
    once, (1, Qp).  Returns (batch, qlens list, rlens list).
    """
    B = len(references)
    with stages.stage("pack"), gc_pause(B):
        return _pack_pairs_inner(matrix, queries, references, profile,
                                 Qp, Rp, B, torch.device(device))


def _pack_pairs_inner(matrix, queries, references, profile, Qp, Rp, B,
                      device):
    if profile is None and len(queries) != B:
        raise ValueError("queries and references must have equal length")
    planes = _pack_sides([(references, Rp)] if profile is not None else
                         [(queries, Qp), (references, Rp)], device)
    rb_t, rlens, Rp = planes[-1]
    qb_t = None
    if profile is not None:
        ql = profile.query_len
        Qp = Qp or length_bucket(ql)
        A = profile.rows.shape[1]
        prof = np.zeros((1, Qp, A), np.int32)
        prof[0, :ql] = profile.rows
        qidx = np.full((1, Qp), -1, np.int32)
        qidx[0, :ql] = profile.qidx
        qlens = np.full(B, ql, np.int32)
    else:
        qb_t, qlens, Qp = planes[0]
        qidx = None
        if matrix.is_square:
            prof = None
        else:
            # PSSM rows are position-indexed: the same for every pair
            rows = np.take(matrix.data, np.arange(Qp) % matrix.length,
                           axis=0).astype(np.int32, copy=False)
            prof = np.ascontiguousarray(rows)[None]
    table = (np.ascontiguousarray(matrix.data, dtype=np.int32)
             if prof is None else None)
    batch = PairBatch(
        profile=None if prof is None else upload(prof, device),
        qidx=None if qidx is None else upload(qidx, device),
        ridx=None, qlen=qlens, rlen=rlens,
        table=None if table is None else upload(table, device),
        qbytes=qb_t, rbytes=rb_t,
        mapper=upload(np.asarray(matrix.mapper, np.int32), device),
        query=None if profile is None else profile.query, device=device,
        score_bound=max(abs(int(matrix.max)), abs(int(matrix.min))))
    return batch, np.asarray(qlens).tolist(), np.asarray(rlens).tolist()


INT32_SAFE = (1 << 31) - 1


def width64_risk(batch: PairBatch, gap_open: int,
                 gap_extend: int) -> np.ndarray:
    """Indices of pairs whose worst-case |H| could exceed int32.

    Per-pair bound: |H| <= (max|s| + open + ext) * (qlen + rlen).  A pair
    under the bound can never overflow int32, so only flagged pairs pay
    the exact int64 host fill (the reference's ``width64_risk``).
    """
    smax = int(batch.score_values.abs().max().item())
    per = smax + abs(int(gap_open)) + abs(int(gap_extend))
    bound = per * (batch.qlen.astype(np.int64) +
                   batch.rlen.astype(np.int64))
    return np.nonzero(bound > INT32_SAFE)[0]


def _golden64_merge(out: dict, batch: PairBatch, idx: np.ndarray, *,
                    gap_open, gap_extend, mode, free) -> dict:
    """Overwrite the int32 results of ``idx`` pairs with an exact int64
    scalar golden fill (the reference's ``_golden64_merge``, every class:
    scalar, stats, table, row and column outputs upcast to int64; trace
    flags stay int8, their encoding is width-free).  A pair with an empty
    side keeps zeros in its row and column, as the kernel leaves them
    (golden's own rows of an empty table raise)."""
    from ..golden import model as golden

    qidx_all = _np(batch.qidx)
    ridx_all = _np(batch.ridx)
    prof = None if batch.profile is None else _np(batch.profile)
    table = None if batch.table is None else _np(batch.table)
    out = {k: (np.array(v) if v.dtype == np.int8
               or k in ("saturated", "promoted")
               else v.astype(np.int64)) for k, v in out.items()}
    for b in idx.tolist():
        ql, rl = int(batch.qlen[b]), int(batch.rlen[b])
        qi = qidx_all[0 if qidx_all.shape[0] == 1 else b, :ql]
        ri = ridx_all[b, :rl]
        if table is not None:
            sub = table[qi[:, None], ri[None, :]].astype(np.int64)
        else:
            p = prof[0 if prof.shape[0] == 1 else b, :ql]
            sub = p[np.arange(ql)[:, None], ri[None, :]].astype(np.int64)
        g = golden.align(sub, qi[:, None] == ri[None, :],
                         int(gap_open), int(gap_extend), mode, free)
        out["score"][b] = g.score
        out["end_query"][b] = g.end_query
        out["end_ref"][b] = g.end_ref
        out["saturated"][b] = False     # an int64 fill cannot saturate
        for k in STATS_KEYS:
            if k in out:
                out[k][b] = getattr(g, k)
        for k in out:
            if k.endswith(("_table", "_row", "_col")):
                out[k][b] = 0
            if k.endswith("_table"):
                out[k][b, :ql, :rl] = getattr(g, k)
            elif ql and rl and k.endswith("_row"):
                out[k][b, :rl] = getattr(g, k)
            elif ql and rl and k.endswith("_col"):
                out[k][b, :ql] = getattr(g, k)
    return out


# Reference columns per launch of the segment kernel, by class.  On this
# card a segment costs one launch and, per group of up to 256 query rows,
# a few hundred steps of pipeline fill, so segments are as long as their
# scratch allows: the kernel keeps one row of H and E (stats: and six
# payload rows) of Rseg columns per pair, 8 or 32 bytes a column, which at
# 128 pairs stays inside the 50 MB L2 up to these sizes.  The trace class also
# holds two (B, Qp, Rseg) flag buffers on the card and two pinned ones on
# the host, so its segments are shorter.
SEGMENT_COLS = {"score": 8192, "stats": 4096, "trace": 1024}

# Score and stats batches take the segment route from this many padded
# cells a pair (Qp * Rp).  The one-shot kernel put one thread on a pair
# when this was set, and the segment kernel up to eight warps; PERF.md has
# both kernels' times on 128 pairs of 1,024 and 4,096 bp (2.0 against 239
# ms, 22.5 ms against 3.8 s) and the segment kernel's at 16,384 bp, on an
# NVIDIA H100 80GB HBM3, 700 W: the segment kernel was ahead wherever both
# ran, so the threshold is the smallest size measured.
SEGMENT_MIN_CELLS = 1 << 20

# A trace batch whose (B, Qp, Rp) int8 plane is larger than this streams
# in segments: the one-shot route holds the whole plane on the card and
# fetches it with one blocking copy, the segment route holds two
# segment-sized buffers and copies one out while the next one runs.
TRACE_ONE_SHOT_BYTES = 1 << 30
# ... and beyond this the assembled host plane is out of reason: the
# batch raises (the reference's bound).
TRACE_HOST_BYTES = 4 << 30

# A query longer than this is long whatever the reference length: the
# padded length past which the reference holds the query in row chunks
# (its _plan, parasail_rs_tpu/ops/scan_kernel.py:106-194), and the tall,
# narrow batches (3,072 x 96) where one thread per pair sweeps thousands
# of rows alone.
CHUNK_ROWS = 2048

SEGMENT_ROUTES = ("cuda_segments", "torch_segments")
CHUNKED_ROUTES = ("cuda_chunked", "torch_chunked")


def plan_route(batch: PairBatch, outputs: str, gap_open: int,
               gap_extend: int, *, one_shot: bool = False,
               banded: bool = False) -> tuple[str, str]:
    """("cuda_kernel" | "cuda_segments" | "cuda_chunked" | "torch_plain"
    | "torch_segments" | "torch_chunked", reason) for a batch.

    The device picks between the card's routes and the CPU's; the batch's
    padded shape and class pick between the one-shot kernels
    (:func:`~..ops.scan_kernel.score_align`, kernel K1: one warp a pair
    up to 256 padded query rows and the block kernel's one-shot form past
    them; banded, the score class a ring of row blocks on a group of
    lanes up to bw 140, and every other banded launch the masked full
    sweep on the same two forms), segments
    (:func:`execute_segments`, kernel K2) and the chunked sweep
    (:func:`~..ops.scan_kernel.score_chunked`, kernel K1f: K2's block of
    up to eight warps per pair, one launch over all columns, every
    class):

    - segments for the classes the segment kernel serves, unless the
      caller needs one launch: score and stats from
      :data:`SEGMENT_MIN_CELLS` padded cells a pair, trace when its flag
      plane exceeds :data:`TRACE_ONE_SHOT_BYTES`;
    - otherwise the chunked sweep for LONG pairs, ``Qp * Rp >=
      SEGMENT_MIN_CELLS`` or ``Qp >`` :data:`CHUNK_ROWS`: the one-launch
      callers (``align_cigars`` / ``ssw``, whose walk reads the whole
      plane on the card), ``use_trace()`` under the plane bound, score
      and stats of tall, narrow pairs, and the table, stats_table,
      rowcol and stats_rowcol classes, which have no segment form;
    - K1 for everything else and for every banded batch, of any class
      and mode (K1e).

    Why: on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6) K1 put one
    thread on a pair, 223-228 ns a cell, so 128 pairs of 4,096 bp took
    3.74-3.82 s in every class; K2's block took 22.5 ms (score), 33.6 ms
    (stats) and 41.3 ms (trace in four launches) on the same pairs, and
    2.0 ms against K1's 239 ms at 1,024 bp, the smallest size measured,
    which sets :data:`SEGMENT_MIN_CELLS`.  The chunked sweep is that block
    with the plane classes' stores: 12x to 242x ahead of K1's one thread a
    pair in every class
    at 128 × 1,024, 128 × 4,096 and 128 × 3,072 × 96 (PERF.md §6), so
    it takes K2's threshold and every query past :data:`CHUNK_ROWS`, the
    reference's chunk point.  These thresholds are not a crossover: below
    them it is still ahead in every class, 28x to 116x at 128 × 512 × 512
    (score 0.67 against 59.8 ms), 11x to 34x at 128 × 2,048 × 96 (score
    1.37 against 15.8 ms) and 3.0x on 8,192 pairs of 160 × 160 (score
    1.25 against 3.72 ms).  Short batches stay on K1 because their calls
    are host-bound (K1's 2.5 ms in 21-23 ms of ``align_batch`` on 8,192
    pairs), so moving them waits for end-to-end numbers (ROADMAP.md, "K2
    on short pairs"); no class of K1, banded or not, runs one thread a
    pair any more (``score_align`` picks the short form, one warp a pair,
    the ring, or the block kernel itself), so the one-thread times above
    are what set the thresholds, not what K1 costs now.  All on an NVIDIA H100 80GB HBM3 at
    700 W, from ``chip_smoke.py`` phases 5, 20 and 27.
    ``one_shot=True`` is for callers that need one launch; ``banded=True``
    for the banded mode, which only K1 serves, on "cuda_kernel" whatever
    the pairs' length (the ring sweeps the band alone; the short form and
    the block kernel sweep every cell, masked).

    ``gap_open`` / ``gap_extend`` are accepted for the reference's
    signature: every penalty pair is exact on every route.  The kernels'
    stats forms and the wavefront carry golden's payloads literally, so
    the stats classes need no counterpart of the reference's
    ``trace_walk`` / ``stream_walk`` routes, which it takes at gap_open <=
    gap_extend because its one-pass kernel, streamed or not, cannot: the
    segment kernel serves stats at every penalty pair.
    """
    if outputs not in OUTPUTS:
        raise ValueError(f"outputs {outputs!r}")
    kind = batch.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no route for device {batch.device}")
    cells = batch.qp * batch.rp
    if not one_shot and not banded and outputs in SEGMENT_OUTPUTS:
        segments = "cuda_segments" if kind == "cuda" else "torch_segments"
        if outputs == "trace":
            if batch.size * cells > TRACE_ONE_SHOT_BYTES:
                return segments, "trace plane beyond one launch"
        elif cells >= SEGMENT_MIN_CELLS:
            return segments, "long pairs"
    if not banded and (cells >= SEGMENT_MIN_CELLS or batch.qp > CHUNK_ROWS):
        return ("cuda_chunked" if kind == "cuda" else "torch_chunked",
                "long pairs, one launch")
    if kind == "cuda":
        return "cuda_kernel", ""
    return "torch_plain", "batch on the cpu"


def _tally(batch: PairBatch, route: str, reason: str, on_route) -> None:
    """Record a batch's route, once a batch on every path; count it as a
    bin, with its real and padded cells, while spans are on."""
    ROUTE_COUNTS[(route, reason)] += 1
    if on_route is not None:
        on_route(route, reason)
    if stages.enabled:
        stages.count("bins")
        stages.count("cells_real", int(np.dot(batch.qlen.astype(np.int64),
                                              batch.rlen.astype(np.int64))))
        stages.count("cells_padded", batch.size * batch.qp * batch.rp)


def _tally_band(batch: PairBatch, route: str, outputs: str,
                bandwidth: int) -> None:
    """Count a banded launch's in-band cells of its real lengths
    (``cells_band``) and the cells its schedule sweeps
    (``cells_band_swept``: the ring's lanes, or every padded cell of the
    masked full sweep and the plain version), from the host's lengths,
    while spans are on."""
    if not stages.enabled:
        return
    form = (0, 0)
    if route == "cuda_kernel" and outputs == "score":
        form = band_form(batch.size, batch.qp, batch.rp,
                         int(batch.score_values.shape[-1]), bandwidth,
                         batch.profile is not None)
    stages.count("cells_band", band_cells(batch.qlen, batch.rlen, bandwidth))
    stages.count("cells_band_swept",
                 band_swept(batch.qlen, batch.rlen, batch.qp, batch.rp,
                            bandwidth, form))


def _substitution(batch: PairBatch, outputs: str) -> dict:
    """The batch's substitution inputs as score_align's keywords."""
    if batch.table is not None:
        return {"table": batch.table, "qidx": batch.qidx}
    subs = {"profile": batch.profile}
    if outputs in STATS_CLASSES:
        subs["qidx"] = batch.qidx           # matches compares letters
    return subs


def packed_units(batch: PairBatch, route: str, outputs: str,
                 gap_open: int, gap_extend: int):
    """The packed form's units (``ops.scan_kernel.pair_units``, on the
    card) for a batch of the block kernel's score class on ``route``,
    or None where the int32 form runs it: what the route observes, not a
    setting.  The block kernel takes the score class on the card's
    segment and chunked routes, and on the one-shot route where the short
    form does not (``short_plan``: past 256 query rows); the packed form
    takes it there (never a tile, never the banded mode) where the
    penalties and the matrix's largest |score| leave a 16-bit band and
    the scores are a table or one query's profile.  While spans are on it
    counts the batch's pairs as ``score16_pairs`` or, on the int32 form,
    ``score32_pairs``."""
    if outputs != "score" or route not in ("cuda_segments", "cuda_chunked",
                                           "cuda_kernel"):
        return None
    if route == "cuda_kernel":
        v = batch.score_values
        Bq = (batch.profile if batch.table is None else batch.qidx).shape[0]
        if short_plan("score", batch.size, Bq, batch.qp, batch.rp,
                      int(v.shape[-1]), batch.table is None)[0]:
            return None
    usable = ((batch.table is not None or batch.profile.shape[0] == 1)
              and packed_usable(gap_open, gap_extend, batch.score_bound))
    stages.count("score16_pairs" if usable else "score32_pairs", batch.size)
    if not usable:
        return None
    return upload(pair_units(batch.qlen, batch.rlen), batch.device)


def launch(batch: PairBatch, *, gap_open: int, gap_extend: int, mode: str,
           free: tuple[bool, bool, bool, bool], outputs: str, width: str,
           on_route=None, banded: bool = False, bandwidth: int = 0,
           units=None) -> dict[str, torch.Tensor]:
    """Run the batch in one launch, of the one-shot kernel (K1) or, for
    long pairs, of the chunked sweep (:func:`plan_route` with
    ``one_shot=True``); return its outputs as tensors on the batch's
    device (``score_align``'s dict).  ``on_route(route, reason)`` is
    called with the routing decision; ``banded`` / ``bandwidth`` select
    the banded mode, which stays on K1's route ("cuda_kernel") at any
    length: ``score_align`` picks the ring for the score class within its
    reach, else the masked full sweep on the short form or, past 256
    query rows, on the block kernel.  ``units`` (:func:`packed_units`
    for this route): the block kernel's score class on the packed form,
    its outputs then with ``over16``, which :func:`submit` resolves."""
    with stages.stage("dispatch"):
        route, reason = plan_route(batch, outputs, gap_open, gap_extend,
                                   one_shot=True, banded=banded)
        _tally(batch, route, reason, on_route)
        if banded:
            _tally_band(batch, route, outputs, bandwidth)
        kw = dict(open_=gap_open, ext=gap_extend, mode=mode, free=free,
                  width=width, outputs=outputs,
                  **_substitution(batch, outputs))
        if units is not None:
            kw.update(units=units, bound=batch.score_bound)
        if route in CHUNKED_ROUTES or units is not None:
            # the block kernel over all columns: score_align's own block
            # form for the pairs the short form does not take
            return score_chunked(batch.ridx, batch.qlen_t, batch.rlen_t,
                                 **kw)
        return score_align(batch.ridx, batch.qlen_t, batch.rlen_t,
                           banded=banded, bandwidth=bandwidth, **kw)


def execute_segments(batch: PairBatch, *, gap_open: int, gap_extend: int,
                     mode: str, free: tuple[bool, bool, bool, bool],
                     outputs: str, width: str, units=None) -> dict:
    """Run the batch left to right in reference segments of
    :data:`SEGMENT_COLS` columns through the segment kernel (the port of
    the reference's ``_execute_pallas_streamed``).

    Every segment is enqueued without waiting for the one before: the
    state (H / F boundary column, stats payloads, accumulator) stays on
    the batch's device from launch to launch.  Returns the last
    segment's per-pair scalars as tensors on that device, so a caller
    can defer the fetch, and for the trace class ``trace_table``, the
    assembled (B, Qp, Rp) int8 plane as a host numpy array.

    The trace class's flags leave the card a segment at a time: each
    segment's (B, Qp, Rseg) buffer goes to pinned host memory by a
    non-blocking copy on a second stream while the next segment's kernel
    runs into the other buffer (a pageable copy would wait for the
    stream), and the host assembles the plane meanwhile.  A plane beyond
    :data:`TRACE_HOST_BYTES` raises.

    ``units`` (:func:`packed_units`): the score class's segments on the
    packed form, whose last outputs carry ``over16``.
    """
    if outputs not in SEGMENT_OUTPUTS:
        raise ValueError(f"outputs {outputs!r} has no segment form")
    B, Qp, Rp = batch.size, batch.qp, batch.rp
    trace = outputs == "trace"
    if trace and B * Qp * Rp > TRACE_HOST_BYTES:
        raise ValueError(
            f"a trace plane of {B} x {Qp} x {Rp} bytes exceeds the "
            f"{TRACE_HOST_BYTES} byte bound of the assembled host plane; "
            "split the batch, or use align_cigars / ssw for the alignment")
    seg = max(1, min(SEGMENT_COLS[outputs], Rp))
    nseg = max(1, -(-Rp // seg))
    on_card = batch.device.type == "cuda"
    with stages.stage("dispatch"):
        ridx = batch.ridx
        if nseg * seg != Rp:
            # padded columns lie beyond every rlen
            ridx = torch.nn.functional.pad(ridx, (0, nseg * seg - Rp))
        kw = dict(open_=gap_open, ext=gap_extend, mode=mode, free=free,
                  width=width, outputs=outputs,
                  **_substitution(batch, outputs))
        if units is not None:
            kw.update(units=units, bound=batch.score_bound)
        plane = np.empty((B, Qp, Rp), np.int8) if trace else None
        if trace and on_card:
            main = torch.cuda.current_stream(batch.device)
            side = torch.cuda.Stream(batch.device)
            bufs = [torch.empty((B, Qp, seg), dtype=torch.int8,
                                device=batch.device)
                    for _ in range(min(2, nseg))]
            pinned = [torch.empty((B, Qp, seg), dtype=torch.int8,
                                  pin_memory=True) for _ in bufs]
            copied = [None, None]

    def assemble(si, host, copied=None):
        if copied is not None:
            with stages.stage("fetch.wait"):
                copied.synchronize()
        with stages.stage("fetch.copy"):
            lo = si * seg
            hi = min(lo + seg, Rp)
            plane[:, :, lo:hi] = host[:, :, :hi - lo]

    state = out = None
    for si in range(nseg):
        k = si % 2
        with stages.stage("dispatch"):
            cols = ridx[:, si * seg:(si + 1) * seg]
            if nseg > 1:
                cols = cols.contiguous()
            out, state = score_segment(
                cols, batch.qlen_t, batch.rlen_t, state, col_offset=si * seg,
                resume=si > 0, trace_out=bufs[k] if trace and on_card
                else None, **kw)
        if not trace:
            continue
        seg_plane = out.pop("trace_table_seg")
        if not on_card:
            assemble(si, seg_plane.numpy())
            continue
        # buffer k was copied out (segment si - 2) before this launch: the
        # host waited for that copy when it assembled it
        with stages.stage("fetch.start"):
            done = torch.cuda.Event()
            done.record(main)
            side.wait_event(done)
            with torch.cuda.stream(side):
                pinned[k].copy_(seg_plane, non_blocking=True)
                copied[k] = torch.cuda.Event()
                copied[k].record(side)
        if si >= 1:
            assemble(si - 1, pinned[1 - k].numpy(), copied[1 - k])
    if trace and on_card:
        k = (nseg - 1) % 2
        assemble(nseg - 1, pinned[k].numpy(), copied[k])
    res = dict(out)
    if trace:
        res["trace_table"] = plane
    return res


def _run(batch: PairBatch, *, on_route, banded=False, bandwidth=0,
         **kw) -> dict:
    """Plan the route and enqueue the batch on it: :func:`launch`'s or
    :func:`execute_segments`'s dict, in a region named for the profiler
    as the reference names it.  The block kernel's score class runs
    packed where :func:`packed_units` gives it units (off the segment
    route the route planned here is :func:`launch`'s own)."""
    with profiling.trace_region(f"pt.execute.{kw['mode']}.{kw['outputs']}"):
        with stages.stage("dispatch"):
            route, reason = plan_route(batch, kw["outputs"], kw["gap_open"],
                                       kw["gap_extend"], banded=banded)
            segments = route in SEGMENT_ROUTES
            if segments:
                _tally(batch, route, reason, on_route)
            units = None if banded else packed_units(
                batch, route, kw["outputs"], kw["gap_open"],
                kw["gap_extend"])
        if segments:
            return execute_segments(batch, units=units, **kw)
        return launch(batch, on_route=on_route, banded=banded,
                      bandwidth=bandwidth, units=units, **kw)


def _sub_batch(batch: PairBatch, idx: np.ndarray) -> PairBatch:
    """Pairs ``idx`` of a batch, on its device, at its padded shape."""
    sel = upload(idx.astype(np.int64), batch.device)

    def rows(t):
        return t if t is None or t.shape[0] == 1 else t[sel]

    return PairBatch(rows(batch.profile),
                     None if batch.table is None else rows(batch.qidx),
                     batch.ridx[sel], batch.qlen[idx], batch.rlen[idx],
                     table=batch.table, device=batch.device,
                     score_bound=batch.score_bound)


def _rerun16(batch: PairBatch, *, gap_open, gap_extend, mode, free,
             width):
    """What :class:`PendingResult` calls with the pairs the packed form
    flagged (``over16``): those pairs, whole, launched on the int32 form
    on the batch's route, in this call; their :class:`PendingResult`."""
    def rerun(idx: np.ndarray) -> PendingResult:
        sub = _sub_batch(batch, idx)
        route, _ = plan_route(sub, "score", gap_open, gap_extend)
        kw = dict(mode=mode, free=free, outputs="score", width=width)
        with stages.stage("dispatch"):
            if route in SEGMENT_ROUTES:
                res = execute_segments(sub, gap_open=gap_open,
                                       gap_extend=gap_extend, **kw)
            else:
                res = score_chunked(sub.ridx, sub.qlen_t, sub.rlen_t,
                                    open_=gap_open, ext=gap_extend, **kw,
                                    **_substitution(sub, "score"))
        return PendingResult(res)
    return rerun


_BOOLS = ("saturated", "promoted")


class PendingResult:
    """Per-pair results on their way to the host: one int32 (B, K) block
    holding (B,) columns and, optionally, (B, L) uint8 rows packed four
    to a word.  On a card the block is copied into pinned host memory
    with ``non_blocking=True`` and a CUDA event marks the copy's end, so
    several can be in flight while the host works; :meth:`fetch` waits
    for the event and unpacks, once: a second fetch raises.  ``host``
    holds columns that are on the host already (a plane class's, or the
    int64 merge's); :meth:`fetch` adds them to the block's, and with no
    block gives them as they are.

    ``rerun`` (:func:`submit`, for the packed form's outputs): called at
    fetch with the indices of the pairs whose ``over16`` is set, where
    any is, it launches them on the int32 form, whose columns replace
    the packed form's; ``over16`` itself is dropped.  Where none is set
    the fetch adds no launch and no wait."""

    def __init__(self, cols: dict[str, torch.Tensor] | None = None,
                 rows: torch.Tensor | None = None,
                 host: dict[str, np.ndarray] | None = None, rerun=None):
        self._carried = host or {}
        self._fetched = False
        self._host = None
        self._rerun = rerun
        if not cols and rows is None:
            return
        with stages.stage("fetch.start"):
            self.names = sorted(cols)
            self.L = 0 if rows is None else int(rows.shape[1])
            parts = [torch.stack([cols[k].to(torch.int32) for k in self.names],
                                 dim=1)] if self.names else []
            if rows is not None:
                B, L = rows.shape
                words = torch.zeros((B, (L + 3) // 4 * 4), dtype=torch.uint8,
                                    device=rows.device)
                words[:, :L] = rows
                parts.append(words.view(torch.int32))
            block = torch.cat(parts, dim=1)
            self._event = None
            if block.device.type == "cuda":
                self._host = torch.empty(block.shape, dtype=torch.int32,
                                         pin_memory=True)
                self._host.copy_(block, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record(torch.cuda.current_stream(block.device))
            else:
                self._host = block

    def fetch(self, lock=None) -> tuple[dict[str, np.ndarray],
                                        np.ndarray | None]:
        """(host columns by name, host (B, L) uint8 rows or None).
        ``lock``: held while the rerun launches, by a thread that fetches
        what other threads launch under that lock (the stream's fetch
        thread); the wait for the rerun's copy is outside it."""
        if self._fetched:
            raise RuntimeError("this PendingResult was fetched already")
        self._fetched = True
        if self._host is None:
            return self._carried, None
        if self._event is not None:
            with stages.stage("fetch.wait"):
                self._event.synchronize()
        with stages.stage("fetch.copy"):
            host = self._host.numpy()
            self._host = None
            nn = len(self.names)
            scal = np.ascontiguousarray(host[:, :nn].T)
            out = {k: (scal[n] != 0 if k in _BOOLS else scal[n])
                   for n, k in enumerate(self.names)}
            out.update(self._carried)
            rows = (np.ascontiguousarray(host[:, nn:]).view(np.uint8)
                    [:, :self.L] if self.L else None)
        over = out.pop("over16", None)
        if over is not None and self._rerun is not None:
            idx = np.nonzero(over)[0]
            if len(idx):
                with lock if lock is not None else contextlib.nullcontext():
                    stages.count("score16_reruns", len(idx))
                    RERUN16.update(pairs=len(idx), batches=1)
                    again = self._rerun(idx)
                for k, v in again.fetch()[0].items():
                    out[k][idx] = v
        return out, rows


def _is_plane(key: str) -> bool:
    return key.endswith(("_table", "_row", "_col"))


def execute(batch: PairBatch, *, gap_open: int, gap_extend: int, mode: str,
            free: tuple[bool, bool, bool, bool], outputs: str, width: str,
            on_route=None, banded: bool = False,
            bandwidth: int = 0) -> dict[str, np.ndarray]:
    """Run the kernel over a batch; return host numpy results: the
    per-pair scalars and the class's planes (``trace_table`` int8,
    ``*_table`` (B, Qp, Rp), ``*_row`` (B, Rp) and ``*_col`` (B, Qp)
    int32).  :func:`submit`, fetched at once."""
    return submit(batch, gap_open=gap_open, gap_extend=gap_extend, mode=mode,
                  free=free, outputs=outputs, width=width, on_route=on_route,
                  banded=banded, bandwidth=bandwidth).fetch()[0]


SCALAR_CLASSES = ("score", "stats")


def submit(batch: PairBatch, *, gap_open: int, gap_extend: int, mode: str,
           free: tuple[bool, bool, bool, bool], outputs: str, width: str,
           on_route=None, banded: bool = False, bandwidth: int = 0,
           walk: bool = False) -> PendingResult:
    """Launch a batch without waiting where it can; its
    :class:`PendingResult` fetches the host results (the port of the
    reference's ``execute(fetch=False)`` + ``fetch_all``).

    The score and stats classes launch and start their scalars' copy;
    the score class of the block kernel may run packed
    (:func:`packed_units`), and its fetch then recomputes the pairs the
    packed form flagged through the int32 form.
    Classes with planes are fetched here, as the reference does, so no
    two batches' planes are on the card at once.  ``width="64"`` runs
    the int32 kernel, then re-fills exactly in int64 (golden) every pair
    whose worst-case |H| bound does not fit int32, planes included, on
    the host.  A batch of long pairs takes the segment route
    (:func:`plan_route`): all its segments are enqueued here.
    ``on_route(route, reason)`` is called with every routing decision;
    ``banded`` / ``bandwidth``: the banded mode, which has no int64
    re-fill (``Aligner.banded_nw`` runs it at width 32).

    ``walk=True`` (class ``trace``): one launch
    (:func:`plan_route` with ``one_shot=True``), the device walk of its
    plane, and one pinned copy of the scalars, the begins
    (``beg_query`` / ``beg_ref``) and the (B, Qp + Rp) opcode rows,
    backward; the plane never leaves the card.  Past the int32 bound the
    merged plane goes back to the card for the walk and the int64
    scalars stay on the host.
    """
    if banded and width == "64":
        raise ValueError("the banded mode has no width 64")
    kw = dict(gap_open=gap_open, gap_extend=gap_extend, mode=mode, free=free,
              outputs=outputs, on_route=on_route)
    wide = (width64_risk(batch, gap_open, gap_extend) if width == "64"
            else ())
    if len(wide):
        log.warning(
            "width='64': %d pair(s) exceed the int32 score bound; "
            "re-filling them exactly in int64 on the host (scalar "
            "golden model)", len(wide))
        out = _golden64_merge(submit(batch, width="32", **kw).fetch()[0],
                              batch, wide, gap_open=gap_open,
                              gap_extend=gap_extend, mode=mode, free=free)
        if not walk:
            return PendingResult(host=out)
        # the walk reads int32 end cells; the int64 ones stay on the host
        ends = {"trace_table": out.pop("trace_table"),
                "end_query": out["end_query"].astype(np.int32),
                "end_ref": out["end_ref"].astype(np.int32)}
        return _walk(batch, {k: upload(v, batch.device)
                             for k, v in ends.items()}, mode, free, out)
    if walk:
        return _walk(batch, launch(batch, width=width, **kw), mode, free)
    res = _run(batch, width=width, banded=banded, bandwidth=bandwidth,
               **kw)
    if outputs in SCALAR_CLASSES:
        return PendingResult(res, rerun=_rerun16(
            batch, gap_open=gap_open, gap_extend=gap_extend, mode=mode,
            free=free, width=width) if "over16" in res else None)
    planes = {k: res.pop(k) for k in [k for k in res if _is_plane(k)]}
    out, _ = PendingResult(res).fetch()
    with stages.stage("fetch.copy"):
        # one device-side transpose to batch-major and one copy each (the
        # segment route's trace plane is on the host already)
        out.update((k, v if isinstance(v, np.ndarray)
                    else v.contiguous().cpu().numpy())
                   for k, v in planes.items())
    return PendingResult(host=out)


def _walk_symbols(batch: PairBatch, Qp: int):
    """Symbol planes for the walk's '=' against 'X' decision: the raw
    bytes where the batch carries them (golden compares raw bytes;
    mapped letters fold case and wildcards), the profile query's bytes
    for a shared-profile batch, else the letter indices."""
    if batch.rbytes is not None and batch.qbytes is not None:
        return batch.qbytes, batch.rbytes
    if batch.rbytes is not None and batch.query is not None:
        qarr = np.zeros((1, Qp), np.uint8)
        qarr[0, :len(batch.query)] = np.frombuffer(batch.query, np.uint8)
        return upload(qarr, batch.device), batch.rbytes
    return batch.qidx, batch.ridx


def _walk(batch: PairBatch, cols, mode, free, host=None) -> PendingResult:
    """Walk ``cols``' trace plane on its device from its end cells and
    start the copy of the other columns, the begins and the opcode rows
    (``host``'s columns, fetched already, take precedence)."""
    from ..ops.trace_walk import device_walk

    trace = cols.pop("trace_table")
    qsym, rsym = _walk_symbols(batch, trace.shape[1])
    with stages.stage("walk"):
        ops, bq, br = device_walk(trace, qsym, rsym, cols["end_query"],
                                  cols["end_ref"], mode, free)
    return PendingResult({**cols, "beg_query": bq, "beg_ref": br}, ops,
                         host=host)


def slice_pair(out: dict, b: int, qlen: int, rlen: int) -> dict:
    """Extract pair ``b``'s results, cropped from padded to true lengths."""
    fields = {}
    for k, v in out.items():
        if k.endswith("_table"):
            fields[k] = v[b, :qlen, :rlen]
        elif k.endswith("_row"):
            fields[k] = v[b, :rlen]
        elif k.endswith("_col"):
            fields[k] = v[b, :qlen]
        else:
            fields[k] = v[b]
    return fields
