"""Batched alignment, every output class: the CUDA kernel's wrapper and
its plain PyTorch versions.

:func:`score_align` is the port of
``parasail_rs_tpu.ops.scan_kernel.scan_score_align`` in all seven of its
output classes: one call aligns a padded batch and returns per-pair
``score``, ``end_query``, ``end_ref``, ``saturated`` and, at width
``sat``, ``promoted``.  The trace class adds ``trace_table``, the
(B, Qp, Rp) int8 flags of every cell; the stats classes ``matches``,
``similar`` and ``length`` along the winning path; the table classes
``score_table`` (and ``matches_table`` / ``similar_table`` /
``length_table``), the (B, Qp, Rp) int32 H (and payloads) of every cell;
the rowcol classes ``score_row`` (B, Rp) and ``score_col`` (B, Qp) (and
the stats rows and columns), the last row and column.  Planes are zero
outside each pair's qlen x rlen cells, rows and columns beyond its
lengths.

On CUDA tensors it launches a hand-written kernel: every class the short
form in ``csrc/scan_short.cu`` (one warp a pair, several pairs a block,
the stats payloads packed; the tables (B, Qp, Rp) views of (B, Rp, Qp)
buffers), counted by class in :data:`SHORT_LAUNCHES`, for pairs of up to
256 padded query rows, and beyond that, or where a block cannot stage a
pair's inputs, the block kernel's one-shot form (:func:`score_chunked`,
counted in :data:`CHUNKED_LAUNCHES`).  :func:`short_plan` reads the
rule that picks between them.  On CPU tensors it runs
the plain version, :func:`score_align_plain`: its own column sweep for
the score and trace classes, the wavefront
(:func:`~.wavefront.wavefront_align`) for the others.  There is no
fallback between the two: a build, launch or shape failure raises, and a
batch whose planes do not fit the card raises too.

The substitution scores come in one of two forms, as on the reference's
two packers:

- ``table`` (A, A) with ``qidx`` (1 or B, Qp) query letters
  (``build_gpack_from_table``: square matrices);
- ``profile`` (1 or B, Qp, A) rows (``build_gpack``: ``Profile`` reuse and
  PSSMs), with ``qidx`` beside them for the stats classes, where
  ``matches`` compares letters.

A letter outside [0, A) scores 0.  Scores are exact int32 at every
width; the width only selects the saturation flags.  A pair with an
empty side gets golden's end cell and payload on the bordered grid (the
reference's kernels disagree there; ROADMAP Queue 3).

``banded=True`` with ``bandwidth`` bw is the reference's banded mode
(kernel K1e), in every class and mode: cells with |i - j| > bw and border
cells beyond bw are -2^30, so an unreachable NW corner scores -2^30 and
an SG pair whose every end candidate lies outside the band ends at (Qp,
Rp) with -2^30.  On the card the score class (``Aligner.banded_nw``
runs it) sweeps only the band on the banded warp form in
``csrc/scan_banded.cu`` (a pair's row blocks on a ring of 8, 16 or 32
lanes, ``pt_scan_band_ring``; counted in :data:`BANDED_WARP_LAUNCHES`)
wherever its rule reaches the band (:func:`band_plan`: up to bw 140 on
long pairs, any band on pairs of up to 140 padded letters).  Every other
banded launch, the six other classes and the score class past the ring's
reach, runs the masked full sweep: every cell, its flags and payloads
from its masked neighbours, then H, E and F set to -2^30 outside the
band.  It runs on the short form's masked instantiation
(``csrc/scan_short_banded.cu``, ``pt_scan_short_banded``) where
:func:`short_plan` takes the batch, else on the block kernel's masked
one-shot form (``csrc/scan_chunked_banded.cu``,
``pt_scan_chunked_banded``), each launch counted by class in
:data:`BANDED_CLASS_LAUNCHES` and by form in
:data:`BANDED_FORM_LAUNCHES`; its planes are laid out as the unbanded
ones.  Its plain version is the wavefront with ``banded=True``, whose
flags and payloads outside the band the kernels reproduce too.

:func:`score_segment` is the port of
``parasail_rs_tpu.ops.scan_kernel.scan_score_segment`` (kernel K2): one
reference segment of the same sweep, with the sweep's state carried in
and out, for the score, stats and trace classes.  Chained left to right
over a pair's columns it gives :func:`score_align`'s outputs for the same
class, bit for bit, at any reference length: the whole pair never has to
fit one launch, and the trace class hands its flags over a segment at a
time.  On CUDA tensors it launches the kernel in ``csrc/scan_segment.cu``
(a chain of up to eight warps a block, and of up to eight blocks a pair
in a cluster when the batch is small, two to eight query rows a lane)
and counts
the launch in :data:`SEGMENT_LAUNCHES`; on CPU tensors it runs
:func:`score_segment_plain`, the wavefront over the segment with a left
boundary.  No fallback here either.  Given ``units``
(:func:`pair_units`), its score class runs the packed form instead
(``csrc/scan_segment16.cu``: two pairs a lane on 16x2 DPX, counted in
:data:`SEGMENT16_LAUNCHES`), which flags in ``over16`` every pair whose
values left the 16-bit band; those pairs' outputs are not exact, and the
caller computes them again without ``units`` (``engine.dispatch`` does,
at fetch).  :func:`score_chunked` takes ``units`` for its score class
the same way.

:func:`score_rowseg` is the port of
``parasail_rs_tpu.ops.scan_kernel.scan_rowseg_step`` (kernel K3): one
TILE of the same sweep, query rows [``row_offset``, ``row_offset`` +
``q_chunk``) by the columns of one reference shard, for the
sequence-parallel fill of ``dist.seqpar_scan``.  State goes two ways:
rightward to the tile of the next shard (``h``, ``f``, the stats
payloads and the corner ``t``), downward to the next row chunk of the
same shard (``down``: H and E of the tile's last row per column).  On
CUDA tensors it launches the kernel in ``csrc/scan_rowseg.cu`` (the
segment kernel's block in its tile form) and counts the launch in
:data:`ROWSEG_LAUNCHES`; on CPU tensors it runs
:func:`score_rowseg_plain`, the wavefront with a left boundary, a top
boundary and a row offset.  No fallback.

:func:`score_chunked` is the port of
``parasail_rs_tpu.ops.scan_kernel.scan_score_align`` with the query in
row chunks (kernel K1f, ``nq > 1``): the same function as
:func:`score_align`, same signature (no banded mode) and outputs in all
seven classes, for long pairs.  On CUDA tensors it launches, once over
all of a pair's columns, the segment kernel's block (a chain of warps a
pair, over a cluster of blocks when the batch is small, on stripes of
32 kR query rows, groups of rows handing their last row down) in
``csrc/scan_chunked.cu``, whose plane forms
write the tables (laid out (nplanes, B, Rp, Qp) on the card and returned
as (B, Qp, Rp) views), the last row and the last column; it counts the
launch in :data:`CHUNKED_LAUNCHES`.  On CPU tensors it runs
:func:`score_align_plain`.  No fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import (
    NEG_INF32,
    TRACE_DEL,
    TRACE_DEL_F,
    TRACE_DIAG,
    TRACE_DIAG_E,
    TRACE_DIAG_F,
    TRACE_INS,
    TRACE_INS_E,
    WIDTH_MAX,
    WIDTH_MIN,
)
from ..utils import stages

from .wavefront import (PLANES, STATS_CLASSES, STATS_KEYS, empty_side,
                        flag_outputs, wavefront_align)

MODES = {"nw": 0, "sg": 1, "sw": 2}
WIDTHS = ("sat", "8", "16", "32", "64")
# the output classes, in the order of csrc/score_cell.cuh's OutClass
OUTPUTS = ("score", "trace", "stats", "table", "stats_table", "rowcol",
           "stats_rowcol")
BIG = 2 ** 30

# Launches in this process of the banded score class on the banded warp
# form (csrc/scan_banded.cu); of the banded mode's masked full sweep, by
# class (every banded launch the ring does not take) and by the form that
# ran it ("short": csrc/scan_short_banded.cu, "block":
# csrc/scan_chunked_banded.cu); and of the short form (csrc/scan_short.cu),
# every unbanded class, by class.  Only score_align's CUDA branch adds to
# them; set them to 0 to count one phase of work.  Every launch these
# tallies count also counts as ``launches`` in utils.stages while its
# spans are on.
BANDED_WARP_LAUNCHES = 0
BANDED_CLASS_LAUNCHES = dict.fromkeys(OUTPUTS, 0)
BANDED_FORM_LAUNCHES = {"short": 0, "block": 0}
SHORT_LAUNCHES = dict.fromkeys(OUTPUTS, 0)
# Launches of the segment kernel (csrc/scan_segment.cu); only
# score_segment's CUDA branch adds to it.
SEGMENT_LAUNCHES = 0
# the classes the segment kernel serves (the reference streams the same)
SEGMENT_OUTPUTS = ("score", "stats", "trace")
# Warps the segment kernel puts on a block, 1 to 8.  0 leaves it to the
# launcher's rule (csrc/score_cell.cuh, seg_plan), which also picks the
# query rows a lane and the blocks a pair; the tests and chip_smoke.py set
# it to check and to time a given number.
SEGMENT_WARPS = 0
# The block kernel's rows a lane (2, 4, or 8 for score and rowcol) and
# blocks a pair (a thread-block cluster, 1 to 8), 0 for the launcher's
# rule: the checks of chip_smoke.py and the cuda tests set them to hold
# given forms to the plain versions; nothing else does.
_LANE_ROWS = 0
_CLUSTER = 0
# The banded score class's form: None for the rule (band_plan), (G, kR)
# for the warp form at G lanes and kR rows (which must reach the band),
# (0, 0) for the masked full sweep.  The cuda tests and chip_smoke.py set
# it to hold and time given forms; nothing else does.
_BAND_FORM = None
# Launches of the packed score form (csrc/scan_segment16.cu): the block
# kernel's score class with two pairs a lane, which score_segment's and
# score_chunked's CUDA branches run when given ``units``; they count here
# alone, not in SEGMENT_LAUNCHES or CHUNKED_LAUNCHES.
SEGMENT16_LAUNCHES = 0
# The packed form's limits (csrc/segment16.cuh, seg16_usable): penalties
# and scores past them leave no band of 16-bit values that cannot wrap.
SEG16_MAX_GUARD = 8192
# Launches of the tile kernel (csrc/scan_rowseg.cu); only score_rowseg's
# CUDA branch adds to it.  Its block takes SEGMENT_WARPS too.
ROWSEG_LAUNCHES = 0
# Launches of the chunked sweep (csrc/scan_chunked.cu); only
# score_chunked's CUDA branch adds to it.  Its block takes SEGMENT_WARPS.
CHUNKED_LAUNCHES = 0


def _free_bits(free) -> int:
    qb, qe, db, de = (bool(x) for x in free)
    return qb | (qe << 1) | (db << 2) | (de << 3)


def _check(ridx, qlen, rlen, table, qidx, profile, mode, width, outputs):
    """Validate the inputs; return (B, Bq, Qp, Rp, A)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}")
    if width not in WIDTHS:
        raise ValueError(f"width {width!r}")
    if outputs not in OUTPUTS:
        raise ValueError(f"outputs {outputs!r}")
    if (table is None) == (profile is None):
        raise ValueError("give exactly one of table (with qidx) or profile")
    if table is not None and qidx is None:
        raise ValueError("the table form needs qidx")
    if outputs in STATS_CLASSES and qidx is None:
        raise ValueError(f"outputs={outputs!r} needs qidx (matches compares "
                         "letters)")
    dev = ridx.device
    named = {"ridx": ridx, "qlen": qlen, "rlen": rlen, "table": table,
             "qidx": qidx, "profile": profile}
    for name, t in named.items():
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, ridx on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ridx.dim() != 2:
        raise ValueError(f"ridx must be (B, Rp), got {tuple(ridx.shape)}")
    B, Rp = ridx.shape
    if qlen.shape != (B,) or rlen.shape != (B,):
        raise ValueError("qlen and rlen must be (B,)")
    if table is not None:
        if table.dim() != 2 or table.shape[0] != table.shape[1]:
            raise ValueError(
                f"table must be (A, A), got {tuple(table.shape)}")
        # the letters set the query side; their shape is checked below
        Bq, Qp = qidx.shape if qidx.dim() == 2 else (None, None)
        A = table.shape[0]
    else:
        if profile.dim() != 3 or profile.shape[0] not in (1, B):
            raise ValueError(
                f"profile must be (1 or B, Qp, A), got {tuple(profile.shape)}")
        Bq, Qp, A = profile.shape
    if qidx is not None and (qidx.dim() != 2 or qidx.shape[0] not in (1, B)
                             or qidx.shape[1] != Qp):
        raise ValueError(
            f"qidx must be (1 or B, Qp), got {tuple(qidx.shape)}")
    return B, Bq, Qp, Rp, A


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel_scalars(out, width) -> dict:
    """The per-pair outputs of a kernel's (5, B) block (score, end_query,
    end_ref, sat8, sat16), or (8, B) with the stats payloads."""
    res = flag_outputs(out[0], out[1], out[2], out[3] != 0, out[4] != 0,
                       width)
    if out.shape[0] == 8:
        res.update(zip(STATS_KEYS, out[5:8]))
    return res


def score_align(ridx, qlen, rlen, *, open_, ext, mode, free, width="32",
                table=None, qidx=None, profile=None, outputs="score",
                banded=False, bandwidth=0) -> dict:
    """Align a padded batch, any output class.

    ``ridx`` (B, Rp), ``qlen`` / ``rlen`` (B,), ``table`` (A, A) +
    ``qidx`` (1 or B, Qp), or ``profile`` (1 or B, Qp, A) (+ ``qidx`` for
    the stats classes): all int32 on one device.  Returns int32
    ``score`` / ``end_query`` / ``end_ref`` and bool ``saturated`` (+
    ``promoted`` at width ``sat``), on that device, plus the class's
    outputs (see the module docstring).  On the card the trace plane is a
    contiguous (B, Qp, Rp) tensor, the tables (B, Qp, Rp) views of (B,
    Rp, Qp) buffers, the rows and columns contiguous, banded or not.
    Lengths must not exceed the padded sizes.  ``banded`` /
    ``bandwidth``: the banded mode (module docstring).
    """
    B, Bq, Qp, Rp, A = _check(ridx, qlen, rlen, table, qidx, profile, mode,
                              width, outputs)
    if ridx.device.type == "cpu":
        return score_align_plain(ridx, qlen, rlen, open_=open_, ext=ext,
                                 mode=mode, free=free, width=width,
                                 table=table, qidx=qidx, profile=profile,
                                 outputs=outputs, banded=banded,
                                 bandwidth=bandwidth)
    if ridx.device.type != "cuda":
        raise ValueError(f"no kernel for device {ridx.device}")
    dims = (B, Bq, Qp, Rp, A)
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, width=width,
              table=table, qidx=qidx, profile=profile)
    if banded and outputs == "score":
        form = band_form(B, Qp, Rp, A, bandwidth, profile is not None)
        if form[0]:
            return _band_ring(ridx, qlen, rlen, dims, form,
                              bandwidth=bandwidth, **kw)
    if banded:
        kw["bandwidth"] = max(-1, min(int(bandwidth), Qp + Rp))
    short = short_plan(outputs, B, Bq, Qp, Rp, A, profile is not None)[0]
    launch = _short_launch if short else _chunked_launch
    res = launch(ridx, qlen, rlen, dims, outputs=outputs, **kw)
    if banded:
        BANDED_CLASS_LAUNCHES[outputs] += 1
        BANDED_FORM_LAUNCHES["short" if short else "block"] += 1
        stages.count("launches")
    return res


def _band_ring(ridx, qlen, rlen, dims, form, *, open_, ext, mode, free,
               width, table, qidx, profile, bandwidth) -> dict:
    """The banded score class on the banded warp form at ``form`` (G
    lanes a pair, kR rows a block)."""
    global BANDED_WARP_LAUNCHES
    from . import _build

    B, Bq, Qp, Rp, A = dims
    lib = _build.load()
    dev = ridx.device
    out = torch.empty((5, B), dtype=torch.int32, device=dev)
    subs = table if table is not None else profile
    bw = max(-1, min(int(bandwidth), Qp + Rp))
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.pt_scan_band_ring(
            subs.data_ptr(), _ptr(qidx if table is not None else None),
            ridx.data_ptr(), qlen.data_ptr(), rlen.data_ptr(),
            out.data_ptr(), B, Bq, Qp, Rp, A, int(open_), int(ext),
            MODES[mode], _free_bits(free), bw, int(form[0]), int(form[1]),
            stream)
    if rc != 0:
        raise RuntimeError(f"banded warp form {tuple(form)} launch failed: "
                           f"CUDA error {rc}")
    BANDED_WARP_LAUNCHES += 1
    stages.count("launches")
    return _kernel_scalars(out, width)


def band_plan(B, Qp, Rp, A, bandwidth, profile=False) -> tuple:
    """(lanes a pair, rows a block) that the banded warp form's launcher
    takes for ``B`` pairs of ``Qp`` by ``Rp`` padded cells at half-width
    ``bandwidth`` over ``A`` letters (``csrc/score_cell.cuh``,
    ``band_plan``): G of 8, 16 or 32 and kR of 4, 5, 6 or 8 with 2 bw <
    (G - 1) kR + G + 1, or (0, 0) where no form reaches the band or the
    table form's (A + 1)^2 scores pass 32 KB (:func:`score_align` then
    launches the masked full sweep).  Builds the kernels (it asks the
    library's own rule)."""
    from . import _build

    plan = (ctypes.c_int * 2)()
    bw = max(-1, min(int(bandwidth), int(Qp) + int(Rp)))
    _build.load().pt_band_plan(int(B), int(Qp), int(Rp), bw, int(A),
                               int(bool(profile)),
                               ctypes.cast(plan, ctypes.c_void_p))
    return tuple(plan)


def band_form(B, Qp, Rp, A, bandwidth, profile=False) -> tuple:
    """The form the banded score class launches on the card:
    ``_BAND_FORM`` where set, else :func:`band_plan`'s."""
    return _BAND_FORM or band_plan(B, Qp, Rp, A, bandwidth, profile)


def band_cells(qlen, rlen, bandwidth) -> int:
    """The in-band cells of pairs of ``qlen`` by ``rlen`` (host arrays):
    cells (i, j) with |i - j| <= ``bandwidth``, summed in closed form.
    Row i of an m x n matrix holds min(n, i + k + 1) cells with
    j - i <= k, clipped at 0; the band is those at k = bw less those at
    k = -bw - 1."""
    m = np.asarray(qlen, np.int64)
    n = np.asarray(rlen, np.int64)
    bw = int(bandwidth)
    if bw < 0:
        return 0

    def left_of(x):            # sum of clip(t, 0, n) over t < x
        a = np.clip(x - 1, 0, n)
        return a * (a + 1) // 2 + n * np.maximum(x - 1 - n, 0)

    def at_most(k):            # cells with j - i <= k
        return left_of(k + 1 + m) - left_of(k + 1)

    return int(np.sum(at_most(bw) - at_most(-bw - 1)))


def band_swept(qlen, rlen, Qp, Rp, bandwidth, form) -> int:
    """The cells a banded score launch's schedule sweeps over pairs of
    ``qlen`` by ``rlen`` (host arrays) padded to ``Qp`` by ``Rp``.

    The masked full sweep (``form`` (0, 0)) computes every padded cell,
    B Qp Rp.  The ring at ``form`` (G, kR) steps each of a pair's G lanes
    over kR rows once a step, busy or idle, for as many steps as its
    warp's longest pair takes (``csrc/score_cell.cuh``, ``band_pair``;
    a warp holds 32 / G consecutive pairs): with bw the band clamped to
    the padded pair (``band_eff``) and kl = min(ceil(qlen / kR) - 1,
    (rlen - 1 + bw) // kR) the pair's last block with columns, a pair
    takes min(rlen - 1, kl kR + kR - 1 + bw) + kl + 1 steps (0 with an
    empty side), and the launch sweeps G kR times the sum over its pairs
    of their warp's steps.  At steady state a lane is busy 2 bw + kR of
    every G (kR + 1) steps, so the band's 2 bw + 1 cells a row fill at
    most (2 bw + 1) / (G (kR + 1)) of what the ring sweeps."""
    qlen = np.asarray(qlen, np.int64)
    rlen = np.minimum(np.asarray(rlen, np.int64), int(Rp))
    G, kR = (int(x) for x in form)
    if not G:
        return len(rlen) * int(Qp) * int(Rp)
    bw = min(max(int(bandwidth), -1), max(int(Qp), int(Rp)))    # band_eff
    live = (qlen > 0) & (rlen > 0) & (bw >= 0)
    kl = np.minimum(-(-qlen // kR) - 1, (rlen - 1 + bw) // kR)
    steps = np.where(live, np.minimum(rlen - 1, kl * kR + kR - 1 + bw)
                     + kl + 1, 0)
    per_warp = 32 // G
    B = len(steps)
    warps = np.zeros(-(-B // per_warp) * per_warp, np.int64)
    warps[:B] = steps
    warps = warps.reshape(-1, per_warp).max(axis=1)
    return G * kR * int(np.sum(np.repeat(warps, per_warp)[:B]))


def short_plan(outputs, B, Bq, Qp, Rp, A, profile=False) -> tuple:
    """(rows a lane, pairs a block, stats payload layout) that the short
    form's launcher takes for a launch of class ``outputs`` on ``B`` pairs
    of ``Qp`` by ``Rp`` padded cells (``csrc/score_cell.cuh``,
    ``short_plan``): rows 4, 5, 6 or 8, the fewest whose 32 lanes hold
    ``Qp``, or 0 where the short form does not take the batch (``Qp`` >
    256, or inputs a block cannot stage; :func:`score_align` then
    launches the block kernel's one-shot form); layout 1 for [m | s | l]
    in one word, 2 for [m | s] and l (the stats classes), 0 for the
    others.  ``Bq`` is the query side's batch (1: one profile
    for every pair).  Builds the kernels (it asks the library's own
    rule)."""
    from . import _build

    plan = (ctypes.c_int * 3)()
    _build.load().pt_short_plan(
        OUTPUTS.index(outputs), int(B), int(Bq), int(Qp), int(Rp), int(A),
        int(bool(profile)), ctypes.cast(plan, ctypes.c_void_p))
    return tuple(plan)


def _short_launch(ridx, qlen, rlen, dims, *, open_, ext, mode, free, width,
                  table, qidx, profile, outputs, bandwidth=None) -> dict:
    """Launch the short form (``pt_scan_short``) of class ``outputs`` on a
    batch :func:`short_plan` gives it, or with ``bandwidth`` (clamped to
    [-1, Qp + Rp]) its masked form (``pt_scan_short_banded``); count an
    unbanded launch (the caller counts a banded one).  The trace plane is
    a contiguous (B, Qp, Rp) tensor, the tables (B, Qp, Rp) views of (B,
    Rp, Qp) buffers (as :func:`score_chunked`'s), the rows and columns
    contiguous (B, Rp) / (B, Qp)."""
    from . import _build

    B, Bq, Qp, Rp, A = dims
    dev = ridx.device
    i32 = torch.int32
    stats = outputs in STATS_CLASSES
    nplanes = 4 if stats else 1
    out = torch.empty((8 if stats else 5, B), dtype=i32, device=dev)
    plane = tab = rows = cols = None
    if outputs == "trace":
        plane = torch.zeros((B, Qp, Rp), dtype=torch.int8, device=dev)
    elif outputs in ("table", "stats_table"):
        tab = torch.zeros((nplanes, B, Rp, Qp), dtype=i32, device=dev)
    elif outputs in ("rowcol", "stats_rowcol"):
        rows = torch.zeros((nplanes, B, Rp), dtype=i32, device=dev)
        cols = torch.zeros((nplanes, B, Qp), dtype=i32, device=dev)
    subs = table if table is not None else profile
    lib = _build.load()
    entry, band = ((lib.pt_scan_short, ()) if bandwidth is None else
                   (lib.pt_scan_short_banded, (int(bandwidth),)))
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = entry(
            OUTPUTS.index(outputs), subs.data_ptr(),
            qidx.data_ptr() if table is not None else None,
            _ptr(qidx if stats else None), ridx.data_ptr(), qlen.data_ptr(),
            rlen.data_ptr(), out.data_ptr(), _ptr(plane), _ptr(tab),
            _ptr(rows), _ptr(cols), B, Bq, qidx.shape[0] if stats else 0, Qp,
            Rp, A, int(open_), int(ext), MODES[mode], _free_bits(free),
            *band, stream)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} ({outputs}) kernel launch "
                           f"failed: CUDA error {rc}")
    if bandwidth is None:
        SHORT_LAUNCHES[outputs] += 1
        stages.count("launches")
    res = _kernel_scalars(out, width)
    if plane is not None:
        res["trace_table"] = plane
    for k, name in enumerate(PLANES[:nplanes]):
        if tab is not None:
            res[f"{name}_table"] = tab[k].transpose(1, 2)
        if rows is not None:
            res[f"{name}_row"] = rows[k]
            res[f"{name}_col"] = cols[k]
    return res


def _substitution_rows(table, qidx, profile):
    """(1 or B, Qp, A) substitution rows, with invalid query letters
    scoring 0 (the table form gathers them from the table)."""
    if profile is not None:
        return profile
    A = table.shape[0]
    ok = (qidx >= 0) & (qidx < A)
    rows = table[qidx.clamp(0, A - 1).long()]
    return torch.where(ok[..., None], rows, torch.zeros_like(rows))


def score_align_plain(ridx, qlen, rlen, *, open_, ext, mode, free,
                      width="32", table=None, qidx=None, profile=None,
                      outputs="score", banded=False, bandwidth=0) -> dict:
    """Plain PyTorch version of :func:`score_align`, same signature and
    outputs.  The stats, table and rowcol classes, and every banded
    batch, run the wavefront (:func:`~.wavefront.wavefront_align`), whose
    literal payload ties hold at every penalty pair; the column sweep
    below has no band.

    The score and trace classes run a sweep over reference columns
    vectorised over (B, Qp), as the TPU kernel sweeps
    (scan_kernel.py:700-842, 1000-1101), in int32.

    Per column j: F from the previous column; Htemp = max(Hdiag + S, F)
    (clamped at 0 in SW); E by an exclusive cummax over the query axis of
    Htemp - open + e_ext*i, the closed form of the vertical recurrence
    with slope e_ext = min(open, ext); H = max(Htemp, E).  The trace
    flags compare the same values as golden (scan_kernel.py:865-888).
    """
    B, Bq, Qp, Rp, A = _check(ridx, qlen, rlen, table, qidx, profile, mode,
                              width, outputs)
    if banded or outputs not in ("score", "trace"):
        return wavefront_align(
            _substitution_rows(table, qidx, profile), qidx, ridx, qlen, rlen,
            open_=open_, ext=ext, mode=mode, free=free, outputs=outputs,
            width=width, banded=banded, bandwidth=bandwidth)
    dev = ridx.device
    i32 = torch.int32
    open_, ext = int(open_), int(ext)
    e_ext = min(open_, ext)
    local = mode == "sw"
    qb, qe, db, de = (True,) * 4 if local else tuple(bool(x) for x in free)
    neg = NEG_INF32

    def border(c, is_free):
        if is_free:
            return torch.zeros_like(c)
        return torch.where(c > 0, -(open_ + (c - 1) * ext),
                           torch.zeros_like(c))

    def top(c: int) -> int:
        return 0 if (qb or c <= 0) else -(open_ + (c - 1) * ext)

    rows = _substitution_rows(table, qidx, profile)          # (Bq, Qp, A)
    rows_t = rows.transpose(1, 2).contiguous()               # (Bq, A, Qp)
    ii = torch.arange(Qp, dtype=i32, device=dev)
    a_base = e_ext * ii - open_
    e_base = e_ext * (ii - 1)
    qlen_c, rlen_c = qlen[:, None], rlen[:, None]
    imask = ii[None, :] < qlen_c                             # (B, Qp)
    last_row = ii[None, :] == qlen_c - 1
    hprev = border(ii + 1, db)[None, :].expand(B, Qp).contiguous()
    fprev = torch.full((B, Qp), neg, dtype=i32, device=dev)
    zero = torch.zeros((B, Qp), dtype=i32, device=dev)
    negs = torch.full((B, Qp), neg, dtype=i32, device=dev)
    best = torch.full((B,), 0 if local else neg, dtype=i32, device=dev)
    bi = torch.full((B,), 0 if local else Qp, dtype=i32, device=dev)
    bj = torch.full((B,), 0 if local else BIG, dtype=i32, device=dev)
    hmax = torch.zeros((B,), dtype=i32, device=dev)
    hmin = torch.zeros((B,), dtype=i32, device=dev)
    bidx = torch.arange(B, device=dev)
    flag_cols = []

    for j in range(Rp):
        r = ridx[:, j]
        rok = (r >= 0) & (r < A)
        rc = r.clamp(0, A - 1).long()
        if Bq == 1:
            s = rows_t[0, rc]                                # (B, Qp)
        else:
            s = rows_t[bidx, rc]
        s = torch.where(rok[:, None], s, zero)
        F = torch.maximum(hprev - open_, fprev - ext)
        hdiag = torch.cat(
            [torch.full((B, 1), top(j), dtype=i32, device=dev),
             hprev[:, :-1]], dim=1)
        htemp = torch.maximum(hdiag + s, F)
        if local:
            htemp = htemp.clamp_min(0)
        a = htemp + a_base
        seed = top(j + 1) - open_ - e_ext
        incl = torch.cummax(a, dim=1).values
        pm = torch.cat(
            [torch.full((B, 1), seed, dtype=i32, device=dev),
             incl[:, :-1].clamp_min(seed)], dim=1)
        E = pm - e_base
        H = torch.maximum(htemp, E)

        inseq = imask & (j < rlen_c)
        if outputs == "trace":
            flag_cols.append(torch.where(
                inseq, _flags(hdiag + s, E, F, H, hprev, fprev, top(j + 1),
                              open_, ext, local), zero).to(torch.int8))
        hm = torch.where(inseq, H, zero)
        hmax = torch.maximum(hmax, hm.amax(dim=1))
        hmin = torch.minimum(hmin, hm.amin(dim=1))
        last_col = (rlen_c - 1) == j
        if local:
            cand = inseq & (H > 0)
        elif mode == "sg":
            sel = last_row & last_col
            if qe:
                sel = sel | last_row
            if de:
                sel = sel | last_col
            cand = inseq & sel
        else:
            cand = inseq & last_row & last_col
        hc = torch.where(cand, H, negs)
        col_best = hc.amax(dim=1)
        at_best = cand & (hc == col_best[:, None])
        col_i = torch.where(at_best, ii[None, :],
                            torch.full_like(hc, Qp)).amin(dim=1)
        upd = cand.any(dim=1) & ((col_best > best) |
                                 ((col_best == best) & (col_i < bi)))
        best = torch.where(upd, col_best, best)
        bi = torch.where(upd, col_i, bi)
        bj = torch.where(upd, torch.full_like(bj, j), bj)
        hprev, fprev = H, F

    if mode == "nw":
        eq, er = qlen - 1, rlen - 1
    else:
        eq, er = bi, bj
    if not local:
        best, eq, er, _, _ = empty_side(best, eq, er, qlen, rlen, Qp, Rp,
                                        border, qb, qe and mode == "sg", db,
                                        de and mode == "sg")
    sat8 = (hmax >= WIDTH_MAX["8"]) | (hmin <= WIDTH_MIN["8"])
    sat16 = (hmax >= WIDTH_MAX["16"]) | (hmin <= WIDTH_MIN["16"])
    res = flag_outputs(best, eq, er, sat8, sat16, width)
    if outputs == "trace":
        res["trace_table"] = (torch.stack(flag_cols, dim=2) if Rp else
                              torch.zeros((B, Qp, 0), dtype=torch.int8,
                                          device=dev))
    return res


def _flags(diag, E, F, H, hprev, fprev, top_next, open_, ext, local):
    """One column's trace flags (golden/model.py:166-211) from its
    values: the cell above (H and E of row i - 1; the top border and -inf
    on row 0) and the column to the left (``hprev`` / ``fprev``)."""
    B = H.shape[0]
    h_up = torch.cat([torch.full((B, 1), top_next, dtype=H.dtype,
                                 device=H.device), H[:, :-1]], dim=1)
    e_up = torch.cat([torch.full((B, 1), NEG_INF32, dtype=E.dtype,
                                 device=E.device), E[:, :-1]], dim=1)
    eflag = torch.where(h_up - open_ >= e_up - ext, TRACE_DIAG_E,
                        TRACE_INS_E)
    fflag = torch.where(hprev - open_ >= fprev - ext, TRACE_DIAG_F,
                        TRACE_DEL_F)
    hflag = torch.where((diag >= E) & (diag >= F), TRACE_DIAG,
                        torch.where(E >= F, TRACE_INS, TRACE_DEL))
    if local:
        pre = torch.maximum(torch.maximum(diag, E), F)
        hflag = torch.where(pre <= 0, 0, hflag)
    return hflag | eflag | fflag


def _check_segment(ridx_seg, qlen, rlen, state, table, qidx, profile, mode,
                   width, outputs, col_offset, resume, packed=False):
    """Validate a segment call; return (B, Bq, Qp, Rseg, A)."""
    if outputs not in SEGMENT_OUTPUTS:
        raise ValueError(f"outputs {outputs!r}: the segment form serves "
                         f"{SEGMENT_OUTPUTS}")
    dims = _check(ridx_seg, qlen, rlen, table, qidx, profile, mode, width,
                  outputs)
    B, _, Qp, _, _ = dims
    col_offset = int(col_offset)
    if not 0 <= col_offset < 2 ** 31:
        raise ValueError(f"col_offset {col_offset}")
    if not resume:
        if col_offset != 0:
            raise ValueError("the first segment (resume=False) starts at "
                             "column 0")
        return dims
    if state is None:
        raise ValueError("resume=True needs the state of the segment before")
    want = {"h": (B, Qp), "f": (B, Qp), "acc": (B, 8)}
    if outputs == "stats":
        want["stats"] = (6, B, Qp)
    if packed:
        want["over"] = (B,)
    for name, shape in want.items():
        t = state.get(name)
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or \
                tuple(t.shape) != shape or t.device != ridx_seg.device or \
                not t.is_contiguous():
            raise ValueError(f"state[{name!r}] must be a contiguous int32 "
                             f"{shape} tensor on {ridx_seg.device}")
    return dims


def score_segment(ridx_seg, qlen, rlen, state=None, *, open_, ext, mode,
                  free, width="32", outputs="score", col_offset=0,
                  resume=False, table=None, qidx=None, profile=None,
                  trace_out=None, units=None,
                  bound=None) -> tuple[dict, dict]:
    """One reference segment of a score, stats or trace sweep.

    ``ridx_seg`` (B, Rseg) holds columns [``col_offset``, ``col_offset``
    + Rseg) of the pairs' references (any fill beyond a pair's length),
    ``rlen`` their WHOLE lengths; the substitution inputs are
    :func:`score_align`'s.  The caller runs segments left to right: the
    first with ``resume=False`` (and ``col_offset`` 0), each later one
    with ``resume=True`` and the ``state`` the one before returned.
    Returns ``(out, state)``.

    ``state``: ``h`` and ``f`` (B, Qp) int32, H and F (the gap that runs
    along the reference) of every query row below ``qlen`` at the pair's
    last column so far (rows from ``qlen`` on hold nothing); for the stats
    class ``stats`` (6, B, Qp), the payloads (matches, similar, length) of
    ``h`` and of ``f``; ``acc`` (B, 8): the best candidate so far, its i
    and j, the maximum and minimum of H so far, and the best's payload.
    A segment beyond a pair's ``rlen`` leaves that pair's state as it
    was.  The kernel updates the state tensors it is given IN PLACE and
    returns them; the plain version returns new ones.

    ``out``, after the last segment, is :func:`score_align`'s for the
    class: ``score``, ``end_query``, ``end_ref``, ``saturated`` (+
    ``promoted``), the stats class's ``matches`` / ``similar`` /
    ``length``; before it, the same read off the cells so far.  The trace
    class adds ``trace_table_seg`` (B, Qp, Rseg) int8, this segment's
    flags, 0 outside each pair's cells; ``trace_out`` is a buffer of that
    shape to write them to (it is zero-filled here), for a caller that
    copies one segment out while the next one runs.

    ``units`` (the score class only): the (ceil(B / 2), 2) int32 pairs
    of :func:`pair_units` on the batch's device, which run the packed
    form; ``bound`` is the largest |score| of ``table`` / ``profile``
    (None: read from it, which waits for the card).  Its state adds
    ``over`` (B,) int32 and ``out`` adds ``over16`` (B,) int32, 1 for a
    pair whose values left the 16-bit band, whose other outputs and state
    are then not exact (every other pair's are the int32 form's).  On the
    CPU the plain version runs, exact, and ``over16`` is all 0.
    """
    packed = units is not None
    if packed and outputs != "score":
        raise ValueError("units: the packed form is the score class's")
    B, Bq, Qp, Rseg, A = _check_segment(
        ridx_seg, qlen, rlen, state, table, qidx, profile, mode, width,
        outputs, col_offset, resume, packed)
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, width=width,
              outputs=outputs, col_offset=col_offset, resume=resume,
              table=table, qidx=qidx, profile=profile)
    dev = ridx_seg.device
    if dev.type == "cpu":
        out, state = score_segment_plain(ridx_seg, qlen, rlen, state, **kw)
        if trace_out is not None:
            trace_out.copy_(out["trace_table_seg"])
            out["trace_table_seg"] = trace_out
        if packed:
            out["over16"] = torch.zeros(B, dtype=torch.int32)
            state["over"] = torch.zeros(B, dtype=torch.int32)
        return out, state
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    global SEGMENT_LAUNCHES
    from . import _build

    if packed:
        return _block16_launch(
            ridx_seg, qlen, rlen, state if resume else None,
            (B, Bq, Qp, Rseg, A), units, bound,
            (int(col_offset), int(bool(resume))), open_=open_, ext=ext,
            mode=mode, free=free, width=width, table=table, qidx=qidx,
            profile=profile)

    plane = None
    if outputs == "trace":
        if trace_out is None:
            plane = torch.zeros((B, Qp, Rseg), dtype=torch.int8, device=dev)
        else:
            if trace_out.shape != (B, Qp, Rseg) or trace_out.device != dev \
                    or trace_out.dtype != torch.int8 or \
                    not trace_out.is_contiguous():
                raise ValueError("trace_out must be a contiguous int8 "
                                 f"{(B, Qp, Rseg)} tensor on {dev}")
            plane = trace_out.zero_()
    res, state = _block_launch(
        _build.load().pt_scan_segment, ridx_seg, qlen, rlen,
        state if resume else None, (B, Bq, Qp, Rseg, A), (plane,),
        (int(col_offset), int(bool(resume))), open_=open_, ext=ext,
        mode=mode, free=free, width=width, outputs=outputs, table=table,
        qidx=qidx, profile=profile)
    SEGMENT_LAUNCHES += 1
    stages.count("launches")
    if plane is not None:
        res["trace_table_seg"] = plane
    return res, state


def _block_launch(entry, ridx, qlen, rlen, state, dims, planes, tail, *,
                  open_, ext, mode, free, width, outputs, table, qidx,
                  profile) -> tuple[dict, dict]:
    """Launch the block kernel through ``entry`` (``pt_scan_segment`` or
    ``pt_scan_chunked``, whose arguments differ only in the output
    ``planes`` after ``out`` and the ``tail`` of ints before ``warps``) on
    ``dims`` = (B, Bq, Qp, R, A); ``state`` None makes a new one.  Returns
    (the per-pair outputs, state); the caller counts the launch."""
    B, Bq, Qp, R, A = dims
    dev = ridx.device
    i32 = torch.int32
    stats = outputs in STATS_CLASSES
    if state is None:
        state = {"h": torch.empty((B, Qp), dtype=i32, device=dev),
                 "f": torch.empty((B, Qp), dtype=i32, device=dev),
                 "acc": torch.empty((B, 8), dtype=i32, device=dev)}
        if stats:
            state["stats"] = torch.empty((6, B, Qp), dtype=i32, device=dev)
    bottom = torch.empty((B, 8 if stats else 2, max(R, 1)), dtype=i32,
                         device=dev)
    out = torch.empty((8 if stats else 5, B), dtype=i32, device=dev)
    subs = table if table is not None else profile
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = entry(
            OUTPUTS.index(outputs), subs.data_ptr(),
            qidx.data_ptr() if table is not None else None,
            _ptr(qidx if stats else None), ridx.data_ptr(), qlen.data_ptr(),
            rlen.data_ptr(), bottom.data_ptr(), state["h"].data_ptr(),
            state["f"].data_ptr(), _ptr(state.get("stats")),
            state["acc"].data_ptr(), out.data_ptr(),
            *(_ptr(t) for t in planes), B, Bq,
            qidx.shape[0] if stats else 0, Qp, R, A, int(open_), int(ext),
            MODES[mode], _free_bits(free), *tail, int(SEGMENT_WARPS),
            int(_LANE_ROWS), int(_CLUSTER), stream)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} ({outputs}) kernel launch "
                           f"failed: CUDA error {rc}")
    return _kernel_scalars(out, width), state


def pair_units(qlen, rlen) -> np.ndarray:
    """The packed form's units of a batch from its host lengths: (ceil(B /
    2), 2) int32 pair indices, neighbours after a sort by (qlen, rlen), so
    that the two halves of a lane sweep nearly the same shape; -1 beside
    an odd one out.  One key a pair and an unstable sort (pairs of one
    shape may come in any order), which takes far less host time than a
    lexical sort on large bins."""
    qlen, rlen = np.asarray(qlen), np.asarray(rlen)
    key = qlen.astype(np.int64) * (int(rlen.max(initial=0)) + 1) + rlen
    order = np.argsort(key).astype(np.int32)
    if len(order) % 2:
        order = np.append(order, np.int32(-1))
    return order.reshape(-1, 2)


def packed_usable(open_, ext, bound) -> bool:
    """Do penalties ``open_`` / ``ext`` and scores of |value| at most
    ``bound`` leave the packed form a band (``csrc/segment16.cuh``,
    ``seg16_usable``)?"""
    open_, ext, bound = int(open_), int(ext), int(bound)
    return (min(open_, ext, bound) >= 0 and
            max(open_, ext, bound) <= SEG16_MAX_GUARD and
            2 * (open_ + ext + bound) + 2 <= SEG16_MAX_GUARD)


def _block16_launch(ridx, qlen, rlen, state, dims, units, bound, tail, *,
                    open_, ext, mode, free, width, table, qidx,
                    profile) -> tuple[dict, dict]:
    """Launch the packed score form (``pt_scan_segment16``) on ``dims`` =
    (B, Bq, Qp, R, A) for the ``units``; ``tail`` is (col_offset,
    resume), ``state`` None makes a new one.  Returns (the per-pair
    outputs with ``over16``, state) and counts the launch."""
    global SEGMENT16_LAUNCHES
    from . import _build

    B, Bq, Qp, R, A = dims
    dev = ridx.device
    i32 = torch.int32
    subs = table if table is not None else profile
    if bound is None:
        bound = int(subs.abs().max()) if subs.numel() else 0
    if not packed_usable(open_, ext, bound) or (profile is not None
                                                and Bq != 1):
        raise ValueError("the packed form needs penalties and scores with "
                         "a 16-bit band and a table or one query's profile")
    if not isinstance(units, torch.Tensor) or units.dtype != i32 or \
            units.device != dev or units.dim() != 2 or \
            units.shape[1] != 2 or not units.is_contiguous():
        raise ValueError(f"units must be a contiguous int32 (U, 2) tensor "
                         f"on {dev}")
    if state is None:
        state = {"h": torch.empty((B, Qp), dtype=i32, device=dev),
                 "f": torch.empty((B, Qp), dtype=i32, device=dev),
                 "acc": torch.empty((B, 8), dtype=i32, device=dev),
                 "over": torch.empty((B,), dtype=i32, device=dev)}
    U = int(units.shape[0])
    bottom = torch.empty((U, 2, max(R, 1)), dtype=i32, device=dev)
    out = torch.empty((6, B), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = _build.load().pt_scan_segment16(
            subs.data_ptr(), qidx.data_ptr() if table is not None else None,
            ridx.data_ptr(), qlen.data_ptr(), rlen.data_ptr(),
            units.data_ptr(), bottom.data_ptr(), state["h"].data_ptr(),
            state["f"].data_ptr(), state["acc"].data_ptr(),
            state["over"].data_ptr(), out.data_ptr(), U, B, Bq, Qp, R, A,
            int(open_), int(ext), MODES[mode], _free_bits(free), *tail,
            int(bound), int(SEGMENT_WARPS), int(_LANE_ROWS), int(_CLUSTER),
            stream)
    if rc != 0:
        raise RuntimeError(f"pt_scan_segment16 kernel launch failed: CUDA "
                           f"error {rc}")
    SEGMENT16_LAUNCHES += 1
    stages.count("launches")
    res = _kernel_scalars(out[:5], width)
    res["over16"] = out[5]
    return res, state


def segment16_plan(U, Qs, ncols, A, profile=False) -> tuple:
    """(rows a lane, warps a block, blocks a unit) that the packed form's
    launcher takes for ``U`` units of ``Qs`` rows by ``ncols`` columns
    (``csrc/segment16.cuh``, ``seg16_plan``), under the current
    :data:`SEGMENT_WARPS` and overrides.  Builds the kernels."""
    from . import _build

    plan = (ctypes.c_int * 3)()
    _build.load().pt_segment16_plan(
        int(U), int(Qs), int(ncols), int(A), int(bool(profile)),
        int(SEGMENT_WARPS), int(_LANE_ROWS), int(_CLUSTER),
        ctypes.cast(plan, ctypes.c_void_p))
    return tuple(plan)


def block_plan(outputs, B, Qs, ncols, A, profile=False) -> tuple:
    """(rows a lane, warps a block, blocks a pair) that the block kernel's
    launcher takes for a launch of class ``outputs`` on ``B`` pairs of
    ``Qs`` state rows by ``ncols`` columns (``csrc/score_cell.cuh``,
    ``seg_plan``), under the current :data:`SEGMENT_WARPS` and overrides.
    Builds the kernels (it asks the library's own rule)."""
    from . import _build

    plan = (ctypes.c_int * 3)()
    _build.load().pt_block_plan(
        OUTPUTS.index(outputs), int(B), int(Qs), int(ncols), int(A),
        int(bool(profile)), int(SEGMENT_WARPS), int(_LANE_ROWS),
        int(_CLUSTER), ctypes.cast(plan, ctypes.c_void_p))
    return tuple(plan)


def score_segment_plain(ridx_seg, qlen, rlen, state=None, *, open_, ext,
                        mode, free, width="32", outputs="score",
                        col_offset=0, resume=False, table=None, qidx=None,
                        profile=None) -> tuple[dict, dict]:
    """Plain PyTorch version of :func:`score_segment`, same signature and
    outputs (it returns a new state and leaves the one it was given).

    The segment's cells are filled by the wavefront
    (:func:`~.wavefront.wavefront_align` with ``segment=True``), started
    from the carried boundary column; the segment's first maximum then
    replaces the carried one if it is ahead in the end cell's order (H
    descending, i ascending, j ascending: columns arrive in order over
    the segments, rows do not), and the outputs are read off the
    accumulator as :func:`score_align_plain` reads them off its sweep.
    """
    B, Bq, Qp, Rseg, A = _check_segment(
        ridx_seg, qlen, rlen, state, table, qidx, profile, mode, width,
        outputs, col_offset, resume)
    dev = ridx_seg.device
    open_, ext = int(open_), int(ext)
    stats = outputs == "stats"
    left = None
    if resume:
        left = {"h": state["h"], "f": state["f"]}
        if stats:
            left["pay"] = state["stats"]
    seg = wavefront_align(
        _substitution_rows(table, qidx, profile), qidx, ridx_seg, qlen, rlen,
        open_=open_, ext=ext, mode=mode, free=free, outputs=outputs,
        col_offset=int(col_offset), left=left, segment=True)

    acc = merge_acc(state["acc"] if resume else acc_init(B, Qp, mode, dev),
                    _sweep_acc(seg, stats))
    new_state = {"h": seg["h"].contiguous(), "f": seg["f"].contiguous(),
                 "acc": acc}
    if stats:
        new_state["stats"] = seg["pay"].contiguous()
    out = acc_outputs(acc, qlen, rlen, Qp, open_=open_, ext=ext, mode=mode,
                      free=free, width=width, outputs=outputs)
    if outputs == "trace":
        out["trace_table_seg"] = seg["trace_table"]
    return out, new_state


def acc_init(B, Qp, mode, device) -> torch.Tensor:
    """The (B, 8) accumulator before any cell: SW's empty alignment, 0 at
    (0, 0); otherwise no candidate, -2^30 at (Qp, 2^30)."""
    acc = torch.zeros((B, 8), dtype=torch.int32, device=device)
    if mode != "sw":
        acc[:, 0], acc[:, 1], acc[:, 2] = NEG_INF32, Qp, BIG
    return acc


def _sweep_acc(seg, stats) -> torch.Tensor:
    """A raw wavefront sweep (``segment=True``) as an accumulator."""
    B = seg["best"].shape[0]
    pay = seg["best_pay"] if stats else seg["best"].new_zeros((3, B))
    return torch.stack([seg["best"], seg["best_i"], seg["best_j"],
                        seg["hmax"], seg["hmin"], *pay],
                       dim=1).to(torch.int32)


def merge_acc(a, b) -> torch.Tensor:
    """Two (B, 8) accumulators over disjoint cells -> the one over both:
    the best cell ahead in the end cell's order (H descending, i
    ascending, j ascending: cells arrive in neither row nor column order
    over segments, tiles and shards) with its payload, the larger maximum
    and the smaller minimum of H (``seg_merge`` in csrc/score_cell.cuh)."""
    ahead = (b[:, 0] > a[:, 0]) | ((b[:, 0] == a[:, 0]) & (
        (b[:, 1] < a[:, 1]) | ((b[:, 1] == a[:, 1]) & (b[:, 2] < a[:, 2]))))
    out = torch.where(ahead[:, None], b, a)
    out[:, 3] = torch.maximum(a[:, 3], b[:, 3])
    out[:, 4] = torch.minimum(a[:, 4], b[:, 4])
    return out.contiguous()


def acc_outputs(acc, qlen, rlen, Qp, *, open_, ext, mode, free, width,
                outputs) -> dict:
    """The per-pair outputs read off a (B, 8) accumulator, as
    :func:`score_align_plain` reads them off its sweep (``seg_finish`` in
    csrc/score_cell.cuh): NW ends at (qlen - 1, rlen - 1), a non-local
    pair with an empty side takes :func:`~.wavefront.empty_side`, decided
    from the whole lengths, and the extremes give the saturation flags."""
    i32 = torch.int32
    open_, ext = int(open_), int(ext)
    local = mode == "sw"
    qb, qe, db, de = (True,) * 4 if local else tuple(bool(x) for x in free)
    score = acc[:, 0]
    eq, er = (qlen - 1, rlen - 1) if mode == "nw" else (acc[:, 1], acc[:, 2])
    pay = [acc[:, 5], acc[:, 6], acc[:, 7]]
    if not local:
        def border(c, is_free):
            if is_free:
                return torch.zeros_like(c)
            return torch.where(c > 0, -(open_ + (c - 1) * ext),
                               torch.zeros_like(c))

        score, eq, er, elen, empty = empty_side(
            score, eq, er, qlen, rlen, Qp,
            int(rlen.max()) if rlen.numel() else 0, border, qb,
            qe and mode == "sg", db, de and mode == "sg")
        pay = [torch.where(empty, 0, pay[0]), torch.where(empty, 0, pay[1]),
               torch.where(empty, elen, pay[2])]
    hmax, hmin = acc[:, 3], acc[:, 4]
    out = flag_outputs(
        score.to(i32), eq.to(i32), er.to(i32),
        (hmax >= WIDTH_MAX["8"]) | (hmin <= WIDTH_MIN["8"]),
        (hmax >= WIDTH_MAX["16"]) | (hmin <= WIDTH_MIN["16"]), width)
    if outputs == "stats":
        out.update(zip(STATS_KEYS, (p.to(i32) for p in pay)))
    return out


# -- the tile form (kernel K3) -------------------------------------------------


def _borders(open_, ext, mode, free):
    local = mode == "sw"
    qb, _, db, _ = (True,) * 4 if local else tuple(bool(x) for x in free)
    open_, ext = int(open_), int(ext)

    def border(c, is_free):
        if is_free:
            return torch.zeros_like(c)
        return torch.where(c > 0, -(open_ + (c - 1) * ext),
                           torch.zeros_like(c))

    return border, qb, db


def rowseg_left_border(B, row_offset, q_chunk, *, open_, ext, mode, free,
                       outputs, device) -> dict:
    """The right-going state a tile of the FIRST column shard reads: the
    bordered left column at rows [``row_offset``, ``row_offset`` +
    ``q_chunk``), F = -2^30, and the corner H[row_offset - 1][-1] (the
    reference's ``bstate``, dist/seqpar_scan.py:149-175).  No ``acc``."""
    border, _, db = _borders(open_, ext, mode, free)
    i32 = torch.int32
    r0 = int(row_offset)
    ig = torch.arange(r0, r0 + q_chunk, dtype=i32, device=device)
    zeros = torch.zeros((B, q_chunk), dtype=i32, device=device)
    t = torch.zeros((B, 4), dtype=i32, device=device)
    t[:, 0] = border(torch.tensor(r0, dtype=i32, device=device), db)
    state = {"h": border(ig + 1, db)[None].expand(B, q_chunk).contiguous(),
             "f": torch.full_like(zeros, NEG_INF32), "t": t}
    if outputs == "stats":
        t[:, 3] = 0 if db else r0
        hl = zeros if db else (ig + 1)[None].expand(B, q_chunk)
        state["stats"] = torch.stack([zeros, zeros, hl, zeros, zeros, zeros])
    return state


def rowseg_top_border(B, col_offset, cols, *, open_, ext, mode, free,
                      outputs, device) -> torch.Tensor:
    """The down-state a tile of the FIRST row chunk reads, (B, 2 or 8,
    cols): the top border H[-1][j] at columns [``col_offset``,
    ``col_offset`` + ``cols``), E = -2^30, and for the stats class the
    border's payload (0, 0, characters consumed unless free) and E's
    zeros."""
    border, qb, _ = _borders(open_, ext, mode, free)
    i32 = torch.int32
    jg = torch.arange(int(col_offset), int(col_offset) + cols, dtype=i32,
                      device=device)
    down = torch.zeros((B, 8 if outputs == "stats" else 2, cols), dtype=i32,
                       device=device)
    down[:, 0] = border(jg + 1, qb)
    down[:, 1] = NEG_INF32
    if outputs == "stats" and not qb:
        down[:, 4] = jg + 1
    return down


def _check_rowseg(ridx_seg, qlen, rlen, state, down, table, qidx, profile,
                  mode, width, outputs, row_offset, q_chunk, col_offset):
    """Validate a tile call; return (B, Bq, Qp, C, A)."""
    if outputs not in SEGMENT_OUTPUTS:
        raise ValueError(f"outputs {outputs!r}: the tile form serves "
                         f"{SEGMENT_OUTPUTS}")
    dims = _check(ridx_seg, qlen, rlen, table, qidx, profile, mode, width,
                  outputs)
    B, _, Qp, C, _ = dims
    r0, qc, off = int(row_offset), int(q_chunk), int(col_offset)
    if C < 1:
        raise ValueError("a tile needs at least one column")
    if qc < 1 or r0 < 0 or r0 + qc > Qp:
        raise ValueError(f"rows [{r0}, {r0 + qc}) lie outside the padded "
                         f"query (Qp = {Qp})")
    if not 0 <= off < 2 ** 31:
        raise ValueError(f"col_offset {off}")
    want = {"h": (B, qc), "f": (B, qc), "t": (B, 4), "acc": (B, 8)}
    if outputs == "stats":
        want["stats"] = (6, B, qc)
    given = dict(state, down=down)
    want["down"] = (B, 8 if outputs == "stats" else 2, C)
    for name, shape in want.items():
        t = given.get(name)
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or \
                tuple(t.shape) != shape or t.device != ridx_seg.device or \
                not t.is_contiguous():
            where = "down" if name == "down" else f"state[{name!r}]"
            raise ValueError(f"{where} must be a contiguous int32 {shape} "
                             f"tensor on {ridx_seg.device}")
    return dims


def score_rowseg(ridx_seg, qlen, rlen, state, down, *, open_, ext, mode,
                 free, width="32", outputs="score", row_offset, q_chunk,
                 col_offset, table=None, qidx=None, profile=None):
    """One tile of a sequence-parallel score, stats or trace fill: query
    rows [``row_offset``, ``row_offset`` + ``q_chunk``) by the columns
    [``col_offset``, ``col_offset`` + C) of ``ridx_seg`` (B, C).

    ``qlen`` / ``rlen`` are the pairs' WHOLE lengths and the substitution
    inputs :func:`score_align`'s over the whole padded query: the tile
    reads its own rows of them.  Every border is given, none computed:

    - ``state``: what the tile to the left returned, or for the first
      shard :func:`rowseg_left_border`: ``h`` and ``f`` (B, q_chunk), H
      and F of the tile's rows at the pair's last column so far; ``t``
      (B, 4), the corner H[row_offset - 1][col_offset - 1] and its
      payload; for the stats class ``stats`` (6, B, q_chunk); and ``acc``
      (B, 8), the accumulator of THIS shard (:func:`acc_init` before its
      first tile), which does not travel with the rest.
    - ``down`` (B, 2 or 8, C): what the tile above on this shard
      returned, or for the first row chunk :func:`rowseg_top_border`: H
      and E of row ``row_offset`` - 1 per column (stats: and their
      payloads).

    Returns ``(out, state, down, trace_tile)``, all new tensors: the
    state for the tile to the right (a pair with no column here keeps
    what it was given; ``t`` is ``down`` as given at the last column),
    ``acc`` folded with this tile's cells; ``down`` for the tile below
    (the tile's last row where the pair has that row and the column,
    the given value elsewhere); ``out``, the outputs read off ``acc`` as
    :func:`acc_outputs` reads them; and for the trace class the tile's
    (B, q_chunk, C) int8 flags, 0 outside each pair's cells, else None.
    Tiles may run in any order that respects the two flows; the shards'
    accumulators are merged by :func:`merge_acc`.
    """
    B, Bq, Qp, C, A = _check_rowseg(
        ridx_seg, qlen, rlen, state, down, table, qidx, profile, mode, width,
        outputs, row_offset, q_chunk, col_offset)
    dev = ridx_seg.device
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, width=width,
              outputs=outputs, row_offset=row_offset, q_chunk=q_chunk,
              col_offset=col_offset, table=table, qidx=qidx, profile=profile)
    if dev.type == "cpu":
        return score_rowseg_plain(ridx_seg, qlen, rlen, state, down, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    global ROWSEG_LAUNCHES
    from . import _build

    lib = _build.load()
    stats = outputs == "stats"
    qc = int(q_chunk)
    # the kernel works in place: on copies, so that what the caller gave
    # (a message from another rank, a border) stays as it was
    new = {k: state[k].clone() for k in ("h", "f", "acc")}
    if stats:
        new["stats"] = state["stats"].clone()
    new["t"] = torch.empty((B, 4), dtype=torch.int32, device=dev)
    new_down = down.clone()
    bottom = torch.empty_like(down)       # scratch between groups of rows
    out = torch.empty((8 if stats else 5, B), dtype=torch.int32, device=dev)
    tile = (torch.zeros((B, qc, C), dtype=torch.int8, device=dev)
            if outputs == "trace" else None)
    subs = table if table is not None else profile
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.pt_scan_rowseg(
            OUTPUTS.index(outputs), subs.data_ptr(),
            qidx.data_ptr() if table is not None else None,
            _ptr(qidx if stats else None), ridx_seg.data_ptr(),
            qlen.data_ptr(), rlen.data_ptr(), bottom.data_ptr(),
            new_down.data_ptr(), new["h"].data_ptr(), new["f"].data_ptr(), _ptr(new.get("stats")),
            new["acc"].data_ptr(), out.data_ptr(), _ptr(tile),
            state["t"].data_ptr(), new["t"].data_ptr(), B, Bq,
            qidx.shape[0] if stats else 0, Qp, C, A, int(open_), int(ext),
            MODES[mode], _free_bits(free), int(col_offset), int(row_offset),
            qc, int(SEGMENT_WARPS), int(_LANE_ROWS), int(_CLUSTER), stream)
    if rc != 0:
        raise RuntimeError(
            f"scan_rowseg ({outputs}) kernel launch failed: CUDA error {rc}")
    ROWSEG_LAUNCHES += 1
    stages.count("launches")
    return _kernel_scalars(out, width), new, new_down, tile


def score_rowseg_plain(ridx_seg, qlen, rlen, state, down, *, open_, ext,
                       mode, free, width="32", outputs="score", row_offset,
                       q_chunk, col_offset, table=None, qidx=None,
                       profile=None):
    """Plain PyTorch version of :func:`score_rowseg`, same signature and
    outputs: the wavefront (:func:`~.wavefront.wavefront_align` with
    ``segment=True`` and ``top``) over the tile's rows and columns, from
    the given left column, row above and corner; the tile's first
    maximum is folded into the shard's accumulator by :func:`merge_acc`."""
    B, Bq, Qp, C, A = _check_rowseg(
        ridx_seg, qlen, rlen, state, down, table, qidx, profile, mode, width,
        outputs, row_offset, q_chunk, col_offset)
    stats = outputs == "stats"
    r0, qc = int(row_offset), int(q_chunk)
    rows = slice(r0, r0 + qc)
    qx = None if qidx is None else qidx[:, rows]
    left = {"h": state["h"], "f": state["f"]}
    if stats:
        left["pay"] = state["stats"]
    seg = wavefront_align(
        _substitution_rows(table, qx,
                           None if profile is None else profile[:, rows]),
        qx, ridx_seg, qlen, rlen, open_=int(open_), ext=int(ext), mode=mode,
        free=free, outputs=outputs, col_offset=int(col_offset), left=left,
        segment=True, row_offset=r0, top=down, corner=state["t"],
        qp_total=Qp)
    acc = merge_acc(state["acc"], _sweep_acc(seg, stats))
    last = down[:, :, C - 1]
    new = {"h": seg["h"].contiguous(), "f": seg["f"].contiguous(),
           "t": torch.cat([last[:, :1], last[:, 2:5] if stats
                           else last.new_zeros((B, 3))], dim=1).contiguous(),
           "acc": acc}
    if stats:
        new["stats"] = seg["pay"].contiguous()
    out = acc_outputs(acc, qlen, rlen, Qp, open_=open_, ext=ext, mode=mode,
                      free=free, width=width, outputs=outputs)
    return out, new, seg["down"], seg.get("trace_table")


# -- the chunked form (kernel K1f) ---------------------------------------------


def score_chunked(ridx, qlen, rlen, *, open_, ext, mode, free, width="32",
                  table=None, qidx=None, profile=None,
                  outputs="score", units=None, bound=None) -> dict:
    """:func:`score_align` for long pairs: the same inputs and outputs,
    every class, one launch of the block kernel over all Rp columns (the
    module docstring).  On the card the trace plane is a contiguous
    (B, Qp, Rp) tensor, the tables (B, Qp, Rp) views of (B, Rp, Qp)
    buffers, the rows and columns contiguous (B, Rp) / (B, Qp).
    ``units`` / ``bound``: the score class on the packed form, with
    ``over16``, as :func:`score_segment`'s."""
    if units is not None and outputs != "score":
        raise ValueError("units: the packed form is the score class's")
    B, Bq, Qp, Rp, A = _check(ridx, qlen, rlen, table, qidx, profile, mode,
                              width, outputs)
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, width=width,
              table=table, qidx=qidx, profile=profile, outputs=outputs)
    if ridx.device.type == "cpu":
        out = score_align_plain(ridx, qlen, rlen, **kw)
        if units is not None:
            out["over16"] = torch.zeros(B, dtype=torch.int32)
        return out
    if ridx.device.type != "cuda":
        raise ValueError(f"no kernel for device {ridx.device}")
    if units is not None:
        kw.pop("outputs")
        return _block16_launch(ridx, qlen, rlen, None, (B, Bq, Qp, Rp, A),
                               units, bound, (0, 0), **kw)[0]
    return _chunked_launch(ridx, qlen, rlen, (B, Bq, Qp, Rp, A), **kw)


def _chunked_launch(ridx, qlen, rlen, dims, *, open_, ext, mode, free,
                    width, table, qidx, profile, outputs,
                    bandwidth=None) -> dict:
    """Launch the block kernel once over all Rp columns in class
    ``outputs`` (:func:`score_chunked`), or with ``bandwidth`` (clamped
    to [-1, Qp + Rp]) its masked form (``pt_scan_chunked_banded``, every
    class); count an unbanded launch (the caller counts a banded one)."""
    global CHUNKED_LAUNCHES
    from . import _build

    B, Bq, Qp, Rp, A = dims
    dev = ridx.device
    lib = _build.load()
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, width=width,
              table=table, qidx=qidx, profile=profile, outputs=outputs,
              ridx=ridx, qlen=qlen, rlen=rlen, state=None, dims=dims)
    nplanes = 4 if outputs in STATS_CLASSES else 1
    plane = tab = rows = cols = None
    if outputs == "trace":
        plane = torch.zeros((B, Qp, Rp), dtype=torch.int8, device=dev)
    elif outputs in ("table", "stats_table"):
        tab = torch.zeros((nplanes, B, Rp, Qp), dtype=torch.int32, device=dev)
    elif outputs in ("rowcol", "stats_rowcol"):
        rows = torch.zeros((nplanes, B, Rp), dtype=torch.int32, device=dev)
        cols = torch.zeros((nplanes, B, Qp), dtype=torch.int32, device=dev)
    if bandwidth is not None:
        # every class in one entry, its planes and the band after `out`
        res, _ = _block_launch(lib.pt_scan_chunked_banded,
                               planes=(plane, tab, rows, cols),
                               tail=(int(bandwidth),), **kw)
    elif outputs in SEGMENT_OUTPUTS:
        # the segment form from column 0 (csrc/scan_chunked.cu): one
        # segment of Rp columns, whose trace buffer is the whole plane
        res, _ = _block_launch(lib.pt_scan_segment, planes=(plane,),
                               tail=(0, 0), **kw)
    else:
        res, _ = _block_launch(lib.pt_scan_chunked,
                               planes=(tab, rows, cols), tail=(), **kw)
    if bandwidth is None:
        CHUNKED_LAUNCHES += 1
        stages.count("launches")
    if plane is not None:
        res["trace_table"] = plane
    for k, name in enumerate(PLANES[:nplanes]):
        if tab is not None:
            res[f"{name}_table"] = tab[k].transpose(1, 2)
        if rows is not None:
            res[f"{name}_row"] = rows[k]
            res[f"{name}_col"] = cols[k]
    return res
