"""Aligner and AlignerBuilder on PyTorch.

The port of ``parasail_rs_tpu.engine.aligner``, every public method: the
builder keeps every configuration method and its mutual-exclusion rules
(reference src/aligner/mod.rs:213-267); ``align`` / ``align_batch`` run
one kernel launch per batch on the aligner's device, for every output
class (score, stats, table, stats_table, rowcol, stats_rowcol, trace);
``align_many`` and ``align_cigars`` length-bin and launch every bin
before the first fetch (one loop, :meth:`Aligner._binned`); ``cigars``
walks fetched trace planes on the host and ``align_cigars`` walks them
on the device, fetching only opcodes;
``banded_nw`` / ``banded_nw_batch`` run the banded score kernel;
``ssw`` / ``ssw_batch`` run the SW trace kernel and the device walk, or
for long pairs the three-pass windowed pipeline on ``align_many``.
"""

from __future__ import annotations

import functools
import gc
import logging
import threading
from collections import Counter
from itertools import repeat

import numpy as np
import torch

from .. import constants
from ..errors import (
    InteriorNulByte,
    NoBandwidth,
    NoTrace,
    QueryRequired,
)
from ..golden.model import free_flags
from ..matrices import Matrix
from ..utils import profiling, stages
from ..utils.gcpause import gc_pause

from ..ops.specs import KernelKey
from . import binning, dispatch
from .binning import lengths
from .profile import Profile
from .result import Alignment, BatchRecord, SSWResult

log = logging.getLogger("parasail_rs_tpu_torch")


# whether this thread is inside a public call already: a call that
# another public call makes (``align`` -> ``align_batch``) counts nothing
_in_call = threading.local()


def _collections() -> int:
    """Cyclic collections of every generation since the process began."""
    return sum(g["collections"] for g in gc.get_stats())


def _call_region(method):
    """Open the region ``pt.call.<method>`` around a public call (a
    ``record_function`` under torch's profiler, an NVTX range on a
    card).  While spans are on, the outermost call of a thread counts
    the collector's runs that start inside it (``gc_collections``;
    the collector is process-wide, so another thread's allocations may
    start one)."""
    name = "pt.call." + method.__name__

    @functools.wraps(method)
    def call(*args, **kwargs):
        with profiling.trace_region(name):
            if not stages.enabled or getattr(_in_call, "on", False):
                return method(*args, **kwargs)
            _in_call.on = True
            n0 = _collections()
            try:
                return method(*args, **kwargs)
            finally:
                _in_call.on = False
                stages.count("gc_collections", _collections() - n0)

    return call


def _as_bytes(x) -> bytes:
    b = x.encode() if isinstance(x, str) else bytes(x)
    if 0 in b:
        raise InteriorNulByte("sequence contains an interior NUL byte")
    return b


def resolve_device(device) -> torch.device:
    """The device an aligner runs on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch version")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {dev.index}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class AlignerBuilder:
    """Builder for :class:`Aligner` (reference: src/aligner/mod.rs:67-370).

    Defaults mirror the reference: global (nw) mode, ``sat`` width, the
    identity DNA matrix, gap_open = gap_extend = 0, no profile, striped
    strategy, score-only output; plus the device, ``cuda`` by default.
    """

    def __init__(self):
        self._mode = "nw"
        self._solution_width = "sat"
        self._matrix = Matrix.default()
        self._gap_open = 0
        self._gap_extend = 0
        self._profile = Profile.default()
        self._allow_query_gaps: list[str] = []
        self._allow_ref_gaps: list[str] = []
        self._vec_strategy = "striped"
        self._use_stats = False
        self._use_table = ""          # "" | "table" | "rowcol"
        self._use_trace = False
        self._bandwidth: int | None = None
        self._device = "cuda"

    # -- mode ----------------------------------------------------------------
    def global_(self) -> "AlignerBuilder":
        self._mode = "nw"
        return self

    def semi_global(self) -> "AlignerBuilder":
        self._mode = "sg"
        return self

    def local(self) -> "AlignerBuilder":
        self._mode = "sw"
        return self

    # -- width / matrix / gaps -------------------------------------------------
    def solution_width(self, solution_width: int | str) -> "AlignerBuilder":
        self._solution_width = str(solution_width)
        return self

    def matrix(self, matrix: Matrix) -> "AlignerBuilder":
        self._matrix = matrix
        return self

    def gap_open(self, gap_open: int) -> "AlignerBuilder":
        self._gap_open = int(gap_open)
        return self

    def gap_extend(self, gap_extend: int) -> "AlignerBuilder":
        self._gap_extend = int(gap_extend)
        return self

    # -- profile ---------------------------------------------------------------
    def profile(self, profile: Profile) -> "AlignerBuilder":
        self._profile = profile
        return self

    # -- semi-global free ends -------------------------------------------------
    def allow_query_gaps(self, allow_gaps: list[str]) -> "AlignerBuilder":
        self._allow_query_gaps = list(allow_gaps)
        return self

    def allow_ref_gaps(self, allow_gaps: list[str]) -> "AlignerBuilder":
        self._allow_ref_gaps = list(allow_gaps)
        return self

    # -- strategy (accepted and reported; one kernel serves all) ---------------
    def striped(self) -> "AlignerBuilder":
        self._vec_strategy = "striped"
        return self

    def scan(self) -> "AlignerBuilder":
        self._vec_strategy = "scan"
        return self

    def diag(self) -> "AlignerBuilder":
        self._vec_strategy = "diag"
        return self

    # -- outputs with mutual exclusion (src/aligner/mod.rs:213-267) ------------
    def use_stats(self) -> "AlignerBuilder":
        self._use_stats = True
        if self._use_trace:
            log.warning(
                "Warning: Traceback was enabled previously, but not supported "
                "with stats. Disabling traceback")
            self._use_trace = False
        return self

    def use_table(self) -> "AlignerBuilder":
        self._use_table = "table"
        if self._use_trace:
            self._use_trace = False
        return self

    def use_last_rowcol(self) -> "AlignerBuilder":
        self._use_table = "rowcol"
        return self

    def use_trace(self) -> "AlignerBuilder":
        self._use_trace = True
        if self._use_table:
            log.warning(
                "Warning: Table was enabled previously, but not supported "
                "with traceback. Disabling table")
            self._use_table = ""
        if self._use_stats:
            log.warning(
                "Warning: Stats were enabled previously, but not supported "
                "with traceback. Disabling stats")
            self._use_stats = False
        return self

    # -- banded ----------------------------------------------------------------
    def bandwidth(self, bandwidth: int) -> "AlignerBuilder":
        self._bandwidth = int(bandwidth)
        return self

    # -- device (port extra) ---------------------------------------------------
    def device(self, device: str | torch.device) -> "AlignerBuilder":
        """Where the aligner runs: ``"cuda"`` (default; the hand-written
        kernel) or ``"cpu"`` (the plain PyTorch version)."""
        self._device = device
        return self

    # -- build -----------------------------------------------------------------
    def build(self) -> "Aligner":
        profile = self._profile
        has_profile = not profile.is_null
        stats = profile.use_stats if has_profile else self._use_stats
        if self._use_trace:
            outputs = "trace"
        elif self._use_table == "table":
            outputs = "stats_table" if stats else "table"
        elif self._use_table == "rowcol":
            outputs = "stats_rowcol" if stats else "rowcol"
        elif stats:
            outputs = "stats"
        else:
            outputs = "score"
        key = KernelKey(
            mode=self._mode,
            free=free_flags(self._mode, self._allow_query_gaps,
                            self._allow_ref_gaps),
            outputs=outputs,
            strategy=self._vec_strategy,
            profile=has_profile,
            width=self._solution_width,
        )
        matrix = profile.matrix if has_profile else self._matrix
        return Aligner(
            key=key,
            matrix=matrix,
            gap_open=self._gap_open,
            gap_extend=self._gap_extend,
            profile=profile,
            bandwidth=self._bandwidth,
            device=resolve_device(self._device),
        )


class Aligner:
    """Configured aligner (reference: src/aligner/mod.rs:372-535).

    Construct via ``Aligner.new()`` (returns a builder).
    """

    # whether results are banded_nw_batch's (set on :meth:`_band`)
    _banded = False

    def __init__(self, key: KernelKey, matrix: Matrix, gap_open: int,
                 gap_extend: int, profile: Profile, bandwidth: int | None,
                 device: torch.device):
        self.key = key
        self.matrix = matrix
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.profile = profile
        self.bandwidth = bandwidth
        self.device = device
        self.vec_strategy = key.strategy
        # every routing decision of this aligner's batches, keyed
        # (route, reason)
        self.route_counter: Counter = Counter()
        if matrix.approximate:
            log.warning(
                "Aligner built with synthesised builtin matrix %r — scores "
                "are NOT bit-exact vs parasail; register exact NCBI data "
                "(matrices.register_ncbi_dir / PT_NCBI_MATRICES) for "
                "parity", matrix.name)

    @property
    def matrix_approximate(self) -> bool:
        return bool(self.matrix.approximate)

    @staticmethod
    def new() -> AlignerBuilder:
        return AlignerBuilder()

    # -- result construction helpers -------------------------------------------
    def _flags(self, outputs: str, saturated: bool,
               banded: bool = False) -> dict:
        """The predicate bits of a result of class ``outputs``; the
        banded mode is global."""
        key = self.key
        mode = "nw" if banded else key.mode
        return {
            "nw": mode == "nw",
            "sg": mode == "sg",
            "sw": mode == "sw",
            "striped": not banded and key.strategy == "striped",
            "scan": not banded and key.strategy == "scan",
            "diag": not banded and key.strategy == "diag",
            "banded": banded,
            "blocked": False,
            "saturated": saturated,
            "stats": outputs in ("stats", "stats_table", "stats_rowcol"),
            "table": outputs in ("table", "stats_table"),
            "stats_table": outputs == "stats_table",
            "rowcol": outputs in ("rowcol", "stats_rowcol"),
            "stats_rowcol": outputs == "stats_rowcol",
            "trace": outputs == "trace",
        }

    # -- alignment -------------------------------------------------------------
    @_call_region
    def align(self, query, reference) -> Alignment:
        """Align one pair.  With a profile set, pass ``query=None``."""
        return self.align_batch(
            None if query is None else [query], [reference])[0]

    def _pack(self, queries, references, Qp=None, Rp=None):
        if queries is None:
            if self.profile.is_null:
                raise QueryRequired(
                    "Query sequence is required for alignment without a "
                    "profile.")
            return dispatch.pack_pairs(
                self.matrix, None, references, profile=self.profile,
                Qp=Qp, Rp=Rp, device=self.device)
        return dispatch.pack_pairs(self.matrix, queries, references,
                                   Qp=Qp, Rp=Rp, device=self.device)

    def _on_route(self, route: str, reason: str) -> None:
        self.route_counter.update([(route, reason)])

    def _submit(self, batch, walk: bool = False):
        """This aligner's launch of a packed batch
        (:func:`dispatch.submit`); ``walk``: the trace class, walked on
        the device."""
        return dispatch.submit(
            batch, gap_open=self.gap_open, gap_extend=self.gap_extend,
            mode=self.key.mode, free=self.key.free,
            outputs="trace" if walk else self.key.outputs,
            width=self.key.width, on_route=self._on_route, walk=walk)

    def _alignments_from(self, out, qlens, rlens):
        """This aligner's results over fetched columns; a walk's (its
        begins, no plane) are score-class, as ``align_cigars`` returns
        them; a banded sub-aligner's (:meth:`_band`) carry the
        reference's banded flags, never saturated."""
        outputs = "score" if "beg_query" in out else self.key.outputs
        flags = self._flags(outputs, False, self._banded)
        return _alignments(
            out, qlens, rlens,
            (flags, flags if self._banded else self._flags(outputs, True)),
            self.matrix, self.key.free, self.key.mode)

    def _binned(self, queries, refs, bins, build, walk: bool = False):
        """Pack and submit every bin, then fetch them in order:
        ``build(columns, rows, qlens, rlens)`` gives a tuple of per-pair
        lists a bin, each scattered back to input order.  The cyclic
        collector pauses once over the whole call (``gc_pause`` of its
        pairs; the stages' own pauses nest inside it as no-ops)."""
        with gc_pause(len(refs)):
            pending = []
            for bin_ in bins:
                idx = bin_.indices
                with stages.stage("bins"):
                    bqs = (None if queries is None else
                           [queries[i] for i in idx])
                    brs = [refs[i] for i in idx]
                batch, bql, brl = self._pack(bqs, brs, Qp=bin_.qp,
                                             Rp=bin_.rp)
                pending.append((idx, bql, brl, self._submit(batch, walk)))
            outs = []
            for idx, bql, brl, pend in pending:
                parts = build(*pend.fetch(), bql, brl)
                with stages.stage("bins"):
                    outs = outs or [[None] * len(refs) for _ in parts]
                    for out, part in zip(outs, parts):
                        for i, v in zip(idx, part):
                            out[i] = v
            return outs

    # pairs per device-walk launch: a walked bin splits into launches
    # whose pack, kernels and copy are all enqueued before the first
    # fetch blocks, so launch k's transfer overlaps launch k+1's work
    # (the reference's value, chosen on its own device; not yet measured
    # on the card)
    _CIGAR_CHUNK = 512

    def _walk_bins(self, qlens, rlens):
        """The bins of trace planes walked where they are made, split into
        launches of :attr:`_CIGAR_CHUNK` pairs.  Width 64's exact host
        merge brings the plane to the host: its bins take the host's
        cap."""
        return binning.split_bins(
            binning._shape_bins(
                qlens, rlens, True,
                plane_on=None if self.key.width == "64" else self.device),
            self._CIGAR_CHUNK)

    @_call_region
    def align_batch(self, queries, references) -> list[Alignment]:
        """Batched alignment: one kernel launch covers the whole batch.

        ``queries=None`` (profile mode) aligns the profile query against
        every reference; otherwise ``queries`` and ``references`` are
        parallel lists of byte sequences.
        """
        if len(references) == 0:
            return []
        if not self.profile.is_null:
            # parity: with a profile set the reference dispatches the
            # profile function and ignores any passed query
            queries = None
        batch, qlens, rlens = self._pack(queries, references)
        return self._alignments_from(self._submit(batch).fetch()[0], qlens,
                                     rlens)

    @_call_region
    def align_many(self, queries, references,
                   max_cells: int | None = None) -> list[Alignment]:
        """Length-binned batched alignment: pairs are grouped by padded
        shape (``parasail_rs_tpu.batch``) so a 100 bp pair never pays a
        10 kbp tile; results return in input order.

        ``max_cells`` caps B * Qp * Rp per launch; the defaults, lane
        quantum and launch caps are the reference's (2^28 cells, 16
        launches for the trace and table classes, whose planes are
        cell-sized; 2^33 cells in groups of 128 pairs, 8 launches, for the
        rest).  Every bin is packed and launched before the first fetch
        (:func:`dispatch.submit`): the score and stats classes fetch every
        bin at the end, the classes with planes fetch each bin's planes
        as it completes.
        """
        with stages.stage("bins"):
            refs = list(references)
            if not refs:
                return []
            if not self.profile.is_null:
                queries = None      # parity: the profile takes precedence
            if queries is None:
                if self.profile.is_null:
                    raise QueryRequired(
                        "Query sequence is required for alignment without a "
                        "profile.")
                qlens = self.profile.query_len
            else:
                queries = list(queries)
                qlens = lengths(queries)
            bins = binning._shape_bins(
                qlens, lengths(refs),
                self.key.outputs in ("trace", "table", "stats_table"),
                max_cells)
        return self._binned(queries, refs, bins, lambda cols, _rows, ql, rl:
                            (self._alignments_from(cols, ql, rl),))[0]

    @_call_region
    def cigars(self, alignments, queries, references) -> list[str]:
        """Batched CIGAR extraction over trace results.

        The same strings as ``a.get_cigar(q, r)`` per pair, but ONE
        native batch walk (OpenMP over pairs, the reference's
        native/ptwalk.cc) instead of a per-pair round-trip.  Falls back
        to the per-pair path when the native walker is unavailable.
        """
        from ..constants import cigar_runs_string
        from ..native import walker

        alignments = list(alignments)
        if not alignments:
            return []
        if not alignments[0].is_trace():
            raise NoTrace("cigars()")
        mode = self.key.mode
        free = self.key.free if mode == "sg" else free_flags(mode)
        qb, _, db, _ = free
        with stages.stage("walk.host"):
            walked = walker.walk_batch(
                [a.fields["trace_table"] for a in alignments],
                queries, references,
                [a.get_end_query() for a in alignments],
                [a.get_end_ref() for a in alignments],
                local=mode == "sw", qb=qb, db=db)
            if walked is not None:
                return [cigar_runs_string(packed)
                        for packed, _bq, _br in walked]
        # the per-pair walks time themselves
        return [a.get_cigar(q, r)
                for a, q, r in zip(alignments, queries, references)]

    @_call_region
    def align_cigars(self, queries, references):
        """Batched alignment + CIGAR extraction with the DEVICE walk.

        Covers the same user intent as ``align`` + ``get_cigar`` per pair
        but never ships the (B, Qp, Rp) trace plane to the host: the
        trace kernel's plane stays on the device, the walk kernel
        (ops/trace_walk.py) walks every pair back from its end cell, and
        the host fetches only B * (Qp + Rp) opcode bytes plus the
        per-pair scalars, in one transfer per launch.

        Returns ``(alignments, cigars)``: score-class ``Alignment``
        objects (``is_trace()`` is False) and the CIGAR string per pair,
        identical to ``cigars()`` on a trace-enabled aligner.  With a
        profile set, ``queries`` is ignored.  Mixed-length inputs are
        length-binned (trace planes are cell-sized): on a card a launch
        holds up to a quarter of its memory of plane, a byte a cell
        (:func:`binning._plane_cells`), on the CPU and at width 64 the
        reference's 2^28 cells, in launches of at most
        :attr:`_CIGAR_CHUNK` pairs; every launch is enqueued before the
        first fetch, and results return in input order.
        """
        from ..ops.trace_walk import ops_to_runs_flat

        with stages.stage("bins"):
            refs = [_as_bytes(r) for r in references]
            if not refs:
                return [], []
            queries = (None if not self.profile.is_null
                       else [_as_bytes(q) for q in queries])
            qlens = (self.profile.query_len if queries is None
                     else lengths(queries))
            bins = self._walk_bins(qlens, lengths(refs))

        def build(cols, rows, qlens, rlens):
            alns = self._alignments_from(cols, qlens, rlens)
            # gc_pause: the string build allocates ~30 gc-tracked objects
            # per pair
            with stages.stage("encode"), gc_pause(len(rlens) * 8):
                return alns, constants.cigar_strings_batch(
                    *ops_to_runs_flat(rows))

        return tuple(self._binned(queries, refs, bins, build, walk=True))

    # -- banded global NW (src/aligner/mod.rs:457-489) ---------------------------
    def banded_nw(self, query, reference) -> Alignment:
        """Banded global alignment (reference -> parasail_nw_banded).

        Score-only, and ``bandwidth`` must have been set at build time.
        Cells with ``|i - j| > bandwidth`` (border cells included) are
        excluded; a pair whose corner lies outside the band scores -2^30.
        """
        return self.banded_nw_batch([query], [reference])[0]

    @_call_region
    def banded_nw_batch(self, queries, references) -> list[Alignment]:
        """Batched banded global alignment: one launch of the banded score
        kernel (NW, width 32) over the whole batch, built by the banded
        sub-aligner (:meth:`_band`)."""
        if self.bandwidth is None:
            raise NoBandwidth(
                "banded_nw() requires .bandwidth() on the builder")
        batch, qlens, rlens = self._pack(queries, references)
        band = self._band
        out = dispatch.execute(
            batch, gap_open=self.gap_open, gap_extend=self.gap_extend,
            mode="nw", free=(False,) * 4, outputs="score", width="32",
            on_route=band._on_route, banded=True, bandwidth=self.bandwidth)
        return band._alignments_from(out, qlens, rlens)

    @functools.cached_property
    def _band(self) -> "Aligner":
        """``banded_nw_batch``'s sub-aligner: global, no free ends, this
        aligner's class (the reference's flags name it), marked banded,
        sharing this one's route counter."""
        key = self.key
        sub = Aligner(
            key=KernelKey(mode="nw", free=(False,) * 4, outputs=key.outputs,
                          strategy=key.strategy, profile=key.profile,
                          width="32"),
            matrix=self.matrix, gap_open=self.gap_open,
            gap_extend=self.gap_extend, profile=self.profile,
            bandwidth=self.bandwidth, device=self.device)
        sub._banded = True
        sub.route_counter = self.route_counter
        return sub

    # -- SSW emulation (src/aligner/mod.rs:492-529) ------------------------------
    def ssw(self, query, reference) -> SSWResult:
        """Striped Smith-Waterman with begin coordinates and a raw CIGAR.

        Always local, with this aligner's matrix and gap penalties; with
        a profile set, pass ``query=None``.
        """
        return self.ssw_batch(
            None if query is None else [query], [reference])[0]

    def _sub(self, outputs: str, mode: str, profile: bool) -> "Aligner":
        """A width-sat sub-aligner of SSW, sharing this one's route
        counter."""
        sub = Aligner(
            key=KernelKey(mode=mode, free=(mode == "sw",) * 4,
                          outputs=outputs, strategy="striped",
                          profile=profile, width="sat"),
            matrix=self.matrix, gap_open=self.gap_open,
            gap_extend=self.gap_extend,
            profile=self.profile if profile else Profile.default(),
            bandwidth=None, device=self.device)
        sub.route_counter = self.route_counter
        return sub

    @_call_region
    def ssw_batch(self, queries, references,
                  windowed: bool | None = None) -> list[SSWResult]:
        """Batched SSW: one SW trace-kernel launch and one device walk for
        the whole set (begins and merged-M CIGAR runs come back; the flag
        plane never leaves the card).

        With a profile set and ``queries=None`` its ``score_size`` is
        honoured: 0 = 8-bit, where a pair whose 8-bit lanes saturate
        reports ``score1 = 255``; 1 and 2 cap at 65535.  ``windowed``
        selects the three-pass long-pair pipeline (:meth:`_ssw_windowed`);
        None turns it on, as the reference does, when 128-rounded pairs
        times the padded lengths exceed 4 << 30 cells; its windows' trace
        bins hold, as ``align_cigars``' do, up to a quarter of a card's
        memory (the reference's 2^28 cells on the CPU) and at most
        :attr:`_CIGAR_CHUNK` pairs a launch.  Its
        CIGARs may differ from the one-pass walk's in tie-broken op order
        only.
        """
        from ..utils.shapes import length_bucket

        from ..ops.trace_walk import ops_to_runs_batch

        refs = [_as_bytes(r) for r in references]
        use_profile = queries is None
        if use_profile:
            if self.profile.is_null:
                raise QueryRequired(
                    "Query sequence is required for SSW alignment for now.")
            qs = [self.profile.query] * len(refs)
        else:
            qs = [_as_bytes(q) for q in queries]
        if not refs:
            return []
        score_size = self.profile.score_size if use_profile else None
        if windowed is None:
            Bpad = (len(refs) + 127) // 128 * 128
            Qp = length_bucket(max(len(q) for q in qs))
            Rp = length_bucket(max(len(r) for r in refs))
            windowed = Bpad * Qp * Rp > 4 << 30
        if windowed:
            return self._ssw_windowed(qs, refs, use_profile, score_size)
        sw = self._sub("trace", "sw", use_profile)
        batch, _, _ = sw._pack(None if use_profile else qs, refs)
        out, ops = sw._submit(batch, walk=True).fetch()
        bqs, brs = out["beg_query"], out["beg_ref"]
        runs = ops_to_runs_batch(ops, merge_m=True)
        promoted = out.get("promoted", np.zeros(len(refs), bool))
        return [SSWResult(
            score1=_ssw_score(int(out["score"][k]), bool(promoted[k]),
                              score_size),
            ref_begin1=int(brs[k]), ref_end1=int(out["end_ref"][k]),
            read_begin1=int(bqs[k]), read_end1=int(out["end_query"][k]),
            _cigar=runs[k]) for k in range(len(refs))]

    def _ssw_windowed(self, qs, refs, use_profile, score_size):
        """Three-pass long-pair SSW.

        1. SW score over the full pairs (``align_many``): score and ends.
        2. SW score over the reversed prefixes q[:eq+1] / r[:er+1]
           (``align_many``): their ends are the begins.
        3. NW trace over the [begin, end] windows, binned by padded shape
           and walked on the device: a max-score global alignment of the
           windows, so flag memory is O(window), not O(qlen * rlen).
        """
        from ..ops.trace_walk import ops_to_runs_batch

        n = len(refs)
        a1 = self._sub("score", "sw", use_profile).align_many(
            None if use_profile else qs, refs)
        scores = [a.get_score() for a in a1]
        eqs = [a.get_end_query() for a in a1]
        ers = [a.get_end_ref() for a in a1]
        promoted = [bool(a.fields.get("promoted", False)) for a in a1]
        live = [k for k in range(n) if scores[k] > 0]
        bqs, brs = [0] * n, [0] * n
        cigars = [np.empty(0, np.uint32)] * n
        if live:
            a2 = self._sub("score", "sw", False).align_many(
                [qs[k][:eqs[k] + 1][::-1] for k in live],
                [refs[k][:ers[k] + 1][::-1] for k in live])
            for k, a in zip(live, a2):
                bqs[k] = eqs[k] - a.get_end_query()
                brs[k] = ers[k] - a.get_end_ref()
            qw = [qs[k][bqs[k]:eqs[k] + 1] for k in live]
            rw = [refs[k][brs[k]:ers[k] + 1] for k in live]
            nwal = self._sub("trace", "nw", False)
            runs = nwal._binned(
                qw, rw, nwal._walk_bins(lengths(qw), lengths(rw)),
                lambda _cols, rows, _ql, _rl: (
                    ops_to_runs_batch(rows, merge_m=True),), walk=True)[0]
            for k, r in zip(live, runs):
                cigars[k] = r
        return [SSWResult(
            score1=_ssw_score(scores[k], promoted[k], score_size),
            ref_begin1=brs[k], ref_end1=ers[k], read_begin1=bqs[k],
            read_end1=eqs[k], _cigar=cigars[k]) for k in range(n)]


def _alignments(out, qlens, rlens, flags, matrix, free, mode):
    """Result objects over the shared columnar output arrays: one
    :class:`BatchRecord` for the batch, one two-slot :class:`Alignment`
    a pair over it, made in one pass of ``map``; ``flags`` are the two
    shared read-only dicts, (unsaturated, saturated)."""
    n = len(rlens)
    big = {k: v for k, v in out.items()
           if k.endswith(("_table", "_row", "_col"))}
    cols = {k: np.asarray(v) for k, v in out.items() if k not in big}
    sat = cols.get("saturated")
    rec = BatchRecord(cols, big, qlens, rlens,
                      [False] * n if sat is None else
                      np.asarray(sat, bool).tolist(),
                      flags, matrix, free, mode)
    with stages.stage("build"), gc_pause(n):
        return list(map(Alignment, repeat(rec, n), range(n)))


def _ssw_score(score: int, promoted: bool, score_size: int | None) -> int:
    """SSW's score1: 8-bit mode (score_size 0) reports the library's cap
    255 for a pair whose 8-bit lanes saturate; otherwise the score capped
    at 65535."""
    if score_size == 0:
        return 255 if promoted else min(score, 255)
    return min(score, 0xFFFF)
