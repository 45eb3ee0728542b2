"""Aligner and AlignerBuilder on PyTorch.

The port of ``parasail_rs_tpu.engine.aligner``, every public method: the
builder keeps every configuration method and its mutual-exclusion rules
(reference src/aligner/mod.rs:213-267); ``align`` / ``align_batch`` run
one kernel launch per batch on the aligner's device, for every output
class (score, stats, table, stats_table, rowcol, stats_rowcol, trace);
``align_many`` length-bins first and launches every bin before the first
fetch; ``cigars`` walks fetched trace planes on the host and
``align_cigars`` walks them on the device, fetching only opcodes;
``banded_nw`` / ``banded_nw_batch`` run the banded score kernel;
``ssw`` / ``ssw_batch`` run the SW trace kernel and the device walk, or
for long pairs the three-pass windowed pipeline on ``align_many``.
"""

from __future__ import annotations

import functools
import logging
from collections import Counter

import numpy as np
import torch

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
from . import dispatch
from .binning import lengths, plan_bins
from .profile import Profile
from .result import Alignment, PairFields, SSWResult

log = logging.getLogger("parasail_rs_tpu_torch")


def _call_region(method):
    """Open the region ``pt.call.<method>`` around a public call (a
    ``record_function`` under torch's profiler, an NVTX range on a
    card)."""
    name = "pt.call." + method.__name__

    @functools.wraps(method)
    def call(*args, **kwargs):
        with profiling.trace_region(name):
            return method(*args, **kwargs)

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
    def _flags(self, saturated: bool, banded: bool = False) -> dict:
        key = self.key
        return {
            "nw": key.mode == "nw",
            "sg": key.mode == "sg",
            "sw": key.mode == "sw",
            "striped": not banded and key.strategy == "striped",
            "scan": not banded and key.strategy == "scan",
            "diag": not banded and key.strategy == "diag",
            "banded": banded,
            "blocked": False,
            "saturated": saturated,
            "stats": key.uses_stats,
            "table": key.outputs in ("table", "stats_table"),
            "stats_table": key.outputs == "stats_table",
            "rowcol": key.outputs in ("rowcol", "stats_rowcol"),
            "stats_rowcol": key.outputs == "stats_rowcol",
            "trace": key.outputs == "trace",
        }

    def _make_alignment(self, out: dict, b: int, qlen: int,
                        rlen: int) -> Alignment:
        fields = dispatch.slice_pair(out, b, qlen, rlen)
        return Alignment(
            fields=fields,
            flags=self._flags(bool(fields.get("saturated", False))),
            query_len=qlen,
            ref_len=rlen,
            matrix=self.matrix,
            free=self.key.free,
            mode=self.key.mode,
        )

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

    def _execute(self, batch):
        return dispatch.execute(
            batch,
            gap_open=self.gap_open, gap_extend=self.gap_extend,
            mode=self.key.mode, free=self.key.free,
            outputs=self.key.outputs, width=self.key.width,
            on_route=self._on_route,
        )

    def _alignments_from(self, out, qlens, rlens):
        """Result objects over the shared columnar output arrays: each
        Alignment holds a :class:`PairFields` view and one of two shared
        read-only flag dicts (they differ only in ``saturated``)."""
        n = len(rlens)
        big = {k: v for k, v in out.items()
               if k.endswith(("_table", "_row", "_col"))}
        cols = {k: np.asarray(v) for k, v in out.items() if k not in big}
        sat = cols.get("saturated")
        sat_l = ([False] * n if sat is None else
                 np.asarray(sat, bool).tolist())
        f_sat = self._flags(True)
        f_un = self._flags(False)
        mk, pf = Alignment, PairFields
        matrix, free, mode = self.matrix, self.key.free, self.key.mode
        with stages.stage("build"), gc_pause(n):
            return [
                mk(fields=pf(cols, big, b, qlens[b], rlens[b]),
                   flags=f_sat if sat_l[b] else f_un,
                   query_len=qlens[b], ref_len=rlens[b],
                   matrix=matrix, free=free, mode=mode)
                for b in range(n)
            ]

    def _run_packed(self, batch, qlens, rlens):
        return self._alignments_from(self._execute(batch), qlens, rlens)

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
        return self._run_packed(*self._pack(queries, references))

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
            bins = _shape_bins(
                qlens, lengths(refs),
                self.key.outputs in ("trace", "table", "stats_table"),
                max_cells)
        pending = []
        for bin_ in bins:
            idx = bin_.indices
            with stages.stage("bins"):
                bqs = None if queries is None else [queries[i] for i in idx]
                brs = [refs[i] for i in idx]
            batch, bql, brl = self._pack(bqs, brs, Qp=bin_.qp, Rp=bin_.rp)
            pending.append((idx, bql, brl, dispatch.submit(
                batch, gap_open=self.gap_open, gap_extend=self.gap_extend,
                mode=self.key.mode, free=self.key.free,
                outputs=self.key.outputs, width=self.key.width,
                on_route=self._on_route)))
        results: list[Alignment | None] = [None] * len(refs)
        for idx, bql, brl, res in pending:
            out = (res.fetch()[0] if isinstance(res, dispatch.PendingResult)
                   else res)
            alns = self._alignments_from(out, bql, brl)
            with stages.stage("bins"):
                for i, aln in zip(idx, alns):
                    results[i] = aln
        return results

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
        per-pair scalars, in one transfer per chunk.

        Returns ``(alignments, cigars)``: score-class ``Alignment``
        objects (``is_trace()`` is False) and the CIGAR string per pair,
        identical to ``cigars()`` on a trace-enabled aligner.  With a
        profile set, ``queries`` is ignored.  Mixed-length inputs are
        length-binned (trace planes are cell-sized): on a card a launch
        holds up to a quarter of its memory of plane, a byte a cell
        (:func:`_plane_cells`), on the CPU and at width 64 the
        reference's 2^28 cells; results return in input order.
        """
        with stages.stage("bins"):
            refs = [_as_bytes(r) for r in references]
            if not refs:
                return [], []
            queries = (None if not self.profile.is_null
                       else [_as_bytes(q) for q in queries])
            n = len(refs)
            qlens = (self.profile.query_len if queries is None
                     else lengths(queries))
            bins = _shape_bins(qlens, lengths(refs), True,
                               plane_on=self._plane_home())
        # result objects are score-class (no trace plane materialises)
        res_key = KernelKey(mode=self.key.mode, free=self.key.free,
                            outputs="score", strategy=self.key.strategy,
                            profile=not self.profile.is_null,
                            width=self.key.width)
        res_al = self if self.key == res_key else Aligner(
            key=res_key, matrix=self.matrix, gap_open=self.gap_open,
            gap_extend=self.gap_extend, profile=self.profile,
            bandwidth=None, device=self.device)
        alns: list = [None] * n
        cigs: list = [None] * n
        for bin_ in bins:
            idx = bin_.indices
            with stages.stage("bins"):
                bqs = None if queries is None else [queries[i] for i in idx]
                brs = [refs[i] for i in idx]
            a, c = self._align_cigars_shape(bqs, brs, res_al, bin_.qp,
                                            bin_.rp)
            with stages.stage("bins"):
                for k, i in enumerate(idx):
                    alns[i] = a[k]
                    cigs[i] = c[k]
        return alns, cigs

    def _plane_home(self):
        """The device a trace plane stays on through the device walk: this
        aligner's, but None at width "64", whose exact host merge
        (:func:`dispatch.width64_risk`) brings the plane to the host."""
        return None if self.key.width == "64" else self.device

    # pairs per device-walk launch: a bin splits into chunks whose pack,
    # kernels and copy are all enqueued before the first fetch blocks, so
    # chunk k's transfer overlaps chunk k+1's work (the reference's value,
    # chosen on its own device; not yet measured on the card)
    _CIGAR_CHUNK = 512

    def _align_cigars_shape(self, queries, refs, res_al, Qp, Rp):
        """One shape bin of :meth:`align_cigars`."""
        from ..constants import cigar_strings_batch

        from ..ops.trace_walk import ops_to_runs_flat

        n = len(refs)
        CH = self._CIGAR_CHUNK
        qseq = None if self.profile.is_null else self.profile.query
        states = []
        for i in range(0, n, CH):
            sl = slice(i, min(i + CH, n))
            batch, qlens, rlens = self._pack(
                None if queries is None else queries[sl], refs[sl],
                Qp=Qp, Rp=Rp)
            states.append((qlens, rlens,
                           self._device_trace_walk_enqueue(batch, qseq)))
        alns_all, cigs_all = [], []
        for qlens, rlens, st in states:
            out, ops_host, _, _ = self._device_trace_walk_fetch(st)
            alns_all.extend(res_al._alignments_from(out, qlens, rlens))
            # gc_pause: the string build allocates ~30 gc-tracked objects
            # per pair
            with stages.stage("encode"), gc_pause(len(rlens) * 8):
                cigs_all.extend(cigar_strings_batch(
                    *ops_to_runs_flat(ops_host)))
        return alns_all, cigs_all

    def _walk_symbols(self, batch, qseq: bytes | None, Qp: int):
        """Symbol planes for the walk's '=' against 'X' decision: the raw
        bytes where the batch carries them (golden compares raw bytes;
        mapped letters fold case and wildcards), the profile query's
        bytes for a shared-profile batch, else the letter indices."""
        if batch.rbytes is not None and batch.qbytes is not None:
            return batch.qbytes, batch.rbytes
        if batch.rbytes is not None and qseq is not None:
            qarr = np.zeros((1, Qp), np.uint8)
            qarr[0, :len(qseq)] = np.frombuffer(qseq, np.uint8)
            return dispatch.upload(qarr, batch.device), batch.rbytes
        return batch.qidx, batch.ridx

    def _device_trace_walk_enqueue(self, batch, qseq: bytes | None = None):
        """Trace kernel, walk kernel and one pinned non-blocking copy of
        (scalars, opcode rows), all enqueued without
        blocking; returns the state :meth:`_device_trace_walk_fetch`
        takes.  The trace plane never leaves the device.

        Width 64 with pairs over the int32 bound takes the exact host
        merge first (:func:`dispatch.execute`); its merged plane goes
        back to the device for the walk, and its int64 scalars stay on
        the host."""
        from ..ops.trace_walk import device_walk

        kw = dict(gap_open=self.gap_open, gap_extend=self.gap_extend,
                  mode=self.key.mode, free=self.key.free, outputs="trace",
                  on_route=self._on_route)
        host = None
        if self.key.width == "64" and dispatch.width64_risk(
                batch, self.gap_open, self.gap_extend).size:
            host = dispatch.execute(batch, width="64", **kw)
            trace = dispatch.upload(host.pop("trace_table"), batch.device)
            eq = dispatch.upload(host["end_query"].astype(np.int32),
                                 batch.device)
            er = dispatch.upload(host["end_ref"].astype(np.int32),
                                 batch.device)
            cols = {}
        else:
            cols = dispatch.launch(batch, width=self.key.width, **kw)
            trace = cols.pop("trace_table")
            eq, er = cols["end_query"], cols["end_ref"]
        qsym, rsym = self._walk_symbols(batch, qseq, trace.shape[1])
        with stages.stage("walk"):
            ops, bq, br = device_walk(trace, qsym, rsym, eq, er,
                                      self.key.mode, self.key.free)
        pend = dispatch.PendingResult(
            {**cols, "beg_query": bq, "beg_ref": br}, ops)
        return host, pend

    def _device_trace_walk_fetch(self, st):
        """Blocking phase: wait for the copy and unpack (scalars dict,
        ops rows (B, Qp + Rp) uint8 backward, begin cells (B,) and
        (B,))."""
        host, pend = st
        out, ops = pend.fetch()
        bq, br = out.pop("beg_query"), out.pop("beg_ref")
        return (host if host is not None else out), ops, bq, br

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
        kernel (NW, width 32) over the whole batch."""
        if self.bandwidth is None:
            raise NoBandwidth(
                "banded_nw() requires .bandwidth() on the builder")
        batch, qlens, rlens = self._pack(queries, references)
        out = dispatch.execute(
            batch, gap_open=self.gap_open, gap_extend=self.gap_extend,
            mode="nw", free=(False,) * 4, outputs="score", width="32",
            on_route=self._on_route, banded=True, bandwidth=self.bandwidth)
        flags = self._flags(False, banded=True)
        flags.update({"nw": True, "sg": False, "sw": False})
        with stages.stage("build"), gc_pause(len(rlens)):
            return [Alignment(fields=dispatch.slice_pair(out, b, qlens[b],
                                                         rlens[b]),
                              flags=dict(flags), query_len=qlens[b],
                              ref_len=rlens[b], matrix=self.matrix,
                              free=(False,) * 4, mode="nw")
                    for b in range(len(rlens))]

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
        memory a launch (the reference's 2^28 cells on the CPU).  Its
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
        out, ops, bqs, brs = sw._device_trace_walk_fetch(
            sw._device_trace_walk_enqueue(
                batch, self.profile.query if use_profile else None))
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
            bins = _shape_bins(lengths(qw), lengths(rw), True,
                               plane_on=nwal._plane_home())
            states = []
            for bin_ in bins:
                idx = bin_.indices
                batch, _, _ = nwal._pack([qw[i] for i in idx],
                                         [rw[i] for i in idx],
                                         Qp=bin_.qp, Rp=bin_.rp)
                states.append((idx, nwal._device_trace_walk_enqueue(batch)))
            for idx, st in states:
                _, ops, _, _ = nwal._device_trace_walk_fetch(st)
                for i, runs in zip(idx, ops_to_runs_batch(ops, merge_m=True)):
                    cigars[live[i]] = runs
        return [SSWResult(
            score1=_ssw_score(scores[k], promoted[k], score_size),
            ref_begin1=brs[k], ref_end1=ers[k], read_begin1=bqs[k],
            read_end1=eqs[k], _cigar=cigars[k]) for k in range(n)]


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
    over index arrays (:func:`binning.plan_bins`; ``qlens`` is one int
    where every query has that length, a profile's): for the classes
    with cell-sized planes (trace, table), at most 2^28 cells a launch in
    16 launches; for the rest 2^33 cells in groups of 128 pairs, in 8
    launches.  ``plane_on`` is the device a cell-sized trace
    plane stays on, its walk running there and fetching only opcodes
    (``align_cigars``, ``ssw_batch``); its cap is then
    :func:`_plane_cells`' (a quarter of a card's memory).  None, the
    default, is a plane that crosses to the host, under the reference's
    cap.  ``max_cells`` overrides the cell cap."""
    from ..batch import merge_bins

    if max_cells is None:
        max_cells = _plane_cells(plane_on) if cell_sized else (1 << 33)
    return merge_bins(
        plan_bins(qlens, rlens, max_cells=max_cells,
                  lane_quantum=1 if cell_sized else 128),
        max_launches=16 if cell_sized else 8, max_cells=max_cells)


def _ssw_score(score: int, promoted: bool, score_size: int | None) -> int:
    """SSW's score1: 8-bit mode (score_size 0) reports the library's cap
    255 for a pair whose 8-bit lanes saturate; otherwise the score capped
    at 65535."""
    if score_size == 0:
        return 255 if promoted else min(score, 255)
    return min(score, 0xFFFF)
