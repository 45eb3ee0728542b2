"""Aligner and AlignerBuilder on PyTorch.

The port of ``parasail_rs_tpu.engine.aligner`` for the score class: the
builder keeps every configuration method and its mutual-exclusion rules
(reference src/aligner/mod.rs:213-267), and ``align`` / ``align_batch``
run one kernel launch per batch on the aligner's device.

Out of this port so far, and raising ``NotImplementedError`` rather than
computing anything else: builds whose outputs are not score-only (stats,
table, rowcol, trace), and ``align_many``, ``align_cigars``, ``cigars``,
``banded_nw``, ``banded_nw_batch``, ``ssw`` and ``ssw_batch``.  The
ROADMAP item that ports each is named in its message.
"""

from __future__ import annotations

import logging
from collections import Counter

import numpy as np
import torch

from parasail_rs_tpu.errors import QueryRequired
from parasail_rs_tpu.golden.model import free_flags
from parasail_rs_tpu.matrices import Matrix
from parasail_rs_tpu.utils import stages
from parasail_rs_tpu.utils.gcpause import gc_pause

from ..ops.specs import KernelKey
from . import dispatch
from .profile import Profile
from .result import Alignment, PairFields

log = logging.getLogger("parasail_rs_tpu_torch")


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet ({item} in ROADMAP.md)")


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
        if outputs != "score":
            raise _not_ported(
                f"outputs={outputs!r}",
                {"trace": "Queue 1 item 5 (trace + CIGAR), kernel K1b",
                 "stats": "Queue 1 item 6 (stats), kernel K1c"}.get(
                    outputs, "Queue 1 item 8 (tables, rowcol), kernel K1d"))
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

    def _execute(self, batch):
        return dispatch.execute(
            batch,
            gap_open=self.gap_open, gap_extend=self.gap_extend,
            mode=self.key.mode, free=self.key.free,
            outputs=self.key.outputs, width=self.key.width,
            on_route=lambda route, reason:
                self.route_counter.update([(route, reason)]),
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

    # -- not ported yet ----------------------------------------------------------
    def align_many(self, queries, references, max_cells=None):
        raise _not_ported("align_many", "Queue 1 item 7 (align_many)")

    def cigars(self, alignments, queries, references):
        raise _not_ported("cigars", "Queue 1 item 5 (trace + CIGAR)")

    def align_cigars(self, queries, references):
        raise _not_ported("align_cigars", "Queue 1 item 5 (trace + CIGAR)")

    def banded_nw(self, query, reference):
        raise _not_ported("banded_nw", "Queue 1 item 8 (banded), kernel K1e")

    def banded_nw_batch(self, queries, references):
        raise _not_ported("banded_nw_batch",
                          "Queue 1 item 8 (banded), kernel K1e")

    def ssw(self, query, reference):
        raise _not_ported("ssw", "Queue 1 item 8 (SSW)")

    def ssw_batch(self, queries, references, windowed=None):
        raise _not_ported("ssw_batch", "Queue 1 item 8 (SSW)")
