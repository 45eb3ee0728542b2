"""Result objects: Alignment, Table, TracebackTable, Traceback, SSWResult.

The safe-accessor facade of the reference (src/alignment/mod.rs:53-504,
src/alignment/table.rs) rebuilt over host numpy arrays fetched from the
device kernels.  Every conditional getter is guarded behind the matching
predicate and raises the typed error the reference returns; all 15 result
predicates are carried as plain flags (the reference reads them off the
C result tag via parasail_result_is_*, src/alignment/mod.rs:422-494).

Deviations from the reference, on purpose:

- ``Alignment`` is a value object (no Drop/lifetime concerns); the
  reference's ``#[derive(Clone)]`` on a pointer-owning type is a latent
  double-free (src/alignment/mod.rs:54) and is not replicated.
- ``get_similar`` is guarded like the other stats getters; the reference
  leaves it unguarded (src/alignment/mod.rs:87-89) which reads
  uninitialised memory on non-stats results.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import TRACE_H_BITS, TraceFlags, cigar_decode_one
from ..errors import (
    NoRowCol,
    NoStats,
    NoStatsTable,
    NoTable,
    NoTrace,
)
from ..golden.model import aligned_strings, walk_trace
from ..utils import stages


class Table:
    """Read-only 2-D int32 view over a DP output plane.

    Mirrors ``Table<'a>`` (reference: src/alignment/table.rs:33-125):
    rows = query positions, cols = reference positions.
    """

    def __init__(self, data: np.ndarray):
        assert data.ndim == 2
        self._data = data

    def rows(self) -> int:
        return int(self._data.shape[0])

    def cols(self) -> int:
        return int(self._data.shape[1])

    def get(self, row: int, col: int):
        """Bounds-checked cell access; ``None`` when out of range
        (reference: table.rs:78-84)."""
        if 0 <= row < self.rows() and 0 <= col < self.cols():
            return int(self._data[row, col])
        return None

    def as_slice(self) -> np.ndarray:
        """Flat row-major view (reference: table.rs:96-99)."""
        return self._data.reshape(-1)

    def last(self) -> int:
        """Bottom-right cell (reference: table.rs:102-107)."""
        return int(self._data[-1, -1])

    def as_array(self) -> np.ndarray:
        """The underlying (rows, cols) array (TPU-native extra)."""
        return self._data

    def __str__(self) -> str:  # reference Display: table.rs:110-125
        return "\n".join(
            " ".join(str(int(v)) for v in row) for row in self._data
        ) + "\n"


class TracebackTable:
    """Read-only view over the int8 trace-flag plane
    (reference: src/alignment/table.rs:172-334)."""

    def __init__(self, data: np.ndarray):
        assert data.ndim == 2
        self._data = data

    def rows(self) -> int:
        return int(self._data.shape[0])

    def cols(self) -> int:
        return int(self._data.shape[1])

    def get(self, row: int, col: int):
        """Simple direction flags (DIAG/INS/DEL only) at a cell
        (reference masks off the E/F families, table.rs:242-253)."""
        if 0 <= row < self.rows() and 0 <= col < self.cols():
            return TraceFlags(int(self._data[row, col]) & TRACE_H_BITS)
        return None

    def get_detailed(self, row: int, col: int):
        """Raw flags incl. the E/F family bits (reference: table.rs:273-281)."""
        if 0 <= row < self.rows() and 0 <= col < self.cols():
            return TraceFlags(int(self._data[row, col]) & 0x7F)
        return None

    def as_slice(self) -> np.ndarray:
        return self._data.reshape(-1)

    def as_array(self) -> np.ndarray:
        return self._data

    def __str__(self) -> str:  # simple display (reference: table.rs:302-317)
        out = []
        for r in range(self.rows()):
            out.append(" ".join(self.get(r, c).display() or "ZERO"
                                for c in range(self.cols())))
        return "\n".join(out) + "\n"

    def __repr__(self) -> str:  # detailed display (reference: table.rs:319-334)
        out = []
        for r in range(self.rows()):
            out.append(" ".join(self.get_detailed(r, c).display() or "ZERO"
                                for c in range(self.cols())))
        return "\n".join(out) + "\n"


@dataclass
class Traceback:
    """Aligned display strings (reference: src/alignment/mod.rs:47-51)."""

    query: str
    comparison: str
    reference: str


class BatchRecord:
    """What the results of one batch share: its fetched columns
    (``cols``, an array a key), its cell-sized planes (``big``:
    ``*_table`` / ``*_row`` / ``*_col``), the pairs' lengths, each
    pair's saturation bit (``sat``), the two read-only predicate dicts
    (``flags``: unsaturated, saturated), and the aligner's ``matrix``,
    ``free`` and ``mode``.  Each :class:`Alignment` holds this record
    and its row, so a batch of n pairs allocates n small objects and one
    record."""

    __slots__ = ("cols", "big", "qlens", "rlens", "sat", "flags", "matrix",
                 "free", "mode")

    def __init__(self, cols, big, qlens, rlens, sat, flags, matrix, free,
                 mode):
        self.cols = cols
        self.big = big
        self.qlens = qlens
        self.rlens = rlens
        self.sat = sat
        self.flags = flags
        self.matrix = matrix
        self.free = free
        self.mode = mode

    def field(self, b: int, k: str):
        """Pair ``b``'s value of ``k``: a column's element, or a view of
        its plane cropped to the pair's lengths (the slices
        ``dispatch.slice_pair`` takes)."""
        v = self.cols.get(k)
        if v is not None:
            return v[b]
        v = self.big[k]
        if k.endswith("_table"):
            return v[b, :self.qlens[b], :self.rlens[b]]
        if k.endswith("_row"):
            return v[b, :self.rlens[b]]
        return v[b, :self.qlens[b]]


class PairFields:
    """Lazy per-pair mapping over a batch's columnar output arrays.

    Quacks like the plain dict ``Alignment.fields`` historically held
    (``[]`` / ``get`` / ``in``) but materializes nothing per pair:
    scalar reads index the shared column array, and cell-sized planes
    (``*_table``/``*_row``/``*_col``) slice a view of the batch plane at
    access time (:meth:`BatchRecord.field`).  Building 8k per-pair
    dicts cost ~14 ms of host time per batch, 3x the device kernel; 8k
    of these views cost ~2 ms.
    """

    __slots__ = ("_rec", "_b")

    def __init__(self, rec: BatchRecord, b: int):
        self._rec = rec
        self._b = b

    def __getitem__(self, k):
        return self._rec.field(self._b, k)

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default

    def __contains__(self, k):
        return k in self._rec.cols or k in self._rec.big

    def keys(self):
        return list(self._rec.cols) + list(self._rec.big)

    def __iter__(self):
        return iter(self.keys())

    def __repr__(self):
        return f"PairFields({{{', '.join(self.keys())}}}, b={self._b})"


class Alignment:
    """Sequence alignment result.

    Accessor surface mirrors the reference ``Alignment``
    (src/alignment/mod.rs:53-504).  ``fields`` maps the per-pair host
    arrays the device kernel produced; ``flags`` holds the 15 predicate
    bits the reference reads off the C result tag.  An instance is two
    slots, the batch's shared :class:`BatchRecord` and the pair's row:
    batch paths build one a pair, and every per-pair field the
    collector would scan or ``__init__`` would fill costs host time at
    64k pairs.  ``fields``, ``flags``, ``query_len``, ``ref_len``,
    ``matrix``, ``free`` and ``mode`` read the record.
    """

    __slots__ = ("_rec", "_b")

    def __init__(self, rec: BatchRecord, b: int):
        self._rec = rec
        self._b = b

    def _field(self, k: str):
        return self._rec.field(self._b, k)

    @property
    def fields(self) -> PairFields:
        return PairFields(self._rec, self._b)

    @property
    def flags(self) -> dict:
        rec = self._rec
        return rec.flags[rec.sat[self._b]]

    @property
    def query_len(self) -> int:
        return self._rec.qlens[self._b]

    @property
    def ref_len(self) -> int:
        return self._rec.rlens[self._b]

    @property
    def matrix(self):
        """The Matrix (kept for parity with reference)."""
        return self._rec.matrix

    @property
    def free(self) -> tuple:
        return self._rec.free

    @property
    def mode(self) -> str:
        return self._rec.mode

    def __repr__(self) -> str:
        return (f"Alignment(fields={self.fields!r}, flags={self.flags!r}, "
                f"query_len={self.query_len!r}, ref_len={self.ref_len!r}, "
                f"matrix={self.matrix!r}, free={self.free!r}, "
                f"mode={self.mode!r})")

    @property
    def matrix_approximate(self) -> bool:
        """True when this result was scored with a synthesised builtin
        matrix rather than verbatim NCBI data (TPU-native extra; see
        matrices.ncbi for how to register exact tables)."""
        return bool(getattr(self.matrix, "approximate", False))

    # -- score / ends (src/alignment/mod.rs:64-76) ---------------------------
    def get_score(self) -> int:
        return int(self._field("score"))

    def get_end_query(self) -> int:
        return int(self._field("end_query"))

    def get_end_ref(self) -> int:
        return int(self._field("end_ref"))

    # -- stats (src/alignment/mod.rs:79-98) ----------------------------------
    def get_matches(self) -> int:
        if not self.is_stats():
            raise NoStats("get_matches()")
        return int(self._field("matches"))

    def get_similar(self) -> int:
        # Guarded unlike the reference (deliberate fix, see module docstring).
        if not self.is_stats():
            raise NoStats("get_similar()")
        return int(self._field("similar"))

    def get_length(self) -> int:
        if not self.is_stats():
            raise NoStats("get_length()")
        return int(self._field("length"))

    # -- full tables (src/alignment/mod.rs:123-192) --------------------------
    def _table(self, key: str, guard, err) -> Table:
        if not guard:
            raise err
        return Table(self._field(key))

    def get_score_table(self) -> Table:
        return self._table(
            "score_table", self.is_table() or self.is_stats_table(),
            NoTable("get_score_table()"))

    def get_matches_table(self) -> Table:
        return self._table(
            "matches_table", self.is_stats_table(),
            NoStatsTable("get_matches_table()"))

    def get_similar_table(self) -> Table:
        return self._table(
            "similar_table", self.is_stats_table(),
            NoStatsTable("get_similar_table()"))

    def get_length_table(self) -> Table:
        return self._table(
            "length_table", self.is_stats_table(),
            NoStatsTable("get_length_table()"))

    # -- last row / col (src/alignment/mod.rs:195-288) -----------------------
    def _rowcol(self, key: str, stats_only: bool, name: str) -> np.ndarray:
        ok = self.is_stats_rowcol() if stats_only else (
            self.is_rowcol() or self.is_stats_rowcol())
        if not ok:
            raise NoRowCol(name)
        return self._field(key)

    def get_score_row(self) -> np.ndarray:
        return self._rowcol("score_row", False, "get_score_row()")

    def get_score_col(self) -> np.ndarray:
        return self._rowcol("score_col", False, "get_score_col()")

    def get_matches_row(self) -> np.ndarray:
        return self._rowcol("matches_row", True, "get_matches_row()")

    def get_matches_col(self) -> np.ndarray:
        return self._rowcol("matches_col", True, "get_matches_col()")

    def get_similar_row(self) -> np.ndarray:
        return self._rowcol("similar_row", True, "get_similar_row()")

    def get_similar_col(self) -> np.ndarray:
        return self._rowcol("similar_col", True, "get_similar_col()")

    def get_length_row(self) -> np.ndarray:
        return self._rowcol("length_row", True, "get_length_row()")

    def get_length_col(self) -> np.ndarray:
        return self._rowcol("length_col", True, "get_length_col()")

    # -- trace (src/alignment/mod.rs:291-419) --------------------------------
    def get_trace_table(self) -> TracebackTable:
        if not self.is_trace():
            raise NoTrace("get_trace_table()")
        return TracebackTable(self._field("trace_table"))

    def _walk(self, query: bytes, reference: bytes):
        # Native C++ walker when built (parasail's host-side traceback is
        # native C too); the Python golden walker is the fallback oracle.
        from ..golden.model import Walk, free_flags
        from ..native import walker

        with stages.stage("walk.host"):
            free = self.free if self.mode != "sw" else free_flags("sw")
            qb, _, db, _ = free
            res = walker.walk_one(
                self._field("trace_table"), query, reference,
                self.get_end_query(), self.get_end_ref(),
                local=self.mode == "sw", qb=qb, db=db,
            )
            if res is not None:
                ops, bq, br = res
                return Walk(ops=ops, beg_query=bq, beg_ref=br)
            return walk_trace(
                self._field("trace_table"), query, reference,
                self.get_end_query(), self.get_end_ref(), self.mode,
                self.free,
            )

    def get_cigar(self, query: bytes, reference: bytes) -> str:
        """Decoded CIGAR string (reference: src/alignment/mod.rs:390-419)."""
        if not self.is_trace():
            raise NoTrace("get_cigar()")
        return self._walk(query, reference).cigar_string()

    def get_traceback_strings(self, query: bytes, reference: bytes) -> Traceback:
        """(query, comparison, reference) aligned display strings
        (reference: src/alignment/mod.rs:347-387)."""
        if not self.is_trace():
            raise NoTrace("get_traceback_strings()")
        walk = self._walk(query, reference)
        q, c, r = aligned_strings(walk, query, reference)
        return Traceback(query=q, comparison=c, reference=r)

    def print_traceback(self, query: bytes, reference: bytes) -> None:
        """Pretty-print the traceback, width 80, name width 7, with stats
        (reference: src/alignment/mod.rs:310-344 -> parasail_traceback_generic)."""
        if not self.is_trace():
            print(
                "Alignment string is not available without traceback enabled. "
                "Consider using the `use_trace` method on AlignerBuilder."
            )
            return
        walk = self._walk(query, reference)
        q, c, r = aligned_strings(walk, query, reference)
        width, name_width = 80, 7
        qpos, rpos = walk.beg_query + 1, walk.beg_ref + 1
        for off in range(0, len(q), width):
            qc, cc, rc = q[off:off + width], c[off:off + width], r[off:off + width]
            q_consumed = sum(1 for ch in qc if ch != "-")
            r_consumed = sum(1 for ch in rc if ch != "-")
            print(f"{'Query:':<{name_width}} {qpos:>6} {qc} {qpos + max(q_consumed, 1) - 1}")
            print(f"{'':<{name_width}} {'':>6} {cc}")
            print(f"{'Target:':<{name_width}} {rpos:>6} {rc} {rpos + max(r_consumed, 1) - 1}")
            print()
            qpos += q_consumed
            rpos += r_consumed
        total = len(q)
        ident = sum(1 for ch in c if ch == "|")
        gaps = sum(1 for ch in q if ch == "-") + sum(1 for ch in r if ch == "-")
        if total:
            print(f"Length: {total}")
            print(f"Identity: {ident}/{total} ({100.0 * ident / total:.1f}%)")
            print(f"Gaps: {gaps}/{total} ({100.0 * gaps / total:.1f}%)")
        print(f"Score: {self.get_score()}")

    # -- predicates (src/alignment/mod.rs:422-494) ---------------------------
    def is_global(self) -> bool:
        return bool(self.flags.get("nw", False))

    def is_semi_global(self) -> bool:
        return bool(self.flags.get("sg", False))

    def is_local(self) -> bool:
        return bool(self.flags.get("sw", False))

    def is_saturated(self) -> bool:
        return bool(self.flags.get("saturated", False))

    def is_banded(self) -> bool:
        return bool(self.flags.get("banded", False))

    def is_scan(self) -> bool:
        return bool(self.flags.get("scan", False))

    def is_striped(self) -> bool:
        return bool(self.flags.get("striped", False))

    def is_diag(self) -> bool:
        return bool(self.flags.get("diag", False))

    def is_blocked(self) -> bool:
        return bool(self.flags.get("blocked", False))

    def is_stats(self) -> bool:
        return bool(self.flags.get("stats", False))

    def is_stats_table(self) -> bool:
        return bool(self.flags.get("stats_table", False))

    def is_table(self) -> bool:
        return bool(self.flags.get("table", False))

    def is_rowcol(self) -> bool:
        return bool(self.flags.get("rowcol", False))

    def is_stats_rowcol(self) -> bool:
        return bool(self.flags.get("stats_rowcol", False))

    def is_trace(self) -> bool:
        return bool(self.flags.get("trace", False))


@dataclass
class SSWResult:
    """SSW-library-compatible local alignment result
    (reference: src/alignment/mod.rs:507-551 over parasail_result_ssw_t).

    Unlike the reference (raw ``*mut u32``), ``cigar()`` returns a numpy
    uint32 array of packed ops ``(length << 4) | op``.
    """

    score1: int
    ref_begin1: int
    ref_end1: int
    read_begin1: int
    read_end1: int
    _cigar: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))

    def score(self) -> int:
        """Primary score, clamped to u16 like the C struct field."""
        return int(self.score1) & 0xFFFF

    def ref_start(self) -> int:
        return int(self.ref_begin1)

    def ref_end(self) -> int:
        return int(self.ref_end1)

    def query_start(self) -> int:
        return int(self.read_begin1)

    def query_end(self) -> int:
        return int(self.read_end1)

    def cigar(self) -> np.ndarray:
        return self._cigar

    def cigar_len(self) -> int:
        return int(self._cigar.shape[0])

    def cigar_string(self) -> str:
        return "".join(
            f"{n}{op}" for n, op in (cigar_decode_one(int(v)) for v in self._cigar)
        )
