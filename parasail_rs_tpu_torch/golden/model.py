"""Golden scalar model: affine-gap (Gotoh) pairwise alignment in pure NumPy.

This is the semantic oracle for the whole framework: the Pallas/XLA kernels
must produce bit-identical scores, stats, tables, trace flags, and CIGARs to
this model.  It encodes the reference's capability surface — global (nw),
semi-global with the free-end variant grammar, and local (sw) — with the
stats / table / rowcol / trace output classes
(reference: src/aligner/mod.rs:289-331 name grammar; outputs at
src/alignment/mod.rs).

Semantics pinned down here (and documented as THE framework semantics):

- Gap model: a gap of length L costs ``open + (L-1) * ext`` — the gap-open
  penalty alone is charged for the first gapped position (reference doc:
  src/aligner/mod.rs:140-149).
- Matrix layout: rows = query positions i, cols = reference positions j,
  table cell (i, j) is the DP value after consuming query[..=i], ref[..=j].
- E is the vertical gap matrix (consumes query; CIGAR 'I'; trace INS/INS_E),
  F is the horizontal gap matrix (consumes reference; CIGAR 'D';
  trace DEL/DEL_F).  Flag bit values are bit-identical to the reference
  (src/alignment/table.rs:129-141).
- Tie-breaking: H-direction DIAG > INS > DEL; gap matrices prefer open
  (DIAG_E / DIAG_F) on ties; end-position argmax prefers the smallest i,
  then smallest j, among maximal cells.
- Semi-global free ends: ``qb`` (gaps at query begin free) zeroes the top
  boundary row, ``db`` zeroes the left boundary column, ``qe`` adds the last
  row to the end-candidate set, ``de`` adds the last column; the corner is
  always a candidate.  Plain ``sg`` == all four free
  (reference grammar: src/aligner/mod.rs:270-299).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import (
    TRACE_DEL,
    TRACE_DEL_F,
    TRACE_DIAG,
    TRACE_DIAG_E,
    TRACE_DIAG_F,
    TRACE_INS,
    TRACE_INS_E,
    TRACE_H_BITS,
    TRACE_ZERO,
)

NEG = -(10**9)  # -inf stand-in, safe for int64 accumulation


@dataclass
class GoldenResult:
    """Everything a kernel variant could output, from one scalar fill."""

    score: int
    end_query: int
    end_ref: int
    matches: int
    similar: int
    length: int
    score_table: np.ndarray        # (qlen, rlen) int
    matches_table: np.ndarray
    similar_table: np.ndarray
    length_table: np.ndarray
    trace_table: np.ndarray        # (qlen, rlen) int8 flags
    saturated: bool = False

    @property
    def score_row(self) -> np.ndarray:
        return self.score_table[-1, :]

    @property
    def score_col(self) -> np.ndarray:
        return self.score_table[:, -1]

    @property
    def matches_row(self) -> np.ndarray:
        return self.matches_table[-1, :]

    @property
    def matches_col(self) -> np.ndarray:
        return self.matches_table[:, -1]

    @property
    def similar_row(self) -> np.ndarray:
        return self.similar_table[-1, :]

    @property
    def similar_col(self) -> np.ndarray:
        return self.similar_table[:, -1]

    @property
    def length_row(self) -> np.ndarray:
        return self.length_table[-1, :]

    @property
    def length_col(self) -> np.ndarray:
        return self.length_table[:, -1]


def free_flags(mode: str, allow_query_gaps=(), allow_ref_gaps=()) -> tuple[bool, bool, bool, bool]:
    """Resolve (qb, qe, db, de) free-end booleans from the builder inputs.

    Mirrors the reference's name grammar (src/aligner/mod.rs:270-299):
    for ``sg``, empty gap lists mean *fully* free semi-global
    (sg == sg_qx_dx); non-empty lists restrict the free ends to exactly
    the listed ones ("prefix" -> begin, "suffix" -> end).
    """
    if mode == "nw":
        return (False, False, False, False)
    if mode == "sw":
        return (True, True, True, True)  # local: all boundaries free by construction
    if not allow_query_gaps and not allow_ref_gaps:
        return (True, True, True, True)
    qb = "prefix" in allow_query_gaps
    qe = "suffix" in allow_query_gaps
    db = "prefix" in allow_ref_gaps
    de = "suffix" in allow_ref_gaps
    return (qb, qe, db, de)


def align(
    sub: np.ndarray,
    is_match: np.ndarray,
    open_: int,
    ext: int,
    mode: str,
    free: tuple[bool, bool, bool, bool] | None = None,
) -> GoldenResult:
    """Scalar Gotoh fill over a dense substitution block.

    Args:
      sub: (qlen, rlen) substitution scores S[i, j].
      is_match: (qlen, rlen) bool, query char i == ref char j (for stats).
      open_, ext: positive gap penalties.
      mode: "nw" | "sg" | "sw".
      free: (qb, qe, db, de); defaults per mode via :func:`free_flags`.
    """
    qlen, rlen = sub.shape
    if free is None:
        free = free_flags(mode)
    qb, qe, db, de = free
    local = mode == "sw"

    # DP arrays over the (qlen+1, rlen+1) bordered grid.
    H = np.full((qlen + 1, rlen + 1), NEG, dtype=np.int64)
    E = np.full((qlen + 1, rlen + 1), NEG, dtype=np.int64)  # vertical (INS)
    F = np.full((qlen + 1, rlen + 1), NEG, dtype=np.int64)  # horizontal (DEL)
    # Stats accumulators ride along each matrix.
    Hm = np.zeros_like(H); Hs = np.zeros_like(H); Hl = np.zeros_like(H)
    Em = np.zeros_like(H); Es = np.zeros_like(H); El = np.zeros_like(H)
    Fm = np.zeros_like(H); Fs = np.zeros_like(H); Fl = np.zeros_like(H)

    H[0, 0] = 0
    for j in range(1, rlen + 1):
        H[0, j] = 0 if (qb or local) else -(open_ + (j - 1) * ext)
        Hl[0, j] = 0 if (qb or local) else j
    for i in range(1, qlen + 1):
        H[i, 0] = 0 if (db or local) else -(open_ + (i - 1) * ext)
        Hl[i, 0] = 0 if (db or local) else i

    trace = np.zeros((qlen, rlen), dtype=np.int8)

    for i in range(1, qlen + 1):
        for j in range(1, rlen + 1):
            # E: vertical gap (consumes query char i-1).
            e_open = H[i - 1, j] - open_
            e_ext = E[i - 1, j] - ext
            if e_open >= e_ext:
                E[i, j] = e_open
                Em[i, j], Es[i, j], El[i, j] = Hm[i - 1, j], Hs[i - 1, j], Hl[i - 1, j] + 1
                eflag = TRACE_DIAG_E
            else:
                E[i, j] = e_ext
                Em[i, j], Es[i, j], El[i, j] = Em[i - 1, j], Es[i - 1, j], El[i - 1, j] + 1
                eflag = TRACE_INS_E

            # F: horizontal gap (consumes ref char j-1).
            f_open = H[i, j - 1] - open_
            f_ext = F[i, j - 1] - ext
            if f_open >= f_ext:
                F[i, j] = f_open
                Fm[i, j], Fs[i, j], Fl[i, j] = Hm[i, j - 1], Hs[i, j - 1], Hl[i, j - 1] + 1
                fflag = TRACE_DIAG_F
            else:
                F[i, j] = f_ext
                Fm[i, j], Fs[i, j], Fl[i, j] = Fm[i, j - 1], Fs[i, j - 1], Fl[i, j - 1] + 1
                fflag = TRACE_DEL_F

            s = int(sub[i - 1, j - 1])
            diag = H[i - 1, j - 1] + s
            # H selection, tie priority DIAG > INS(E) > DEL(F).
            if diag >= E[i, j] and diag >= F[i, j]:
                h, hflag = diag, TRACE_DIAG
                Hm[i, j] = Hm[i - 1, j - 1] + int(is_match[i - 1, j - 1])
                Hs[i, j] = Hs[i - 1, j - 1] + int(s > 0)
                Hl[i, j] = Hl[i - 1, j - 1] + 1
            elif E[i, j] >= F[i, j]:
                h, hflag = E[i, j], TRACE_INS
                Hm[i, j], Hs[i, j], Hl[i, j] = Em[i, j], Es[i, j], El[i, j]
            else:
                h, hflag = F[i, j], TRACE_DEL
                Hm[i, j], Hs[i, j], Hl[i, j] = Fm[i, j], Fs[i, j], Fl[i, j]

            if local and h <= 0:
                h, hflag = 0, TRACE_ZERO
                Hm[i, j] = Hs[i, j] = Hl[i, j] = 0
            H[i, j] = h
            trace[i - 1, j - 1] = np.int8(hflag | eflag | fflag)

    # End cell selection.
    if mode == "nw":
        ei, ej = qlen, rlen
    elif local:
        interior = H[1:, 1:]
        best = interior.max(initial=0)
        if best <= 0:
            ei = ej = 1  # degenerate: empty local alignment
            best = 0
            pos = None
        else:
            pos = np.argwhere(interior == best)
            # min i then min j among maxima
            ei, ej = pos[np.lexsort((pos[:, 1], pos[:, 0]))[0]] + 1
    else:
        candidates = [(int(H[qlen, rlen]), qlen, rlen)]
        if qe:
            for j in range(1, rlen + 1):
                candidates.append((int(H[qlen, j]), qlen, j))
        if de:
            for i in range(1, qlen + 1):
                candidates.append((int(H[i, rlen]), i, rlen))
        best = max(c[0] for c in candidates)
        maxima = [(i, j) for (v, i, j) in candidates if v == best]
        ei, ej = min(maxima)  # (min i, then min j)

    score = int(H[ei, ej])
    return GoldenResult(
        score=score,
        end_query=ei - 1,
        end_ref=ej - 1,
        matches=int(Hm[ei, ej]),
        similar=int(Hs[ei, ej]),
        length=int(Hl[ei, ej]),
        score_table=H[1:, 1:].astype(np.int64),
        matches_table=Hm[1:, 1:].astype(np.int64),
        similar_table=Hs[1:, 1:].astype(np.int64),
        length_table=Hl[1:, 1:].astype(np.int64),
        trace_table=trace,
    )


def align_seqs(
    query,
    reference,
    matrix,
    open_: int,
    ext: int,
    mode: str = "nw",
    free: tuple[bool, bool, bool, bool] | None = None,
) -> GoldenResult:
    """Convenience wrapper: byte sequences + Matrix -> GoldenResult."""
    q = matrix.encode(query)
    r = matrix.encode(reference)
    sub = matrix.scores_for(q, r).astype(np.int64)
    # `matches` compares mapped indices (case-insensitive, wildcard-folded),
    # matching parasail's profile-kernel semantics where only indices exist.
    is_match = q[:, None] == r[None, :]
    return align(sub, is_match, open_, ext, mode, free)


# ---------------------------------------------------------------------------
# Traceback walk: trace flags -> CIGAR ops + aligned strings.
# ---------------------------------------------------------------------------
@dataclass
class Walk:
    """Result of a traceback walk.

    ``ops`` are (length, op_char) runs over {'=', 'X', 'I', 'D'};
    ``beg_query`` / ``beg_ref`` are the 0-based coordinates of the first
    aligned pair (unaligned free-end overhang excluded).
    """

    ops: list[tuple[int, str]]
    beg_query: int
    beg_ref: int

    def cigar_string(self) -> str:
        return "".join(f"{n}{op}" for n, op in self.ops)


def walk_trace(
    trace: np.ndarray,
    query: bytes,
    reference: bytes,
    end_query: int,
    end_ref: int,
    mode: str,
    free: tuple[bool, bool, bool, bool] | None = None,
) -> Walk:
    """Walk the flag table back from the end cell (affine state machine).

    State H follows the H-family bits; entering a gap switches to the E/F
    family whose *current cell* bits say whether the gap continues
    (INS_E / DEL_F) or closes into H (DIAG_E / DIAG_F) — the standard
    affine traceback the reference reaches via parasail's CIGAR walker
    (src/alignment/mod.rs:390-419).
    """
    if free is None:
        free = free_flags(mode)
    qb, _qe, db, _de = free
    local = mode == "sw"

    i, j = end_query, end_ref
    rev: list[str] = []
    state = "H"
    while i >= 0 and j >= 0:
        t = int(trace[i, j])
        if state == "H":
            h = t & TRACE_H_BITS
            if h == TRACE_ZERO and local:
                break
            if h & TRACE_DIAG:
                rev.append("=" if query[i] == reference[j] else "X")
                i -= 1
                j -= 1
            elif h & TRACE_INS:
                rev.append("I")
                state = "H" if (t & TRACE_DIAG_E) else "E"
                i -= 1
            elif h & TRACE_DEL:
                rev.append("D")
                state = "H" if (t & TRACE_DIAG_F) else "F"
                j -= 1
            else:  # ZERO in a non-local table should not happen
                break
        elif state == "E":
            rev.append("I")
            state = "H" if (t & TRACE_DIAG_E) else "E"
            i -= 1
        else:  # state == "F"
            rev.append("D")
            state = "H" if (t & TRACE_DIAG_F) else "F"
            j -= 1

    beg_query, beg_ref = i + 1, j + 1
    if not local:
        # Boundary runs: penalized leading gaps belong to the alignment;
        # free leading gaps are unaligned overhang (recorded via beg_*).
        if i >= 0 and j < 0 and not db:
            rev.extend("I" * (i + 1))
            beg_query = 0
        if j >= 0 and i < 0 and not qb:
            rev.extend("D" * (j + 1))
            beg_ref = 0

    ops: list[tuple[int, str]] = []
    for c in reversed(rev):
        if ops and ops[-1][1] == c:
            ops[-1] = (ops[-1][0] + 1, c)
        else:
            ops.append((1, c))
    return Walk(ops=ops, beg_query=beg_query, beg_ref=beg_ref)


def aligned_strings(
    walk: Walk, query: bytes, reference: bytes
) -> tuple[str, str, str]:
    """Expand a walk into (query, comparison, reference) display rows.

    Matches the reference's traceback string convention: '|' for an exact
    match, ' ' otherwise, '-' for gaps (src/alignment/mod.rs:347-387).
    """
    qi, ri = walk.beg_query, walk.beg_ref
    qrow, comp, rrow = [], [], []
    for n, op in walk.ops:
        for _ in range(n):
            if op in ("=", "X"):
                qc, rc = chr(query[qi]), chr(reference[ri])
                qrow.append(qc)
                rrow.append(rc)
                comp.append("|" if qc == rc else " ")
                qi += 1
                ri += 1
            elif op == "I":
                qrow.append(chr(query[qi]))
                rrow.append("-")
                comp.append(" ")
                qi += 1
            else:  # 'D'
                qrow.append("-")
                rrow.append(chr(reference[ri]))
                comp.append(" ")
                ri += 1
    return "".join(qrow), "".join(comp), "".join(rrow)


def banded_nw_fill(sub: np.ndarray, open_: int, ext: int, bw: int) -> int:
    """Scalar banded NW fill oracle, row-at-a-time over the band.

    The reference's parasail_nw_banded is likewise a non-vectorized scalar
    kernel (doc: src/aligner/mod.rs:454-456); here each DP row updates as
    a numpy slice with out-of-band cells pinned at -inf.  Oracle only —
    the production banded route is the Pallas/XLA kernels' banded mode.
    """
    qlen, rlen = sub.shape
    NEG = -(10 ** 9)
    Hprev = np.full(rlen + 1, NEG, dtype=np.int64)
    Eprev = np.full(rlen + 1, NEG, dtype=np.int64)
    Hprev[0] = 0
    for j in range(1, rlen + 1):
        Hprev[j] = -(open_ + (j - 1) * ext) if abs(j) <= bw else NEG
    for i in range(1, qlen + 1):
        H = np.full(rlen + 1, NEG, dtype=np.int64)
        E = np.full(rlen + 1, NEG, dtype=np.int64)
        H[0] = -(open_ + (i - 1) * ext) if i <= bw else NEG
        lo, hi = max(1, i - bw), min(rlen, i + bw)
        F = NEG
        for j in range(lo, hi + 1):
            E[j] = max(Hprev[j] - open_, Eprev[j] - ext)
            F = max(H[j - 1] - open_, F - ext)
            H[j] = max(Hprev[j - 1] + int(sub[i - 1, j - 1]), E[j], F)
        Hprev, Eprev = H, E
    return int(Hprev[rlen])
