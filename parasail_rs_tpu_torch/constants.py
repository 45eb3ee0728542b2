"""Shared constants: trace-flag encoding, CIGAR codec values, enums.

The trace-flag bit encoding is kept bit-identical to the reference so that
trace tables and CIGARs are byte-comparable
(reference: src/alignment/table.rs:127-142).
"""

from __future__ import annotations

import enum

# ---------------------------------------------------------------------------
# Trace flags (bit-identical to reference src/alignment/table.rs:129-141)
# ---------------------------------------------------------------------------
TRACE_ZERO = 0       # local-alignment restart cell (H == 0)
TRACE_INS = 1        # H came from E  (vertical move: consumes query, CIGAR 'I')
TRACE_DEL = 2        # H came from F  (horizontal move: consumes reference, CIGAR 'D')
TRACE_DIAG = 4       # H came from the diagonal
TRACE_DIAG_E = 8     # E opened from H (gap-open on the vertical gap matrix)
TRACE_INS_E = 16     # E extended from E
TRACE_DIAG_F = 32    # F opened from H (gap-open on the horizontal gap matrix)
TRACE_DEL_F = 64     # F extended from F

# Masks (reference: table.rs:130-132).  ANDing with a mask *clears* the family:
TRACE_ZERO_MASK = 120   # keeps only E/F bits (clears the H-family bits 1|2|4)
TRACE_E_MASK = 103      # clears the E-family bits (8|16)
TRACE_F_MASK = 31       # clears the F-family bits (32|64)

TRACE_H_BITS = TRACE_INS | TRACE_DEL | TRACE_DIAG   # = 7


class TraceFlags(enum.IntFlag):
    """IntFlag mirror of the reference ``TraceFlags`` bitflags.

    reference: src/alignment/table.rs:127-170
    """

    ZERO = TRACE_ZERO
    INS = TRACE_INS
    DEL = TRACE_DEL
    DIAG = TRACE_DIAG
    DIAG_E = TRACE_DIAG_E
    INS_E = TRACE_INS_E
    DIAG_F = TRACE_DIAG_F
    DEL_F = TRACE_DEL_F

    def display(self) -> str:
        """Render like the reference Display impl (table.rs:144-170)."""
        parts = []
        if self & TraceFlags.INS:
            parts.append("INS")
        if self & TraceFlags.DEL:
            parts.append("DEL")
        if self & TraceFlags.DIAG:
            parts.append("DIAG")
        if self & TraceFlags.INS_E:
            parts.append("INS_E")
        if self & TraceFlags.DEL_F:
            parts.append("DEL_F")
        if self & TraceFlags.DIAG_E:
            parts.append("DIAG_E")
        if self & TraceFlags.DIAG_F:
            parts.append("DIAG_F")
        return "|".join(parts)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.display()


# ---------------------------------------------------------------------------
# CIGAR codec.  Encoded op = (length << 4) | op_code, decoded with the op
# character table below ("MIDNSHP=XB", SAM order).  This matches the packing
# the reference exposes through parasail_cigar_decode
# (reference: src/alignment/mod.rs:390-419) and the SSW raw u32 buffer
# (reference: src/alignment/mod.rs:537-543).
# ---------------------------------------------------------------------------
CIGAR_OPS = "MIDNSHP=XB"
CIGAR_OP_M = 0
CIGAR_OP_I = 1
CIGAR_OP_D = 2
CIGAR_OP_N = 3
CIGAR_OP_S = 4
CIGAR_OP_H = 5
CIGAR_OP_P = 6
CIGAR_OP_EQ = 7
CIGAR_OP_X = 8
CIGAR_OP_B = 9


def cigar_encode(length: int, op: str) -> int:
    return (length << 4) | CIGAR_OPS.index(op)


def cigar_decode_one(value: int) -> tuple[int, str]:
    return value >> 4, CIGAR_OPS[value & 0xF]


def cigar_runs_string(packed) -> str:
    """Packed uint32 runs ((len<<4)|op, the parasail codec) -> CIGAR
    string — the shared decode for every batched native walk."""
    return "".join(f"{int(v) >> 4}{CIGAR_OPS[int(v) & 0xF]}" for v in packed)


_RUN_TOKENS: list[str] | None = None


def _run_tokens() -> list[str]:
    """Lazily built token table: packed run value -> "lenOP" string for
    every run length < 4096 (64k entries, ~4 MB, built once)."""
    global _RUN_TOKENS
    if _RUN_TOKENS is None:
        # op nibbles beyond the 10-char codec never occur in walk
        # output (_OP_TO_CIGAR emits {0,1,2,7,8}); pad so the table
        # covers every uint16 anyway
        ops = CIGAR_OPS + "?" * (16 - len(CIGAR_OPS))
        _RUN_TOKENS = [f"{v >> 4}{ops[v & 15]}" for v in range(1 << 16)]
    return _RUN_TOKENS


def cigar_strings_batch(packed_flat, counts) -> list[str]:
    """Whole-batch CIGAR strings from flat packed runs + per-pair run
    counts (ops_to_runs_flat's layout).

    One bulk ``tolist()`` + a memoized token lookup replaces per-pair
    generator joins over numpy scalars, whose int() conversions and
    f-string formatting cost ~1 us per run — 80-200 ms per 4096-pair
    batch on the align_cigars serving path (stage probe, 2026-08-20)."""
    tok = _run_tokens()
    ops = CIGAR_OPS
    parts = [tok[v] if v < 65536 else f"{v >> 4}{ops[v & 15]}"
             for v in packed_flat.tolist()]
    out = []
    pos = 0
    for c in counts.tolist():
        out.append("".join(parts[pos:pos + c]))
        pos += c
    return out


# ---------------------------------------------------------------------------
# Public enums (reference: src/prelude.rs:9-25)
# ---------------------------------------------------------------------------
class SolutionWidth(enum.Enum):
    """Narrow-integer solution width knob (reference: prelude.rs:9-15).

    SAT runs the 8-bit kernel first and promotes saturated pairs to wider
    widths (the TPU replacement for parasail's 8->16 retry ladder).
    """

    SAT = "sat"
    BIT8 = "8"
    BIT16 = "16"
    BIT32 = "32"
    BIT64 = "64"


class InstructionSet(enum.Enum):
    """CPU ISA knob kept for API parity (reference: prelude.rs:18-25).

    On TPU there is a single vector unit, so every value maps to the same
    kernel layout; the knob is accepted and recorded but does not change
    dispatch.
    """

    BEST = "best"
    SSE2 = "sse2"
    SSE41 = "sse41"
    AVX2 = "avx2"
    ALTIVEC = "altivec"
    NEON = "neon"


# Integer limits for the narrow-width kernels (saturation thresholds).
WIDTH_MAX = {"8": 127, "16": 32767, "32": 2**31 - 1, "64": 2**63 - 1}
WIDTH_MIN = {"8": -128, "16": -32768, "32": -(2**31), "64": -(2**63)}

# Sentinel used as -infinity inside int32 DP kernels.  Chosen so that
# NEG_INF - open - ext cannot wrap around int32.
NEG_INF32 = -(2**30)
