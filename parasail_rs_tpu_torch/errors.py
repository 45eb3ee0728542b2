"""Typed error hierarchy.

Mirrors the capability surface of the reference's nested error enums
(reference: src/error.rs:7-17 and the per-module error.rs files), re-expressed
as an idiomatic Python exception tree.  Every variant of the reference enums
has a concrete exception class here so that API-misuse failure modes are
1:1 checkable:

- aligner errors    (reference: src/aligner/error.rs:6-12)
- alignment errors  (reference: src/alignment/error.rs:6-17)
- matrix errors     (reference: src/matrix/error.rs:8-17)
- profile errors    (reference: src/profile/error.rs:7-17)
"""

from __future__ import annotations


class ParasailError(Exception):
    """Base class for all framework errors (reference: src/error.rs)."""


# --------------------------------------------------------------------------
# Aligner errors (reference: src/aligner/error.rs)
# --------------------------------------------------------------------------
class AlignerError(ParasailError):
    """Errors raised while configuring or running an aligner."""


class InteriorNulByte(AlignerError):
    """Sequence contained an interior NUL byte.

    The reference converts byte slices to C strings and fails on interior
    NULs (src/aligner/mod.rs:398-409).  We keep the same contract: NUL is
    not a valid sequence character.
    """


class NoBandwidth(AlignerError):
    """banded_nw() called without .bandwidth() set (src/aligner/mod.rs:464-468)."""


class UnknownKernel(AlignerError):
    """No kernel exists for the requested (mode, outputs, strategy, width) combo.

    The reference panics when the composed parasail function name is not in
    the C dispatch table (src/aligner/mod.rs:353-358).  We raise a typed
    error at build() time instead.
    """


class QueryRequired(AlignerError):
    """align(None, ref) without a profile (src/aligner/mod.rs:403-406)."""


# --------------------------------------------------------------------------
# Alignment (result) errors (reference: src/alignment/error.rs)
# --------------------------------------------------------------------------
class AlignmentError(ParasailError):
    """Errors raised when reading fields off an alignment result."""


class NoStats(AlignmentError):
    """Stats getter on a result computed without stats (src/alignment/mod.rs:79-98)."""


class NoTable(AlignmentError):
    """Table getter on a result computed without tables (src/alignment/mod.rs:123-138)."""


class NoStatsTable(AlignmentError):
    """Stats-table getter without a stats table (src/alignment/mod.rs:141-192)."""


class NoRowCol(AlignmentError):
    """Row/col getter on a result without rowcol output (src/alignment/mod.rs:195-288)."""


class NoTrace(AlignmentError):
    """Trace getter on a result computed without trace (src/alignment/mod.rs:291-307)."""


class InvalidUTF8String(AlignmentError):
    """Traceback/CIGAR bytes not valid UTF-8 (src/alignment/error.rs)."""


# --------------------------------------------------------------------------
# Matrix errors (reference: src/matrix/error.rs)
# --------------------------------------------------------------------------
class MatrixError(ParasailError):
    """Errors raised while constructing or mutating substitution matrices."""


class FailedLookup(MatrixError):
    """Unknown builtin matrix name (src/matrix/mod.rs:65-67)."""


class FileNotFound(MatrixError):
    """Matrix file path does not exist (src/matrix/mod.rs:132-135)."""


class NullMatrix(MatrixError):
    """Matrix construction produced no data (src/matrix/mod.rs:142-144)."""


class NotSquare(MatrixError):
    """PSSM conversion requested on a non-square matrix (src/matrix/mod.rs:193-195)."""


class NotBuiltIn(MatrixError):
    """set_value() on a builtin matrix (src/matrix/mod.rs:223-225).

    (The reference's variant name is inverted w.r.t. its meaning; we keep the
    name for parity but the semantic is "builtin matrices are immutable".)
    """


class InvalidIndex(MatrixError):
    """set_value() row/col out of bounds (src/matrix/mod.rs:234-236)."""


# --------------------------------------------------------------------------
# Profile errors (reference: src/profile/error.rs)
# --------------------------------------------------------------------------
class ProfileError(ParasailError):
    """Errors raised while building query profiles."""


class QueryIsEmpty(ProfileError):
    """Profile::new with an empty query (src/profile/mod.rs:299-301)."""


class ProfileFnLookupFailed(ProfileError):
    """No profile constructor for the requested (stats, width) combo."""


class NullProfile(ProfileError):
    """Profile construction produced no data."""
