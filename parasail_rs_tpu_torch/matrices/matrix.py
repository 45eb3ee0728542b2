"""Substitution matrices.

Pure NumPy re-creation of the reference's matrix engine — the constructors,
file parser, PSSM conversion, and mutation surface of
reference: src/matrix/mod.rs (backed there by parasail's C matrix API).

A matrix is a dense ``(length, size)`` int32 array plus a 256-entry byte ->
index ``mapper``.  ``size`` counts the columns (alphabet + wildcard),
``length`` counts the rows (== size for square matrices; == number of query
positions for PSSMs) — mirroring the C struct fields the reference reads
(src/matrix/mod.rs:256-258).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..errors import (
    FailedLookup,
    FileNotFound,
    InteriorNulByte,
    InvalidIndex,
    MatrixError,
    NotBuiltIn,
    NotSquare,
    NullMatrix,
)
from . import data as _data

SQUARE = "square"
PSSM = "pssm"


def _as_bytes(x: bytes | str) -> bytes:
    b = x.encode() if isinstance(x, str) else bytes(x)
    if 0 in b:
        raise InteriorNulByte("sequence/alphabet contains an interior NUL byte")
    return b


def _make_mapper(alphabet: bytes, default: int) -> np.ndarray:
    """Byte -> matrix-index map, case-insensitive, unknown -> ``default``."""
    mapper = np.full(256, default, dtype=np.int32)
    for i, c in enumerate(alphabet):
        mapper[c] = i
        ch = chr(c)
        mapper[ord(ch.upper())] = i
        mapper[ord(ch.lower())] = i
    return mapper


@dataclass
class Matrix:
    """Substitution matrix (square or position-specific).

    Construction mirrors the reference surface (src/matrix/mod.rs):
    ``create``, ``from_name`` (``Matrix::from``), ``from_file``,
    ``create_pssm``, ``to_pssm``, ``set_value``; plus ``Default`` semantics
    via :meth:`default`.
    """

    data: np.ndarray                    # (length, size) int32
    mapper: np.ndarray                  # (256,) int32
    alphabet: bytes
    kind: str = SQUARE                  # SQUARE | PSSM  (C field `type_`)
    name: str | None = None
    builtin: bool = False
    approximate: bool = False
    query: bytes | None = None          # PSSM representative sequence, if any
    _frozen: bool = field(default=False, repr=False)

    # -- C-struct-style accessors -------------------------------------------
    @property
    def size(self) -> int:
        """Number of columns (alphabet incl. wildcard)."""
        return int(self.data.shape[1])

    @property
    def length(self) -> int:
        """Number of rows (== size for square, == positions for PSSM)."""
        return int(self.data.shape[0])

    @property
    def max(self) -> int:
        return int(self.data.max())

    @property
    def min(self) -> int:
        return int(self.data.min())

    @property
    def is_square(self) -> bool:
        return self.kind == SQUARE

    # -- constructors --------------------------------------------------------
    @classmethod
    def create(cls, alphabet: bytes | str, match_score: int, mismatch_score: int) -> "Matrix":
        """Match/mismatch matrix over an alphabet (src/matrix/mod.rs:34-44).

        Match must be >= 0 and mismatch <= 0 (same asserts as the reference).
        The built matrix is (n+1)x(n+1): the extra final row/column is the
        wildcard bucket (score 0) for out-of-alphabet characters.
        """
        if not (match_score >= 0 and mismatch_score <= 0):
            raise MatrixError(
                "Match score should be a positive integer and mismatch score "
                "should be a negative integer."
            )
        alphabet = _as_bytes(alphabet)
        if not alphabet:
            raise MatrixError("Alphabet should not be empty.")
        n = len(alphabet)
        m = np.full((n + 1, n + 1), mismatch_score, dtype=np.int32)
        np.fill_diagonal(m, match_score)
        m[n, :] = 0
        m[:, n] = 0
        mapper = _make_mapper(alphabet, default=n)
        return cls(data=m, mapper=mapper, alphabet=alphabet)

    @classmethod
    def from_name(cls, matrix_name: str) -> "Matrix":
        """Builtin lookup: blosum{30..100}, pam{10..500 step 10}
        (src/matrix/mod.rs:46-73)."""
        if not matrix_name:
            raise MatrixError("Matrix name should not be empty.")
        found = _data.lookup_builtin(matrix_name)
        if found is None:
            raise FailedLookup(matrix_name)
        arr, approx = found
        alphabet = _data.PROTEIN_ALPHABET.encode()
        mapper = _make_mapper(alphabet, default=len(alphabet) - 1)
        return cls(
            data=arr, mapper=mapper, alphabet=alphabet, name=matrix_name,
            builtin=True, approximate=approx, _frozen=True,
        )

    # keep the reference's method name reachable too
    from_ = from_name

    @classmethod
    def from_file(cls, path: str | os.PathLike) -> "Matrix":
        """Parse a square or PSSM matrix file (src/matrix/mod.rs:75-151).

        Format (per the reference doc comment and parasail's parser):
        '#' lines are comments; the first non-comment row is the alphabet.
        Square files repeat the alphabet in the first column and must end
        with a non-alphabet (wildcard) row+column.  PSSM files have one row
        per query position, with an optional leading residue column.
        """
        path = os.fspath(path)
        if not os.path.exists(path):
            raise FileNotFound(path)
        with open(path, "r") as f:
            lines = [ln.strip() for ln in f]
        lines = [ln for ln in lines if ln and not ln.startswith("#")]
        if not lines:
            raise NullMatrix(f"no matrix content in {path}")

        header = lines[0].split()
        if any(len(tok) != 1 for tok in header):
            raise NullMatrix(f"malformed alphabet header in {path}")
        alphabet = "".join(header).encode()
        ncols = len(header)

        rows: list[list[int]] = []
        row_labels: list[str] = []
        for ln in lines[1:]:
            toks = ln.split()
            if not toks:
                continue
            if len(toks) == ncols + 1:
                row_labels.append(toks[0])
                vals = toks[1:]
            elif len(toks) == ncols:
                row_labels.append("")
                vals = toks
            else:
                raise NullMatrix(f"row width mismatch in {path}: {ln!r}")
            try:
                rows.append([int(v) for v in vals])
            except ValueError as e:
                raise NullMatrix(f"non-integer matrix value in {path}: {e}")

        arr = np.array(rows, dtype=np.int32)
        labels = "".join(row_labels)
        is_square_file = (
            arr.shape[0] == ncols
            and labels == "".join(header)
        )
        if is_square_file:
            # Square: wildcard must be the trailing non-alphabet row/col.
            mapper = _make_mapper(alphabet, default=ncols - 1)
            return cls(
                data=arr, mapper=mapper, alphabet=alphabet,
                kind=SQUARE, name=os.path.basename(path),
            )
        # PSSM: one row per position.
        mapper = _make_mapper(alphabet, default=0)
        return cls(
            data=arr, mapper=mapper, alphabet=alphabet, kind=PSSM,
            name=os.path.basename(path),
            query=labels.encode() if labels else None,
        )

    @classmethod
    def create_pssm(cls, alphabet: bytes | str, values, rows: int) -> "Matrix":
        """Position-specific matrix from flat values (src/matrix/mod.rs:154-169).

        parasail does not validate len(values) == rows*len(alphabet); we pad
        missing entries with zeros (and truncate extras) so the same inputs
        the reference accepts are accepted here.
        """
        alphabet = _as_bytes(alphabet)
        if not alphabet:
            raise MatrixError("Alphabet should not be empty.")
        n = len(alphabet)
        vals = np.asarray(list(values), dtype=np.int64).ravel()
        need = rows * n
        if vals.size < need:
            vals = np.concatenate([vals, np.zeros(need - vals.size, dtype=np.int64)])
        arr = vals[:need].reshape(rows, n).astype(np.int32)
        mapper = _make_mapper(alphabet, default=0)
        return cls(data=arr, mapper=mapper, alphabet=alphabet, kind=PSSM)

    @classmethod
    def default(cls) -> "Matrix":
        """Identity DNA matrix (src/matrix/mod.rs:246-250).

        The reference's default is ``create(b"ACGTA", 1, -1)`` — note the
        duplicated 'A' (later mapper entries win, exactly like parasail's
        mapper loop), reproduced here for bit parity.
        """
        return cls.create(b"ACGTA", 1, -1)

    # -- conversions / mutation ---------------------------------------------
    def to_pssm(self, pssm_query: bytes | str) -> "Matrix":
        """Square -> PSSM conversion (src/matrix/mod.rs:180-212)."""
        query = _as_bytes(pssm_query)
        if not query:
            raise MatrixError("PSSM query sequence should not be empty.")
        if self.kind != SQUARE:
            raise NotSquare("matrix is already position-specific")
        idx = self.mapper[np.frombuffer(query, dtype=np.uint8)]
        arr = self.data[idx, :].copy()
        return Matrix(
            data=arr, mapper=self.mapper.copy(), alphabet=self.alphabet,
            kind=PSSM, name=self.name, builtin=self.builtin,
            approximate=self.approximate, query=query,
        )

    def set_value(self, row: int, col: int, value: int) -> None:
        """Mutate one cell of a user matrix (src/matrix/mod.rs:222-242).

        Builtin matrices are immutable; indices are bounded to
        ``0..=size-2`` (the wildcard row/col is not writable), matching the
        reference's bounds check.
        """
        if self.builtin or self._frozen:
            raise NotBuiltIn("cannot mutate a builtin matrix")
        hi = self.size - 2
        if hi < 0:
            raise NullMatrix("matrix too small")
        if not (0 <= row <= hi and 0 <= col <= hi):
            raise InvalidIndex(f"({row}, {col})")
        self.data[row, col] = value

    def copy(self) -> "Matrix":
        """Clone; clones are never builtin (src/matrix/mod.rs:279-294)."""
        return Matrix(
            data=self.data.copy(), mapper=self.mapper.copy(),
            alphabet=self.alphabet, kind=self.kind, name=self.name,
            builtin=False, approximate=self.approximate, query=self.query,
        )

    __copy__ = copy

    # -- encoding ------------------------------------------------------------
    def encode(self, seq: bytes | str) -> np.ndarray:
        """Map a byte sequence to matrix indices via the mapper."""
        b = _as_bytes(seq)
        return self.mapper[np.frombuffer(b, dtype=np.uint8)].astype(np.int32)

    def scores_for(self, query_idx: np.ndarray, ref_idx: np.ndarray) -> np.ndarray:
        """Dense (qlen, rlen) substitution-score block.

        Square: S[i, j] = M[q_i, r_j].  PSSM: S[i, j] = M[i mod length, r_j]
        (position-indexed rows).
        """
        if self.kind == SQUARE:
            return self.data[np.ix_(query_idx, ref_idx)]
        rows = np.arange(len(query_idx)) % self.length
        return self.data[np.ix_(rows, ref_idx)]

    # -- display (src/matrix/mod.rs:253-268) ---------------------------------
    def __str__(self) -> str:
        out = []
        for i in range(self.length):
            out.append(" ".join(str(int(v)) for v in self.data[i]) + " ")
        return "\n".join(out) + "\n"
