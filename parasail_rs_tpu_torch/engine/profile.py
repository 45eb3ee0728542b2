"""Query profiles: precomputed per-position score rows for reuse.

The reference pre-computes a striped SIMD query profile once and reuses it
across many references (src/profile/mod.rs; usage pattern README.md:38-63).
On TPU the profile is a dense ``(query_len, alphabet)`` int32 tensor — the
row ``P[i, :]`` holds the substitution scores of query position ``i``
against every alphabet index, which the wavefront kernel gathers by
reference index.  The ISA dimension of the reference's 50 constructor
variants (src/profile/mod.rs:113-277) collapses on TPU; the
``InstructionSet`` knob is accepted and recorded for API parity only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import InstructionSet, SolutionWidth
from ..errors import InteriorNulByte, QueryIsEmpty
from ..matrices import Matrix


def _as_bytes(x: bytes | str) -> bytes:
    b = x.encode() if isinstance(x, str) else bytes(x)
    if 0 in b:
        raise InteriorNulByte("query contains an interior NUL byte")
    return b


def profile_rows(matrix: Matrix, qidx: np.ndarray) -> np.ndarray:
    """Dense (qlen, alphabet) score rows for a mapped query.

    Square matrices gather rows by query index; PSSMs are position-indexed
    (row ``i mod length``), matching :meth:`Matrix.scores_for`.
    """
    if matrix.is_square:
        return matrix.data[qidx].astype(np.int32)
    rows = np.arange(len(qidx)) % matrix.length
    return matrix.data[rows].astype(np.int32)


@dataclass
class Profile:
    """Pre-computed query profile (reference: src/profile/mod.rs:281-335).

    Carries the reference's public fields (``use_stats``, ``query_len``)
    plus the device-ready tensors the TPU kernels consume.
    """

    query: bytes = b""
    matrix: Matrix | None = None
    use_stats: bool = False
    solution_width: SolutionWidth = SolutionWidth.SAT
    instruction_set: InstructionSet = InstructionSet.BEST
    rows: np.ndarray | None = None       # (qlen, alphabet) int32
    qidx: np.ndarray | None = None       # (qlen,) int32 mapped indices
    score_size: int | None = None        # SSW knob (new_ssw only)

    @property
    def query_len(self) -> int:
        return len(self.query)

    @property
    def is_null(self) -> bool:
        """True for the default sentinel profile
        (reference: src/profile/mod.rs:365-373)."""
        return self.rows is None

    # -- constructors --------------------------------------------------------
    @classmethod
    def new(cls, query: bytes | str, with_stats: bool, matrix: Matrix) -> "Profile":
        """Profile::new equivalent (reference: src/profile/mod.rs:298-335)."""
        query = _as_bytes(query)
        if not query:
            raise QueryIsEmpty("query sequence is empty")
        qidx = matrix.encode(query)
        return cls(
            query=query, matrix=matrix, use_stats=with_stats,
            rows=profile_rows(matrix, qidx), qidx=qidx,
        )

    @classmethod
    def new_ssw(cls, query: bytes | str, matrix: Matrix, score_size: int) -> "Profile":
        """SSW-style profile (reference: src/profile/mod.rs:337-358).

        ``score_size``: 0 = 8-bit, 1 = 16-bit, 2 = try 8 then 16 — recorded
        and mapped onto the width ladder at align time.
        """
        query = _as_bytes(query)
        if not query:
            raise QueryIsEmpty("Query sequence has length 0.")
        qidx = matrix.encode(query)
        return cls(
            query=query, matrix=matrix, use_stats=True,
            rows=profile_rows(matrix, qidx), qidx=qidx,
            score_size=int(score_size),
        )

    @classmethod
    def builder(cls, query: bytes | str, matrix: Matrix) -> "ProfileBuilder":
        """Reference: Profile::builder (src/profile/mod.rs:289-291)."""
        return ProfileBuilder(query, matrix)

    @classmethod
    def default(cls) -> "Profile":
        """Null-profile sentinel (reference: src/profile/mod.rs:365-373)."""
        return cls()


class ProfileBuilder:
    """ProfileBuilder equivalent (reference: src/profile/mod.rs:42-110).

    Defaults mirror the reference: no stats, ``SolutionWidth.SAT``,
    ``InstructionSet.BEST``.  The 50-arm (stats x ISA x width) constructor
    match of the reference collapses to one dense-tensor constructor on
    TPU; width and ISA are recorded on the built profile.
    """

    def __init__(self, query: bytes | str, matrix: Matrix):
        self._query = query
        self._matrix = matrix
        self._use_stats = False
        self._solution_width = SolutionWidth.SAT
        self._instruction_set = InstructionSet.BEST

    def use_stats(self) -> "ProfileBuilder":
        self._use_stats = True
        return self

    def solution_width(self, solution_width: SolutionWidth) -> "ProfileBuilder":
        self._solution_width = SolutionWidth(solution_width)
        return self

    def instruction_set(self, instruction_set: InstructionSet) -> "ProfileBuilder":
        self._instruction_set = InstructionSet(instruction_set)
        return self

    def build(self) -> Profile:
        p = Profile.new(self._query, self._use_stats, self._matrix)
        p.solution_width = self._solution_width
        p.instruction_set = self._instruction_set
        return p
