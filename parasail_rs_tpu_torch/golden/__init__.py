"""Pure-NumPy golden oracle for the DP semantics."""

from .model import (GoldenResult, Walk, align, align_seqs,
                    aligned_strings, banded_nw_fill, free_flags, walk_trace)

__all__ = [
    "GoldenResult",
    "Walk",
    "align",
    "align_seqs",
    "aligned_strings",
    "banded_nw_fill",
    "free_flags",
    "walk_trace",
]
