"""Substitution-matrix engine (builtin registry, parser, PSSM)."""

from .matrix import PSSM, SQUARE, Matrix
from .data import BLOSUM_NUMBERS, PAM_NUMBERS, PROTEIN_ALPHABET
from .ncbi import register_exact, register_ncbi_dir

__all__ = [
    "Matrix",
    "SQUARE",
    "PSSM",
    "BLOSUM_NUMBERS",
    "PAM_NUMBERS",
    "PROTEIN_ALPHABET",
    "register_exact",
    "register_ncbi_dir",
]
