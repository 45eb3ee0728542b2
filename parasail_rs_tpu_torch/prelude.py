"""Flat import surface, mirroring the reference prelude
(reference: src/prelude.rs:1-25).

    from parasail_rs_tpu_torch.prelude import Aligner, Matrix, Profile, ...
"""

from .constants import InstructionSet, SolutionWidth, TraceFlags
from .engine import (
    Aligner,
    AlignerBuilder,
    Alignment,
    Profile,
    ProfileBuilder,
    SSWResult,
    Table,
    Traceback,
    TracebackTable,
)
from .errors import ParasailError
from .matrices import Matrix

__all__ = [
    "Aligner",
    "AlignerBuilder",
    "Alignment",
    "SSWResult",
    "Traceback",
    "Table",
    "TraceFlags",
    "TracebackTable",
    "ParasailError",
    "Matrix",
    "Profile",
    "ProfileBuilder",
    "SolutionWidth",
    "InstructionSet",
]
