"""User-facing engine of the PyTorch port: builder, aligner, profiles and
result objects."""

from .aligner import Aligner, AlignerBuilder
from .profile import Profile, ProfileBuilder
from .result import Alignment, SSWResult, Table, Traceback, TracebackTable

__all__ = [
    "Aligner",
    "AlignerBuilder",
    "Alignment",
    "Profile",
    "ProfileBuilder",
    "SSWResult",
    "Table",
    "Traceback",
    "TracebackTable",
]
