"""User-facing engine of the PyTorch port: builder, aligner, profiles and
result objects, and the streaming executor."""

from .aligner import Aligner, AlignerBuilder
from .stream import StreamingAligner
from .profile import Profile, ProfileBuilder
from .result import Alignment, SSWResult, Table, Traceback, TracebackTable

__all__ = [
    "Aligner",
    "AlignerBuilder",
    "StreamingAligner",
    "Alignment",
    "Profile",
    "ProfileBuilder",
    "SSWResult",
    "Table",
    "Traceback",
    "TracebackTable",
]
