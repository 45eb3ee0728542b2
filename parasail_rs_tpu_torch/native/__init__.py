"""Native host components (C++ via ctypes).

The reference's kernel layer is native C reached through FFI (SURVEY.md
§2.2); the TPU build keeps the DP fill on the device and moves the
inherently-serial host work — the traceback walk and CIGAR encoding — to
C++ (``ptwalk.cc``), loaded here through ctypes.  The library is built
on demand with the system compiler; everything degrades to the Python
golden-model walker when a compiler is unavailable.
"""

from .walker import available, walk_batch, walk_one

__all__ = ["available", "walk_batch", "walk_one"]
