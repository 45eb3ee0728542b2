"""ctypes binding + on-demand build for the streamed row fill
(``ptfill.cc``).

Built and cached as :mod:`packer` builds ``ptpack.cc`` (the source's
hash in the name, atomic rename into the port's ``_build/``), loaded
through ``ctypes.PyDLL`` since it reads ``PyBytes`` internals.
:func:`fill` returns None wherever it cannot serve, and the caller keeps
the packer's fill.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import sysconfig
import threading

from .packer import _lib_dir

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ptfill.cc")

# fills of at least this many bytes stream their stores: a smaller
# buffer stays in the cache, where the card's copy reads it from
MIN_STREAM_BYTES = 1 << 22

_lock = threading.Lock()
_lib = None
_tried = False


def _lib_name() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:10]
    return f"libptfill-{sys.implementation.cache_tag}-{tag}.so"


def _build() -> str | None:
    final = os.path.join(_lib_dir(), _lib_name())
    if os.path.exists(final):
        return final
    tmp = final + f".tmp{os.getpid()}"
    try:
        os.makedirs(_lib_dir(), exist_ok=True)
        subprocess.run(
            [os.environ.get("CXX", "g++"), "-O2", "-shared", "-fPIC",
             "-std=c++17",
             f"-I{sysconfig.get_paths()['include']}", _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, final)
        return final
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def _reset_after_fork() -> None:
    global _lock, _lib, _tried
    _lock = threading.Lock()
    _lib = None
    _tried = False


os.register_at_fork(after_in_child=_reset_after_fork)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    lib = None
    path = _build() if os.environ.get("PT_NATIVE_PACK", "1") != "0" else None
    if path is not None:
        try:
            lib = ctypes.PyDLL(path)
            lib.pt_fill_rows.restype = ctypes.c_int
            lib.pt_fill_rows.argtypes = [
                ctypes.py_object, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_int32]
        except (OSError, AttributeError):
            lib = None
    with _lock:
        if not _tried:
            _lib, _tried = lib, True
        return _lib


def fill(seqs, P: int, out) -> int | None:
    """Fill the (len(seqs), P) uint8 array ``out`` with ``seqs`` (a list
    of bytes) padded with zeros, streamed from :data:`MIN_STREAM_BYTES`:
    ptfill.cc's return code, or None with no library."""
    lib = _load()
    if lib is None or type(seqs) is not list:
        return None
    return lib.pt_fill_rows(seqs, len(seqs), P, out.ctypes.data,
                            int(out.nbytes >= MIN_STREAM_BYTES))
