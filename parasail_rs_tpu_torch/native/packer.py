"""ctypes bindings + on-demand build for the C batch packer.

Same build discipline as :mod:`walker` (atomic rename into a user cache
dir, silent fallback when no compiler), but loaded through
``ctypes.PyDLL`` — the entry points read ``PyBytes`` internals, so they
must run with the GIL held.  ``pack_side`` returns None whenever the
fast path cannot serve the input (no library, not a list, non-bytes
items, rows longer than the requested width); the caller keeps the
generic numpy path for those.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import sysconfig
import threading

import numpy as np

from ..errors import InteriorNulByte

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ptpack.cc")

def _src_tag() -> str:
    # cache key includes the source hash: a stale .so from an older
    # source must never be dlopened after an upgrade
    try:
        with open(_SRC, "rb") as f:
            return hashlib.sha1(f.read()).hexdigest()[:10]
    except OSError:
        return "nosrc"


_LIB_NAME = (f"libptpack-{sys.implementation.cache_tag}-"
             f"{_src_tag()}.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _lib_dir() -> str:
    """Build-output directory: the package's own git-ignored ``_build/``
    (read-only installs fall through to this directory)."""
    return os.path.join(os.path.dirname(_HERE), "_build")


def _build() -> str | None:
    cxx = os.environ.get("CXX", "g++")
    inc = sysconfig.get_paths()["include"]
    for out_dir in (_lib_dir(), _HERE):
        final = os.path.join(out_dir, _LIB_NAME)
        if os.path.exists(final):
            return final
        tmp = final + f".tmp{os.getpid()}"
        try:
            os.makedirs(out_dir, exist_ok=True)
        except OSError:
            continue
        try:
            subprocess.run(
                [cxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                 f"-I{inc}", _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, final)
            return final
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            continue
    return None


def _reset_after_fork() -> None:
    # a child forked while another thread held the lock must not inherit
    # it held; it loads (from the cache) again
    global _lock, _lib, _tried
    _lock = threading.Lock()
    _lib = None
    _tried = False


os.register_at_fork(after_in_child=_reset_after_fork)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    # no lock is held while g++ runs: threads racing on a cold cache both
    # compile, and the second rename wins harmlessly
    lib = None
    path = None
    if os.environ.get("PT_NATIVE_PACK", "1") != "0":
        path = _build()
    if path is not None:
        try:
            # PyDLL: calls hold the GIL (the functions touch PyObjects)
            lib = ctypes.PyDLL(path)
        except OSError:
            lib = None
    if lib is not None:
        lib.pt_pack_lens.restype = ctypes.c_longlong
        lib.pt_pack_lens.argtypes = [
            ctypes.py_object, ctypes.c_int32, ctypes.c_void_p]
        lib.pt_pack_fill.restype = ctypes.c_int
        lib.pt_pack_fill.argtypes = [
            ctypes.py_object, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p]
    with _lock:
        if not _tried:
            _lib, _tried = lib, True
        return _lib


def available() -> bool:
    """True when the native packer is built and loaded."""
    return _load() is not None


def pack_side(seqs, P: int | None, bucket):
    """list[bytes] -> (padded (B, P) uint8, (B,) int32 lens, P), or None.

    ``P`` fixes the padded width; None derives it as ``bucket(max_len)``.
    Raises :class:`InteriorNulByte` on embedded NULs (the same contract
    as the numpy path); returns None for anything the fast path cannot
    serve, including rows longer than an explicit ``P``.
    """
    lib = _load()
    if lib is None or type(seqs) is not list:
        return None
    B = len(seqs)
    lens = np.empty(B, np.int32)
    mx = lib.pt_pack_lens(seqs, B, lens.ctypes.data)
    if mx < 0:
        return None
    if P is None:
        P = bucket(int(mx) if B else 1)
    out = np.empty((B, P), np.uint8)
    rc = lib.pt_pack_fill(seqs, B, P, out.ctypes.data)
    if rc == -2:
        raise InteriorNulByte("sequence contains an interior NUL byte")
    if rc != 0:
        return None
    return out, lens, P
