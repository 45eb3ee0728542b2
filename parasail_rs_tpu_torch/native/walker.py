"""ctypes bindings + on-demand build for the C++ traceback walker.

Mirrors the FFI layer role of the reference (libparasail-sys bindgen
symbols, reference src/alignment/mod.rs:6-23) with a 2-function C ABI:
``pt_walk_trace`` (one pair) and ``pt_walk_batch`` (amortized batch).
Falls back silently to the Python golden-model walker if no compiler or
load failure — call :func:`available` to check which path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

from ..constants import CIGAR_OPS

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ptwalk.cc")

def _src_tag() -> str:
    # cache key includes the source hash: a stale .so from an older
    # source must never be dlopened after an upgrade
    try:
        with open(_SRC, "rb") as f:
            return hashlib.sha1(f.read()).hexdigest()[:10]
    except OSError:
        return "nosrc"


_LIB_NAME = (f"libptwalk-{sys.implementation.cache_tag}-"
             f"{_src_tag()}.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _lib_dir() -> str:
    """Build-output directory: the package's own git-ignored ``_build/``
    (read-only installs fall through to this directory)."""
    return os.path.join(os.path.dirname(_HERE), "_build")


def _build() -> str | None:
    """Compile the walker to a temp file and os.rename() into place —
    atomic, so a concurrent process can never dlopen a partial .so."""
    cxx = os.environ.get("CXX", "g++")
    for out_dir in (_lib_dir(), _HERE):
        final = os.path.join(out_dir, _LIB_NAME)
        if os.path.exists(final):
            return final
        tmp = final + f".tmp{os.getpid()}"
        try:
            os.makedirs(out_dir, exist_ok=True)
        except OSError:
            continue
        for extra in (["-fopenmp"], []):   # threads when available
            try:
                subprocess.run(
                    [cxx, "-O2", "-shared", "-fPIC", "-std=c++17", _SRC,
                     "-o", tmp] + extra,
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
    path = _build()
    if path is not None:
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            lib = None
    if lib is not None:
        lib.pt_walk_trace.restype = ctypes.c_int
        lib.pt_walk_trace.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.pt_walk_batch.restype = None
        lib.pt_walk_batch.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.pt_rle_ops.restype = None
        lib.pt_rle_ops.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.pt_compact_runs.restype = None
        lib.pt_compact_runs.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
    with _lock:
        if not _tried:
            _lib, _tried = lib, True
        return _lib


def available() -> bool:
    """True when the native walker is built and loaded."""
    return _load() is not None


def _decode(packed: np.ndarray) -> list[tuple[int, str]]:
    return [(int(v) >> 4, CIGAR_OPS[int(v) & 0xF]) for v in packed]


def walk_one(trace: np.ndarray, query: bytes, reference: bytes,
             end_q: int, end_r: int, *, local: bool, qb: bool, db: bool,
             merge_m: bool = False):
    """Native walk of one pair; returns (ops, beg_q, beg_r) or None if the
    native library is unavailable (caller falls back to golden)."""
    lib = _load()
    if lib is None:
        return None
    trace = np.ascontiguousarray(trace, dtype=np.int8)
    qlen, rlen = trace.shape
    cap = qlen + rlen + 2
    out = np.empty(cap, dtype=np.uint32)
    bq, br = ctypes.c_int(), ctypes.c_int()
    qbuf = np.frombuffer(bytes(query), dtype=np.uint8)
    rbuf = np.frombuffer(bytes(reference), dtype=np.uint8)
    n = lib.pt_walk_trace(
        trace.ctypes.data, qlen, rlen,
        qbuf.ctypes.data, rbuf.ctypes.data,
        int(end_q), int(end_r), int(local), int(qb), int(db), int(merge_m),
        out.ctypes.data, cap,
        ctypes.byref(bq), ctypes.byref(br))
    if n < 0:  # pragma: no cover - cap is provably sufficient
        return None
    return _decode(out[:n]), bq.value, br.value


def rle_ops(ops: np.ndarray, merge_m: bool = False):
    """Native run-length encode of the device walk's backward opcode
    rows: (B, L) uint8 -> (flat packed uint32 runs, per-pair counts),
    identical values to ops/trace_walk.ops_to_runs_flat.  Returns None
    when the native library is unavailable (caller falls back to the
    vectorized-numpy pass, ~20x slower at 4096x320)."""
    lib = _load()
    if lib is None:
        return None
    ops = np.ascontiguousarray(ops, dtype=np.uint8)
    B, L = ops.shape
    if B == 0:
        return np.empty(0, np.uint32), np.empty(0, np.int64)
    dense = np.empty((B, L), dtype=np.uint32)
    counts32 = np.empty(B, dtype=np.int32)
    lib.pt_rle_ops(B, L, ops.ctypes.data, int(merge_m),
                   dense.ctypes.data, L, counts32.ctypes.data)
    # cap == L cannot overflow (each run covers >= 1 opcode)
    counts = counts32.astype(np.int64)
    offsets = np.cumsum(counts) - counts
    flat = np.empty(int(counts.sum()), dtype=np.uint32)
    lib.pt_compact_runs(B, L, dense.ctypes.data, counts32.ctypes.data,
                        offsets.ctypes.data, flat.ctypes.data)
    return flat, counts


def walk_batch(traces, queries, references, end_qs, end_rs, *,
               local: bool, qb: bool, db: bool, merge_m: bool = False):
    """Batched native walk.

    traces: list of (qlen, rlen) int8 planes.  Returns a list of
    (packed_uint32_runs, beg_q, beg_r) tuples, or None when the native
    library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(traces)
    traces = [np.ascontiguousarray(t, dtype=np.int8) for t in traces]
    qbufs = [np.frombuffer(bytes(q), dtype=np.uint8) for q in queries]
    rbufs = [np.frombuffer(bytes(r), dtype=np.uint8) for r in references]
    qlens = np.array([t.shape[0] for t in traces], dtype=np.int32)
    rlens = np.array([t.shape[1] for t in traces], dtype=np.int32)
    cap = int((qlens + rlens).max()) + 2
    tr_ptrs = (ctypes.c_void_p * n)(*[t.ctypes.data for t in traces])
    q_ptrs = (ctypes.c_void_p * n)(*[q.ctypes.data for q in qbufs])
    r_ptrs = (ctypes.c_void_p * n)(*[r.ctypes.data for r in rbufs])
    end_qs = np.asarray(end_qs, dtype=np.int32)
    end_rs = np.asarray(end_rs, dtype=np.int32)
    cig = np.empty((n, cap), dtype=np.uint32)
    lens = np.empty(n, dtype=np.int32)
    bqs = np.empty(n, dtype=np.int32)
    brs = np.empty(n, dtype=np.int32)
    lib.pt_walk_batch(
        n, tr_ptrs, qlens.ctypes.data, rlens.ctypes.data, q_ptrs, r_ptrs,
        end_qs.ctypes.data, end_rs.ctypes.data,
        int(local), int(qb), int(db), int(merge_m),
        cig.ctypes.data, cap,
        lens.ctypes.data, bqs.ctypes.data, brs.ctypes.data)
    return [
        (cig[k, :lens[k]].copy(), int(bqs[k]), int(brs[k]))
        for k in range(n)
    ]
