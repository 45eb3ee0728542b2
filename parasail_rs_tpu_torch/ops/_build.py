"""Build the CUDA kernels with ``nvcc`` on first use and load them with ctypes.

The sources are ``csrc/*.cu`` and ``csrc/*.cuh`` of this package; the
shared library goes to ``parasail_rs_tpu_torch/_build/``, named by a hash
of the sources and the flags, so a stale library is never loaded after
an edit.  The compiler writes a temporary file that ``os.replace`` moves
into place, so a concurrent process never loads a partial library.

Each ``.cu`` compiles to an object in its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects.  No lock is
held while ``nvcc`` runs, and no background thread builds ahead: the
first caller pays the build (seconds; the sources include no PyTorch
header), and two processes racing on a cold cache both compile and the
second rename wins harmlessly.  A failed build raises.  ``BUILD_LOG``
keeps what ``-Xptxas -v`` said of each kernel (registers, spills).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_lib = None
_load_lock = threading.Lock()     # guards _lib only, never the compiler
BUILD_SECONDS: float | None = None
BUILD_LOG = ""


def _reset_lock_after_fork() -> None:
    # a child forked while another thread held the lock must not inherit
    # it held
    global _load_lock
    _load_lock = threading.Lock()


os.register_at_fork(after_in_child=_reset_lock_after_fork)


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))


def _tag() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``; raises if none exists."""
    candidates = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libptscore-{_tag()}.so")


def _run(procs) -> str:
    """Wait for (cmd, Popen) pairs and return their joined output; raise
    on a failure, and leave no compiler running."""
    try:
        outs = [(cmd, proc, proc.communicate(timeout=600)[0])
                for cmd, proc in procs]
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for cmd, proc, out in outs:
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(out for _, _, out in outs)


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def build() -> str:
    """Compile the kernels unless the library for these sources exists;
    return its path."""
    global BUILD_SECONDS, BUILD_LOG
    final = library_path()
    if os.path.exists(final):
        return final
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{final}.tmp{os.getpid()}"
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    objs, compiles = [], []
    for cu in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(cu)}.o"
        objs.append(obj)
        compiles.append(_start([nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o",
                                obj, cu]))
    try:
        log = _run(compiles)
        log += _run([_start([nvcc, *ARCH, "-shared", "-o", tmp, *objs])])
        os.replace(tmp, final)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.unlink(path)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = log
    return final


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process and
    declare the C signatures."""
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    with _load_lock:
        if _lib is None:
            lib = ctypes.CDLL(path)
            p, i = ctypes.c_void_p, ctypes.c_int
            ll = ctypes.c_longlong
            lib.pt_scan_band_ring.restype = i
            lib.pt_scan_band_ring.argtypes = [p] * 6 + [i] * 12 + [p]
            lib.pt_band_plan.restype = i
            lib.pt_band_plan.argtypes = [i] * 6 + [p]
            lib.pt_scan_short_banded.restype = i
            lib.pt_scan_short_banded.argtypes = ([i] + [p] * 11 + [i] * 11 +
                                                 [p])
            lib.pt_scan_chunked_banded.restype = i
            lib.pt_scan_chunked_banded.argtypes = ([i] + [p] * 16 +
                                                   [i] * 14 + [p])
            lib.pt_scan_segment.restype = i
            lib.pt_scan_segment.argtypes = [i] + [p] * 13 + [i] * 15 + [p]
            lib.pt_scan_segment16.restype = i
            lib.pt_scan_segment16.argtypes = [p] * 12 + [i] * 16 + [p]
            lib.pt_segment16_plan.restype = i
            lib.pt_segment16_plan.argtypes = [i] * 8 + [p]
            lib.pt_scan_rowseg.restype = i
            lib.pt_scan_rowseg.argtypes = [i] + [p] * 16 + [i] * 16 + [p]
            lib.pt_scan_chunked.restype = i
            lib.pt_scan_chunked.argtypes = [i] + [p] * 15 + [i] * 13 + [p]
            lib.pt_scan_short.restype = i
            lib.pt_scan_short.argtypes = [i] + [p] * 11 + [i] * 10 + [p]
            lib.pt_short_plan.restype = i
            lib.pt_short_plan.argtypes = [i] * 7 + [p]
            lib.pt_block_plan.restype = i
            lib.pt_block_plan.argtypes = [i] * 9 + [p]
            lib.pt_trace_walk.restype = i
            lib.pt_trace_walk.argtypes = ([p] + [ll] * 3 + [p] * 6 +
                                          [i] * 7 + [p])
            _lib = lib
    return _lib
