"""The CUDA kernel's own per-pair code, built for the host, against golden.

``csrc/score_cell.cuh`` holds the recurrence, end-cell tracker and
saturation flags that ``csrc/scan_score.cu`` runs on the card.  Built
with g++ through the small harness ``csrc/score_host.cc``, the same code
runs here on numpy-seeded batches and must equal the golden oracle and
the port's plain PyTorch version exactly.  Skips where g++ is missing.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu.golden import model as golden  # noqa: E402

from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "parasail_rs_tpu_torch", "csrc")
MODES = {"nw": 0, "sg": 1, "sw": 2}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("needs g++ to build the kernel's host harness")
    out = tmp_path_factory.mktemp("ptscore") / "libptscore_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, os.path.join(CSRC, "score_host.cc"),
                    "-o", str(out)], check=True, capture_output=True,
                   timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.pt_score_host.restype = ctypes.c_int
    lib.pt_score_host.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
    return lib


def run_host(lib, *, ridx, qlen, rlen, open_, ext, mode, free, table=None,
             qidx=None, profile=None):
    B, Rp = ridx.shape
    subs = np.ascontiguousarray(table if table is not None else profile,
                                np.int32)
    q = None if table is None else np.ascontiguousarray(qidx, np.int32)
    Bq, Qp = (q.shape if q is not None else profile.shape[:2])
    A = subs.shape[-1]
    out = np.zeros((5, B), np.int32)
    ridx = np.ascontiguousarray(ridx, np.int32)
    qlen = np.ascontiguousarray(qlen, np.int32)
    rlen = np.ascontiguousarray(rlen, np.int32)
    lib.pt_score_host(subs.ctypes.data, None if q is None else q.ctypes.data,
                      ridx.ctypes.data, qlen.ctypes.data, rlen.ctypes.data,
                      out.ctypes.data, B, Bq, Qp, Rp, A, open_, ext,
                      MODES[mode], tk._free_bits(free))
    return out


FREES = [(False,) * 4, (True,) * 4, (True, False, False, True),
         (False, True, True, False), (True, True, False, False),
         (False, False, True, True)]


@pytest.mark.parametrize("open_,ext", [(11, 1), (5, 2), (1, 3), (0, 0)])
@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
def test_host_kernel_matches_golden_and_plain(host_lib, mode, open_, ext):
    rng = np.random.default_rng(hash((mode, open_, ext)) % 2 ** 32)
    B, Qp, Rp, A = 24, 30, 31, 6
    table = rng.integers(-5, 7, size=(A, A)).astype(np.int32)
    qlen = rng.integers(1, Qp + 1, size=B).astype(np.int32)
    rlen = rng.integers(1, Rp + 1, size=B).astype(np.int32)
    qidx = np.full((B, Qp), -1, np.int32)
    ridx = np.zeros((B, Rp), np.int32)
    for b in range(B):
        qidx[b, :qlen[b]] = rng.integers(0, A, size=qlen[b])
        ridx[b, :rlen[b]] = rng.integers(0, A, size=rlen[b])
    for free in (FREES if mode == "sg" else [FREES[mode == "sw"]]):
        out = run_host(host_lib, ridx=ridx, qlen=qlen, rlen=rlen,
                       open_=open_, ext=ext, mode=mode, free=free,
                       table=table, qidx=qidx)
        for b in range(B):
            ql, rl = qlen[b], rlen[b]
            sub = table[qidx[b, :ql][:, None], ridx[b, :rl][None, :]]
            g = golden.align(sub.astype(np.int64), np.zeros_like(sub, bool),
                             open_, ext, mode, free)
            assert tuple(out[:3, b]) == (g.score, g.end_query, g.end_ref), \
                (mode, free, b)
        plain = tk.score_align_plain(
            torch.from_numpy(ridx), torch.from_numpy(qlen),
            torch.from_numpy(rlen), open_=open_, ext=ext, mode=mode,
            free=free, width="sat", table=torch.from_numpy(table),
            qidx=torch.from_numpy(qidx))
        np.testing.assert_array_equal(out[0], plain["score"].numpy())
        np.testing.assert_array_equal(out[1], plain["end_query"].numpy())
        np.testing.assert_array_equal(out[2], plain["end_ref"].numpy())
        np.testing.assert_array_equal(out[3] != 0, plain["promoted"].numpy())
        np.testing.assert_array_equal(out[4] != 0,
                                      plain["saturated"].numpy())


def test_host_kernel_profile_form_and_saturation(host_lib):
    rng = np.random.default_rng(7)
    B, Qp, Rp, A = 16, 28, 28, 5
    profile = rng.integers(-300, 2600, size=(B, Qp, A)).astype(np.int32)
    qlen = rng.integers(1, Qp + 1, size=B).astype(np.int32)
    rlen = rng.integers(1, Rp + 1, size=B).astype(np.int32)
    ridx = rng.integers(0, A, size=(B, Rp)).astype(np.int32)
    out = run_host(host_lib, ridx=ridx, qlen=qlen, rlen=rlen, open_=11,
                   ext=1, mode="sw", free=(True,) * 4, profile=profile)
    plain = tk.score_align_plain(
        torch.from_numpy(ridx), torch.from_numpy(qlen),
        torch.from_numpy(rlen), open_=11, ext=1, mode="sw",
        free=(True,) * 4, width="sat", profile=torch.from_numpy(profile))
    np.testing.assert_array_equal(out[0], plain["score"].numpy())
    np.testing.assert_array_equal(out[3] != 0, plain["promoted"].numpy())
    np.testing.assert_array_equal(out[4] != 0, plain["saturated"].numpy())
    assert (out[4] != 0).any() and not (out[4] != 0).all()
