"""The CUDA kernels' own per-pair code, built for the host, against golden.

``csrc/score_cell.cuh`` holds the recurrence, end-cell tracker,
saturation flags, trace flags, stats payloads and plane writes that every
card form is held to (``score_pair``: the literal sweep, one pair at a
time); ``csrc/walk_step.cuh`` the traceback state machine of
``csrc/trace_walk.cu``.  Built with g++ through the small harness
``csrc/score_host.cc``, the same code runs here on numpy-seeded batches
and must equal the golden oracle, the JAX walk and the port's plain
PyTorch versions exactly.  Skips where g++ is missing.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu.constants import cigar_runs_string  # noqa: E402
from parasail_rs_tpu.golden import model as golden  # noqa: E402
from parasail_rs_tpu.matrices import Matrix  # noqa: E402

from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402
from parasail_rs_tpu_torch.ops import trace_walk as tw  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "parasail_rs_tpu_torch", "csrc")
MODES = {"nw": 0, "sg": 1, "sw": 2}


def build_host_lib(tmp_path_factory, banded=False):
    """g++ build of ``csrc/score_host.cc``, its C signatures declared;
    ``banded`` adds the twins of the masked forms (``-DPT_HOST_BANDED``).
    Skips where g++ is missing."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("needs g++ to build the kernel's host harness")
    out = tmp_path_factory.mktemp("ptscore") / "libptscore_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    *(["-DPT_HOST_BANDED"] if banded else []),
                    "-I", CSRC, os.path.join(CSRC, "score_host.cc"),
                    "-o", str(out)], check=True, capture_output=True,
                   timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.pt_score_host.restype = ctypes.c_int
    lib.pt_score_host.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
    lib.pt_trace_host.restype = ctypes.c_int
    lib.pt_trace_host.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
    lib.pt_walk_host.restype = ctypes.c_int
    lib.pt_walk_host.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    lib.pt_outputs_host.restype = ctypes.c_int
    lib.pt_outputs_host.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10 +
                                    [ctypes.c_int] * 10)
    lib.pt_banded_host.restype = ctypes.c_int
    lib.pt_banded_host.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11 +
                                   [ctypes.c_int] * 11)
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory)


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


def run_host_trace(lib, *, ridx, qlen, rlen, open_, ext, mode, free, table,
                   qidx):
    """The trace form: ((5, B) scalars, (B, Qp, Rp) flags)."""
    B, Rp = ridx.shape
    Bq, Qp = qidx.shape
    out = np.zeros((5, B), np.int32)
    plane = np.zeros((B, Qp, Rp), np.int8)
    arrs = [np.ascontiguousarray(a, np.int32)
            for a in (table, qidx, ridx, qlen, rlen)]
    lib.pt_trace_host(*(a.ctypes.data for a in arrs), out.ctypes.data,
                      plane.ctypes.data, B, Bq, Qp, Rp, table.shape[0], open_,
                      ext, MODES[mode], tk._free_bits(free))
    return out, plane


def run_host_walk(lib, plane, qsym, rsym, end_q, end_r, mode, free):
    B, Qp, Rp = plane.shape
    local, qb, db = tw._walk_flags(mode, free)
    ops = np.zeros((B, Qp + Rp), np.uint8)
    beg = np.zeros((2, B), np.int32)
    arrs = [np.ascontiguousarray(plane, np.int8)] + [
        np.ascontiguousarray(a, np.int32) for a in (qsym, rsym, end_q, end_r)]
    lib.pt_walk_host(*(a.ctypes.data for a in arrs), ops.ctypes.data,
                     beg.ctypes.data, B, qsym.shape[0], Qp, Rp, int(local),
                     int(qb), int(db))
    return ops, beg


def ragged(rng, B, Qp, Rp, A, minlen):
    table = rng.integers(-5, 7, size=(A, A)).astype(np.int32)
    qlen = rng.integers(minlen, Qp + 1, size=B).astype(np.int32)
    rlen = rng.integers(minlen, Rp + 1, size=B).astype(np.int32)
    qidx = np.full((B, Qp), -1, np.int32)
    ridx = np.zeros((B, Rp), np.int32)
    for b in range(B):
        qidx[b, :qlen[b]] = rng.integers(0, A, size=qlen[b])
        ridx[b, :rlen[b]] = rng.integers(0, A, size=rlen[b])
    return dict(table=table, qidx=qidx, ridx=ridx, qlen=qlen, rlen=rlen)


@pytest.mark.parametrize("open_,ext", [(11, 1), (5, 2), (1, 3), (0, 0),
                                       (2, 2)])
@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
def test_host_trace_and_walk_match_golden_and_plain(host_lib, mode, open_,
                                                    ext):
    rng = np.random.default_rng(hash(("trace", mode, open_, ext)) % 2 ** 32)
    case = ragged(rng, 20, 24, 25, 5, 0 if mode != "sw" else 1)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    for free in (FREES if mode == "sg" else [FREES[mode == "sw"]]):
        out, plane = run_host_trace(host_lib, open_=open_, ext=ext,
                                    mode=mode, free=free, **case)
        plain = tk.score_align_plain(
            t["ridx"], t["qlen"], t["rlen"], open_=open_, ext=ext,
            mode=mode, free=free, table=t["table"], qidx=t["qidx"],
            outputs="trace")
        np.testing.assert_array_equal(plane, plain["trace_table"].numpy())
        for k, row in (("score", 0), ("end_query", 1), ("end_ref", 2)):
            np.testing.assert_array_equal(out[row], plain[k].numpy())
        ops, beg = run_host_walk(host_lib, plane, case["qidx"],
                                 case["ridx"], out[1], out[2], mode, free)
        p_ops, p_bq, p_br = tw.device_walk_plain(
            plain["trace_table"], t["qidx"], t["ridx"], plain["end_query"],
            plain["end_ref"], mode, free)
        np.testing.assert_array_equal(ops, p_ops.numpy())
        np.testing.assert_array_equal(beg, np.stack([p_bq, p_br]))
        for b in range(len(case["qlen"])):
            ql, rl = case["qlen"][b], case["rlen"][b]
            sub = case["table"][case["qidx"][b, :ql][:, None],
                                case["ridx"][b, :rl][None, :]]
            g = golden.align(sub.astype(np.int64), np.zeros_like(sub, bool),
                             open_, ext, mode, free)
            np.testing.assert_array_equal(plane[b, :ql, :rl], g.trace_table)
            assert tuple(out[:3, b]) == (g.score, g.end_query, g.end_ref)
            w = golden.walk_trace(
                g.trace_table, bytes(case["qidx"][b, :ql].astype(np.uint8)),
                bytes(case["ridx"][b, :rl].astype(np.uint8)), g.end_query,
                g.end_ref, mode, free)
            assert cigar_runs_string(tw.ops_to_runs(ops[b])) == \
                w.cigar_string(), (free, b)
            assert tuple(beg[:, b]) == (w.beg_query, w.beg_ref)


@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
def test_host_kernel_empty_side_pairs_follow_golden(host_lib, mode):
    # qlen == 0 or rlen == 0: golden's end cell on the bordered grid
    m = Matrix.default()
    qs = [b"", b"ACGT", b"ACGTACGTACGTACGTACGTACGTACGTAC", b""]
    rs = [b"ACGT", b"", b"ACGTAC", b""]
    Qp = Rp = 32
    qidx = np.full((4, Qp), -1, np.int32)
    ridx = np.zeros((4, Rp), np.int32)
    for b, (q, r) in enumerate(zip(qs, rs)):
        qidx[b, :len(q)] = m.encode(q)
        ridx[b, :len(r)] = m.encode(r)
    kw = dict(ridx=ridx, qlen=np.array([len(q) for q in qs], np.int32),
              rlen=np.array([len(r) for r in rs], np.int32), open_=5, ext=2,
              mode=mode, table=m.data.astype(np.int32), qidx=qidx)
    for free in (FREES if mode == "sg" else [FREES[mode == "sw"]]):
        score = run_host(host_lib, free=free, **kw)
        trace, _plane = run_host_trace(host_lib, free=free, **kw)
        for b, (q, r) in enumerate(zip(qs, rs)):
            if mode == "sw" and not (q and r):
                want = (0, 0, 0)    # golden's empty local alignment
            else:
                g = golden.align_seqs(q, r, m, 5, 2, mode, free)
                want = (g.score, g.end_query, g.end_ref)
            assert tuple(score[:3, b]) == want, (free, b)
            assert tuple(trace[:3, b]) == want, (free, b)


def run_outputs_host(lib, outputs, *, ridx, qlen, rlen, open_, ext, mode,
                     free, qidx, table=None, profile=None, width="sat",
                     bandwidth=None):
    """The stats, table and rowcol forms: ``score_align``'s dict, numpy.
    With ``bandwidth``, the banded form of any class (``pt_banded_host``)."""
    B, Rp = ridx.shape
    Bm, Qp = qidx.shape
    subs = np.ascontiguousarray(table if table is not None else profile,
                                np.int32)
    Bq = Bm if table is not None else subs.shape[0]
    out = np.zeros((8, B), np.int32)
    planes = np.zeros((4, B, Qp, Rp), np.int32)
    row = np.zeros((4, B, Rp), np.int32)
    col = np.zeros((4, B, Qp), np.int32)
    q, r, ql, rl = (np.ascontiguousarray(a, np.int32)
                    for a in (qidx, ridx, qlen, rlen))
    head = (tk.OUTPUTS.index(outputs), subs.ctypes.data,
            q.ctypes.data if table is not None else None, q.ctypes.data,
            r.ctypes.data, ql.ctypes.data, rl.ctypes.data, out.ctypes.data)
    tail = (planes.ctypes.data, row.ctypes.data, col.ctypes.data, B, Bq, Bm,
            Qp, Rp, subs.shape[-1], open_, ext, MODES[mode],
            tk._free_bits(free))
    if bandwidth is None:
        rc = lib.pt_outputs_host(*head, *tail)
    else:
        plane = np.zeros((B, Qp, Rp), np.int8)
        rc = lib.pt_banded_host(*head, plane.ctypes.data, *tail, bandwidth)
    assert rc == 0
    res = {k: v.numpy() for k, v in tk.flag_outputs(*map(torch.from_numpy, (
        out[0], out[1], out[2], out[3] != 0, out[4] != 0)), width).items()}
    stats = outputs in ("stats", "stats_table", "stats_rowcol")
    if stats:
        res.update(matches=out[5], similar=out[6], length=out[7])
    if outputs == "trace":
        res["trace_table"] = plane
    for k, name in enumerate(("score", "matches", "similar",
                              "length")[:4 if stats else 1]):
        if outputs.endswith("table"):
            res[f"{name}_table"] = planes[k]
        elif outputs.endswith("rowcol"):
            res[f"{name}_row"], res[f"{name}_col"] = row[k], col[k]
    return res


PLANE_CLASSES = ("stats", "table", "stats_table", "rowcol", "stats_rowcol")


def golden_outputs(case, b, open_, ext, mode, free):
    """golden.align of pair b, letters compared for `matches`."""
    ql, rl = case["qlen"][b], case["rlen"][b]
    qi, ri = case["qidx"][b, :ql], case["ridx"][b, :rl]
    sub = case["table"][qi[:, None], ri[None, :]]
    return golden.align(sub.astype(np.int64), qi[:, None] == ri[None, :],
                        open_, ext, mode, free)


@pytest.mark.parametrize("open_,ext", [(11, 1), (5, 2), (1, 3), (0, 0),
                                       (2, 2)])
@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
def test_host_stats_and_planes_match_golden_and_plain(host_lib, mode, open_,
                                                      ext):
    """Every stats / table / rowcol form of the header, built with g++,
    equals the plain version (the wavefront) exactly, planes included,
    and golden on every in-sequence value, at every penalty pair."""
    rng = np.random.default_rng(
        [ord(c) for c in mode] + [open_, ext, 3])
    case = ragged(rng, 16, 20, 21, 5, 0 if mode != "sw" else 1)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    for free in (FREES if mode == "sg" else [FREES[mode == "sw"]]):
        golds = [None if not (case["qlen"][b] and case["rlen"][b]) else
                 golden_outputs(case, b, open_, ext, mode, free)
                 for b in range(len(case["qlen"]))]
        for outputs in PLANE_CLASSES:
            got = run_outputs_host(host_lib, outputs, open_=open_, ext=ext,
                                   mode=mode, free=free, **case)
            plain = tk.score_align(
                t["ridx"], t["qlen"], t["rlen"], open_=open_, ext=ext,
                mode=mode, free=free, width="sat", table=t["table"],
                qidx=t["qidx"], outputs=outputs)
            assert set(got) == set(plain), outputs
            for k, v in plain.items():
                np.testing.assert_array_equal(
                    got[k], v.numpy(), err_msg=f"{outputs}/{free}/{k}")
            for b, g in enumerate(golds):
                if g is None:
                    continue
                ql, rl = case["qlen"][b], case["rlen"][b]
                for k, v in got.items():
                    if k.endswith("_table"):
                        want, have = getattr(g, k), v[b, :ql, :rl]
                    elif k.endswith(("_row", "_col")):
                        want = getattr(g, k)
                        have = v[b, :rl] if k.endswith("_row") else v[b, :ql]
                    elif k in ("saturated", "promoted"):
                        continue
                    else:
                        want, have = getattr(g, k), v[b]
                    np.testing.assert_array_equal(
                        have, want, err_msg=f"{outputs}/{free}/{k}/{b}")


def test_host_stats_empty_side_pairs_follow_golden(host_lib):
    m = Matrix.default()
    qs = [b"", b"ACGT", b"ACGTACGTACGTACGTACGTACGTACGTAC", b""]
    rs = [b"ACGT", b"", b"ACGTAC", b""]
    P = 32
    qidx = np.full((4, P), -1, np.int32)
    ridx = np.zeros((4, P), np.int32)
    for b, (q, r) in enumerate(zip(qs, rs)):
        qidx[b, :len(q)] = m.encode(q)
        ridx[b, :len(r)] = m.encode(r)
    kw = dict(ridx=ridx, qlen=np.array([len(q) for q in qs], np.int32),
              rlen=np.array([len(r) for r in rs], np.int32), open_=5, ext=2,
              table=m.data.astype(np.int32), qidx=qidx)
    keys = ("score", "end_query", "end_ref", "matches", "similar", "length")
    for mode in ("nw", "sg", "sw"):
        for free in (FREES if mode == "sg" else [FREES[mode == "sw"]]):
            got = run_outputs_host(host_lib, "stats_rowcol", mode=mode,
                                   free=free, **kw)
            for b, (q, r) in enumerate(zip(qs, rs)):
                if mode == "sw" and not (q and r):
                    want = (0,) * 6         # golden's empty local alignment
                else:
                    g = golden.align_seqs(q, r, m, 5, 2, mode, free)
                    want = tuple(getattr(g, k) for k in keys)
                assert tuple(int(got[k][b]) for k in keys) == want, \
                    (mode, free, b)
                if not (q and r):
                    assert not got["score_row"][b].any()
                    assert not got["length_col"][b].any()
