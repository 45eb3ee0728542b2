"""The segment kernel's own lanes, built with g++, against the plain
version, the one-shot sweep, golden and the JAX segment kernel.

``csrc/score_host.cc::pt_segment_host`` steps the lanes of
``csrc/score_cell.cuh``'s segment form (``SegLane``, ``seg_cell``, the
lag and the ring between a block's warps) in a loop, as many warps on a
pair as the CUDA kernel's block would have, so the code the card runs is
held here, exactly, to ``score_segment_plain`` (outputs and state rows),
the one-shot ``score_align_plain``, golden and the JAX
``scan_score_segment`` in interpret mode.  Cases and helpers are
``test_torch_segment.py``'s.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402

from test_torch_kernel_host import build_host_lib  # noqa: E402
from test_torch_segment import (  # noqa: E402
    CLASSES,
    MODES,
    PENALTIES,
    chain,
    check_golden,
    make_case,
    run_jax_segments,
    same,
    tensors,
)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host_lib(tmp_path_factory)
    lib.pt_segment_host.restype = ctypes.c_int
    lib.pt_segment_host.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 12 +
                                    [ctypes.c_int] * 13)
    return lib


def run_host_segments(lib, case, seg, *, open_, ext, mode, free, outputs,
                      shared=False, warps=1):
    """``pt_segment_host`` chained over the case, the state in place, with
    ``warps`` warps on a pair as the kernel's block would have."""
    ridx, table = case["ridx"], case["table"]
    qidx = np.ascontiguousarray(case["qidx"][:1] if shared else case["qidx"])
    B, Rp = ridx.shape
    Bq, Qp = qidx.shape
    nseg = -(-Rp // seg)
    padded = np.zeros((B, nseg * seg), np.int32)
    padded[:, :Rp] = ridx
    stats = outputs == "stats"
    st_h, st_f = (np.zeros((B, Qp), np.int32) for _ in range(2))
    st_pay = np.zeros((6, B, Qp), np.int32)
    acc = np.zeros((B, 8), np.int32)
    out = np.zeros((8, B), np.int32)
    planes = []

    def ptr(a):
        return None if a is None else a.ctypes.data

    for si in range(nseg):
        cols = np.ascontiguousarray(padded[:, si * seg:(si + 1) * seg])
        plane = np.zeros((B, Qp, seg), np.int8) if outputs == "trace" else None
        rc = lib.pt_segment_host(
            tk.OUTPUTS.index(outputs), ptr(table), ptr(qidx),
            ptr(qidx) if stats else None, ptr(cols), ptr(case["qlen"]),
            ptr(case["rlen"]), ptr(st_h), ptr(st_f),
            ptr(st_pay) if stats else None, ptr(acc), ptr(out), ptr(plane),
            B, Bq, Bq if stats else 0, Qp, seg, table.shape[0], open_, ext,
            tk.MODES[mode], tk._free_bits(free), si * seg, int(si > 0), warps)
        assert rc == 0
        if plane is not None:
            planes.append(plane)
    res = {"score": out[0], "end_query": out[1], "end_ref": out[2],
           "saturated": out[4] != 0, "promoted": out[3] != 0}
    if stats:
        res.update(matches=out[5], similar=out[6], length=out[7])
    if planes:
        res["trace_table"] = np.concatenate(planes, axis=2)[:, :, :Rp]
    return res, {"h": st_h, "f": st_f, "stats": st_pay, "acc": acc}


@pytest.mark.parametrize("outputs", CLASSES)
@pytest.mark.parametrize("open_,ext", PENALTIES,
                         ids=[f"{a}_{b}" for a, b in PENALTIES])
@pytest.mark.parametrize("name", sorted(MODES))
def test_host_lanes_match_plain_and_one_shot(host_lib, name, open_, ext,
                                             outputs):
    mode, free = MODES[name]
    case = make_case(11 * open_ + ext + len(name), 24, Qp=70, Rp=200, qhi=70,
                     rhi=200, qlo=0, rlo=0, edge=True, A=5)
    case["qlen"][2] = 70
    case["rlen"][2] = 200
    args, subs = tensors(case)
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs)
    full = {**kw, **subs, "width": "sat"}
    want = {k: v.numpy()
            for k, v in tk.score_align_plain(*args, **full).items()}
    for seg, warps in ((48, 1), (128, 2)):   # groups of 32 and of 64 rows
        got, gst = run_host_segments(host_lib, case, seg, warps=warps, **kw)
        same(got, want, f"{name} {outputs} seg {seg}")
        if seg != 128:
            continue
        plain, pst = chain(tk.score_segment_plain, args, seg, full)
        same(got, plain, f"{name} {outputs} seg {seg} against plain")
        # the state rows of each pair's own query rows
        rows = ((np.arange(70)[None, :] < case["qlen"][:, None]) &
                (case["rlen"] > 0)[:, None])
        for k in ("h", "f") + (("stats",) if outputs == "stats" else ()):
            np.testing.assert_array_equal(
                gst[k] * rows, pst[k].numpy() * rows, err_msg=f"state {k}")


@pytest.mark.parametrize("outputs", CLASSES)
@pytest.mark.parametrize("warps", [3, 8])
def test_host_lanes_several_warps(host_lib, warps, outputs):
    # 300 query rows: groups of 96 and of 256 rows, warps with no rows,
    # the ring between the warps wrapping around (segments of 200 > 128)
    case = make_case(13 + warps, 12, Qp=300, Rp=200, qlo=0, qhi=300, rlo=0,
                     rhi=200, A=5)
    case["qlen"][:5] = (300, 257, 256, 97, 96)
    case["rlen"][:5] = (200, 129, 128, 200, 1)
    args, subs = tensors(case)
    for name, (open_, ext) in (("sw", (11, 1)), ("sg", (2, 2)),
                               ("nw", (1, 3))):
        mode, free = MODES[name]
        kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs)
        want = {k: v.numpy() for k, v in tk.score_align_plain(
            *args, **kw, **subs, width="sat").items()}
        for seg in (200, 70):
            got, _ = run_host_segments(host_lib, case, seg, warps=warps, **kw)
            same(got, want, f"{name} {outputs} seg {seg} warps {warps}")


@pytest.mark.parametrize("name", ["nw", "sw", "sg"])
def test_host_lanes_match_golden(host_lib, name):
    mode, free = MODES[name]
    case = make_case(77 + len(name), 6, Qp=70, Rp=160, qhi=70, rhi=160, A=5)
    for open_, ext in PENALTIES:
        kw = dict(open_=open_, ext=ext, mode=mode, free=free)
        for outputs in CLASSES:
            got, _ = run_host_segments(host_lib, case, 64, outputs=outputs,
                                       **kw)
            check_golden(case, got, kw, outputs)


def test_host_lanes_match_jax_segments(host_lib):
    case = make_case(58, 128)
    for name, outputs, open_, ext in (("sw", "stats", 11, 1),
                                      ("sg_qe_db", "trace", 1, 3)):
        mode, free = MODES[name]
        kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs)
        got, _ = run_host_segments(host_lib, case, 64, **kw)
        same(got, run_jax_segments(case, 64, **kw), f"{name} {outputs}")


def test_host_lanes_shared_query(host_lib):
    case = make_case(5, 16, Qp=40, Rp=130, qhi=40, rhi=130)
    case["qlen"][:] = case["qlen"][0]
    args, subs = tensors(case)
    kw = dict(open_=4, ext=2, mode="nw", free=(False,) * 4, outputs="stats")
    want = tk.score_align_plain(*args, **kw, width="sat", table=subs["table"],
                                qidx=subs["qidx"][:1])
    got, _ = run_host_segments(host_lib, case, 64, shared=True, **kw)
    same(got, {k: v.numpy() for k, v in want.items()}, "shared query")
