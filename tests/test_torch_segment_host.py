"""The segment kernel's own lanes, built with g++, against the plain
version, the one-shot sweep, golden and the JAX segment kernel.

``csrc/score_cell.cuh``'s segment form (``SegLane``, ``seg_lane_step``,
the lag and the ring between the warps of a pair's chain) in a loop,
with the rows a lane, warps a block and blocks a pair (a cluster) the
CUDA kernel's launch would have, so the code the card runs is held
here, exactly, to ``score_segment_plain`` (outputs and state rows),
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
                                    [ctypes.c_int] * 15)
    lib.pt_block_plan_host.restype = ctypes.c_int
    lib.pt_block_plan_host.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return lib


# (rows a lane, blocks a pair) of the kernel's forms; only the score and
# rowcol forms have 8 rows a lane, the others stop at 4
FORMS = [(2, 1), (4, 2), (8, 3)]


def lane_rows(outputs, rows):
    return rows if outputs in ("score", "rowcol") else min(rows, 4)


# The plain versions' results, kept across the cases that differ only in
# the twin's form (they run one after another): the plain sweep costs
# about a second a case, the g++ twin a hundredth.
_PLAIN = {}


def plain_once(key, fn):
    """fn()'s result, computed once for ``key``; holds the last 8 keys."""
    if key not in _PLAIN:
        if len(_PLAIN) >= 8:
            _PLAIN.pop(next(iter(_PLAIN)))
        _PLAIN[key] = fn()
    return _PLAIN[key]


def run_host_segments(lib, case, seg, *, open_, ext, mode, free, outputs,
                      shared=False, warps=1, rows=2, cluster=1):
    """``pt_segment_host`` chained over the case, the state in place, with
    ``rows`` rows a lane, ``warps`` warps a block and ``cluster`` blocks
    a pair, as the kernel's launch would have."""
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
            tk.MODES[mode], tk._free_bits(free), si * seg, int(si > 0), warps,
            lane_rows(outputs, rows), cluster)
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


@pytest.mark.parametrize("rows,cluster", FORMS[:2])
@pytest.mark.parametrize("outputs", CLASSES)
@pytest.mark.parametrize("open_,ext", PENALTIES,
                         ids=[f"{a}_{b}" for a, b in PENALTIES])
@pytest.mark.parametrize("name", sorted(MODES))
def test_host_lanes_match_plain_and_one_shot(host_lib, name, open_, ext,
                                             outputs, rows, cluster):
    mode, free = MODES[name]
    case = make_case(11 * open_ + ext + len(name), 24, Qp=70, Rp=200, qhi=70,
                     rhi=200, qlo=0, rlo=0, edge=True, A=5)
    case["qlen"][2] = 70
    case["rlen"][2] = 200
    args, subs = tensors(case)
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs)
    full = {**kw, **subs, "width": "sat"}
    key = ("lanes", name, open_, ext, outputs)
    want = plain_once(key, lambda: {
        k: v.numpy() for k, v in tk.score_align_plain(*args, **full).items()})
    # groups of 32 R C and of 64 R C rows; 70 rows are no multiple of
    # a lane's rows or a warp's
    for seg, warps in ((48, 1), (128, 2)):
        got, gst = run_host_segments(host_lib, case, seg, warps=warps,
                                     rows=rows, cluster=cluster, **kw)
        same(got, want, f"{name} {outputs} seg {seg} rows {rows} "
             f"cluster {cluster}")
        if seg != 128:
            continue
        plain, pst = plain_once(key + (seg,), lambda: chain(
            tk.score_segment_plain, args, seg, full))
        same(got, plain, f"{name} {outputs} seg {seg} against plain")
        # the state rows of each pair's own query rows
        own = ((np.arange(70)[None, :] < case["qlen"][:, None]) &
               (case["rlen"] > 0)[:, None])
        for k in ("h", "f") + (("stats",) if outputs == "stats" else ()):
            np.testing.assert_array_equal(
                gst[k] * own, pst[k].numpy() * own, err_msg=f"state {k}")


@pytest.mark.parametrize("rows,cluster", FORMS)
@pytest.mark.parametrize("outputs", CLASSES)
@pytest.mark.parametrize("warps", [3, 8])
def test_host_lanes_several_warps(host_lib, warps, outputs, rows, cluster):
    # 300 query rows: groups of 96 R C and 256 R C rows, warps with no
    # rows, the ring between the warps wrapping around (segments of 200 >
    # 128)
    case = make_case(13 + warps, 12, Qp=300, Rp=200, qlo=0, qhi=300, rlo=0,
                     rhi=200, A=5)
    case["qlen"][:5] = (300, 257, 256, 97, 96)
    case["rlen"][:5] = (200, 129, 128, 200, 1)
    args, subs = tensors(case)
    for name, (open_, ext) in (("sw", (11, 1)), ("sg", (2, 2)),
                               ("nw", (1, 3))):
        mode, free = MODES[name]
        kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs)
        want = plain_once(("warps", warps, outputs, name), lambda: {
            k: v.numpy() for k, v in tk.score_align_plain(
                *args, **kw, **subs, width="sat").items()})
        for seg in (200, 70):
            got, _ = run_host_segments(host_lib, case, seg, warps=warps,
                                       rows=rows, cluster=cluster, **kw)
            same(got, want, f"{name} {outputs} seg {seg} warps {warps} "
                 f"rows {rows} cluster {cluster}")


@pytest.mark.parametrize("name", ["nw", "sw", "sg"])
def test_host_lanes_match_golden(host_lib, name):
    mode, free = MODES[name]
    case = make_case(77 + len(name), 6, Qp=70, Rp=160, qhi=70, rhi=160, A=5)
    for k, (open_, ext) in enumerate(PENALTIES):
        kw = dict(open_=open_, ext=ext, mode=mode, free=free)
        rows, cluster = FORMS[k]
        for outputs in CLASSES:
            got, _ = run_host_segments(host_lib, case, 64, outputs=outputs,
                                       rows=rows, cluster=cluster, **kw)
            check_golden(case, got, kw, outputs)


def tie_case(B=8, Qp=40, Rp=50):
    """Pairs whose best H (1) sits on two rows of one lane at descending
    columns: q[i], q[i + 1] = 0, 1 against r[j], r[j + 1] = 1, 0 gives H 1
    at (i, j + 1) and at (i + 1, j), 0 elsewhere (letters 2 and 3 of the
    rest never match).  A lane computes (i + 1, j) first; the end cell is
    (i, j + 1), the first in row-major order."""
    table = np.full((4, 4), -3, np.int32)
    np.fill_diagonal(table, 1)
    qidx = np.full((B, Qp), 2, np.int32)
    ridx = np.full((B, Rp), 3, np.int32)
    spots = [(0, 5), (2, 0), (4, 47), (6, 20), (12, 30), (18, 1), (36, 9),
             (37, 40)]
    for b, (i, j) in enumerate(spots[:B]):
        qidx[b, i:i + 2] = (0, 1)
        ridx[b, j:j + 2] = (1, 0)
    return dict(table=table, qidx=qidx, ridx=ridx,
                qlen=np.full(B, Qp, np.int32),
                rlen=np.full(B, Rp, np.int32)), spots[:B]


@pytest.mark.parametrize("rows,cluster", FORMS)
def test_host_lanes_end_cell_on_two_rows_of_a_lane(host_lib, rows, cluster):
    case, spots = tie_case()
    args, subs = tensors(case)
    for outputs in CLASSES:
        kw = dict(open_=5, ext=1, mode="sw", free=(True,) * 4,
                  outputs=outputs)
        want = plain_once(("tie", outputs), lambda: {
            k: v.numpy() for k, v in tk.score_align_plain(
                *args, **kw, **subs, width="sat").items()})
        np.testing.assert_array_equal(want["end_query"],
                                      [i for i, _ in spots])
        np.testing.assert_array_equal(want["end_ref"],
                                      [j + 1 for _, j in spots])
        for seg, warps in ((50, 1), (16, 2)):
            got, _ = run_host_segments(host_lib, case, seg, warps=warps,
                                       rows=rows, cluster=cluster, **kw)
            same(got, want, f"{outputs} seg {seg} rows {rows} cluster "
                 f"{cluster}")


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
    got, _ = run_host_segments(host_lib, case, 64, shared=True, rows=4,
                               cluster=2, **kw)
    same(got, {k: v.numpy() for k, v in want.items()}, "shared query")


def block_plan(lib, outputs, B, Qs, ncols, A=16, profile=False, warps=0,
               rows=0, cluster=0):
    plan = np.zeros(3, np.int32)
    assert lib.pt_block_plan_host(tk.OUTPUTS.index(outputs), B, Qs, ncols, A,
                                  int(profile), warps, rows, cluster,
                                  plan.ctypes.data) == 0
    return tuple(int(x) for x in plan)


@pytest.mark.parametrize("outputs,B,Qs,ncols,several_rows,cluster", [
    ("score", 128, 16384, 8192, True, False),     # cfg6's segments (K2)
    ("score", 128, 2048, 4096, True, False),      # cfg6's tiles (K3)
    ("stats", 128, 1024, 1024, True, False),      # the 4,096 bp tiles
    ("trace", 128, 4096, 4096, True, False),      # the long mixed batch
    ("trace", 16, 4096, 4096, True, True),        # align_cigars' bins (K1f)
    ("stats_table", 16, 4096, 4096, True, True),
    ("score", 8192, 160, 160, True, False),       # bench.py's headline
], ids=["cfg6", "tile", "stats_tile", "mixed", "bin16", "table_bin16",
        "headline"])
def test_host_plan_of_the_main_paths(host_lib, outputs, B, Qs, ncols,
                                     several_rows, cluster):
    # the launcher's rule (csrc/score_cell.cuh, seg_plan) on the main
    # paths' launches: several rows a lane everywhere, a cluster where a
    # launch holds too few pairs to fill the card
    rows, warps, blocks = block_plan(host_lib, outputs, B, Qs, ncols,
                                     profile=B == 8192)
    assert (rows > 1) == several_rows and 1 <= warps <= 8
    assert (blocks > 1) == cluster and 1 <= blocks <= 8
    assert rows in ((2, 4, 8) if outputs in ("score", "rowcol") else (2, 4))


def test_host_plan_gives_the_table_classes_four_rows(host_lib):
    # their H plane is a 16-byte store a lane at 4 rows: 4 rows and the
    # warps that cover the rows, rather than 2 rows on eight warps; 2
    # rows where a warp's 128 rows do not fill
    for outputs in ("table", "stats_table"):
        assert block_plan(host_lib, outputs, 128, 512, 512) == (4, 4, 1)
        assert block_plan(host_lib, outputs, 128, 1024, 1024) == (4, 8, 1)
        assert block_plan(host_lib, outputs, 128, 100, 64)[0] == 2
    assert block_plan(host_lib, "stats_rowcol", 128, 512, 512) == (2, 8, 1)


def test_host_plan_keeps_what_is_given(host_lib):
    assert block_plan(host_lib, "score", 64, 100, 80, warps=3, rows=8,
                      cluster=2) == (8, 3, 2)
    # only score and rowcol have forms of 8 rows a lane: the rule picks 2
    # or 4 for the others
    for outputs in ("stats", "trace", "table"):
        assert block_plan(host_lib, outputs, 128, 16384, 80)[0] == 4
    # warps beyond eight are eight
    assert block_plan(host_lib, "trace", 64, 100, 80, warps=12)[1] == 8
