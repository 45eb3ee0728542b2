"""The tile kernel's own lanes, built with g++, against the plain tiles.

``csrc/score_host.cc::pt_rowseg_host`` steps the lanes of the block
kernel in its tile form (``csrc/score_cell.cuh``, "the tile form": the
segment form's ``SegLane`` / ``seg_lane_step``, the lag and the ring
between the warps of a pair's chain, with a row range and every border a
read) in a loop, with the rows a lane, warps a block and blocks a pair
the CUDA kernel's launch would have.  So the code
the card runs is held here, exactly, to ``score_rowseg_plain`` tile by
tile: outputs, right-going state, down-state rows and trace tiles, and
through them to the one-shot sweep.  Cases and helpers are
``test_torch_rowseg.py``'s.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402

from test_torch_kernel_host import build_host_lib  # noqa: E402
from test_torch_rowseg import (  # noqa: E402
    MODES,
    PROBLEM,
    one_shot,
    run_tiles,
    same_records,
    tiles_case,
)
from test_torch_segment import (  # noqa: E402
    CLASSES,
    PENALTIES,
    check_golden,
    make_case,
    same,
)
from test_torch_segment_host import (  # noqa: E402
    FORMS,
    lane_rows,
    plain_once,
)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host_lib(tmp_path_factory)
    lib.pt_rowseg_host.restype = ctypes.c_int
    lib.pt_rowseg_host.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 15 +
                                   [ctypes.c_int] * 16)
    return lib


def host_tile_fn(lib, warps, rows=2, cluster=1):
    """``pt_rowseg_host`` with :func:`score_rowseg`'s signature, on CPU
    tensors, ``rows`` rows a lane (the stats class: at most 4), ``warps``
    warps a block, ``cluster`` blocks a pair: the in-place buffers are
    copies of what it was given."""

    def fn(ridx_seg, qlen, rlen, state, down, *, open_, ext, mode, free,
           width, outputs, row_offset, q_chunk, col_offset, table=None,
           qidx=None, profile=None):
        B, C = ridx_seg.shape
        stats = outputs == "stats"
        subs = table if table is not None else profile
        Bq, Qp = (qidx.shape if table is not None else profile.shape[:2])
        new = {k: state[k].clone() for k in ("h", "f", "acc")}
        if stats:
            new["stats"] = state["stats"].clone()
        new["t"] = torch.zeros((B, 4), dtype=torch.int32)
        new_down = down.clone()
        out = torch.zeros((8, B), dtype=torch.int32)
        tile = (torch.zeros((B, q_chunk, C), dtype=torch.int8)
                if outputs == "trace" else None)

        def ptr(t):
            return None if t is None else t.data_ptr()

        rc = lib.pt_rowseg_host(
            tk.OUTPUTS.index(outputs), ptr(subs),
            ptr(qidx) if table is not None else None,
            ptr(qidx) if stats else None, ptr(ridx_seg), ptr(qlen),
            ptr(rlen), ptr(new_down), ptr(new["h"]), ptr(new["f"]),
            ptr(new.get("stats")), ptr(new["acc"]), ptr(out), ptr(tile),
            ptr(state["t"]), ptr(new["t"]), B, Bq,
            qidx.shape[0] if stats else 0, Qp, C, subs.shape[-1], open_, ext,
            tk.MODES[mode], tk._free_bits(free), col_offset, row_offset,
            q_chunk, warps, lane_rows(outputs, rows), cluster)
        assert rc == 0
        res = {"score": out[0], "end_query": out[1], "end_ref": out[2],
               "saturated": out[4] != 0, "promoted": out[3] != 0}
        if stats:
            res.update(matches=out[5], similar=out[6], length=out[7])
        return res, new, new_down, tile

    return fn


@pytest.mark.parametrize("rows,cluster", FORMS[:2])
@pytest.mark.parametrize("outputs", CLASSES)
@pytest.mark.parametrize("open_,ext", PENALTIES,
                         ids=[f"{a}_{b}" for a, b in PENALTIES])
@pytest.mark.parametrize("name", sorted(MODES))
def test_host_tiles_match_plain_tiles(host_lib, name, open_, ext, outputs,
                                      rows, cluster):
    # test_torch_rowseg.py's case: empty sides, queries ending above,
    # inside and on a tile's last row; q_chunk 24 and 36 are no multiple
    # of a warp's 32 R rows, nor 36 of a lane's 8
    mode, free = MODES[name]
    case = tiles_case(5 * open_ + ext + len(name))
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs,
              width="sat")
    k = (len(name) + open_ + CLASSES.index(outputs)) % 3
    D, qc = ((3, 24), (4, 36), (1, 8))[k]
    warps = (1, 2, 1)[k]
    got, recs = run_tiles(host_tile_fn(host_lib, warps, rows, cluster), case,
                          D, qc, kw)
    want, wrecs = plain_once(("tiles", name, open_, ext, outputs),
                             lambda: run_tiles(tk.score_rowseg_plain, case,
                                               D, qc, kw))
    what = (f"{name} {outputs} D {D} q_chunk {qc} warps {warps} rows "
            f"{rows} cluster {cluster}")
    same(got, want, what)
    same_records(recs, wrecs, what)


@pytest.mark.parametrize("rows,cluster", FORMS)
@pytest.mark.parametrize("outputs", CLASSES)
@pytest.mark.parametrize("warps", [3, 8])
def test_host_tiles_several_warps(host_lib, warps, outputs, rows, cluster):
    # tiles of 150 and 100 rows: groups of 96 and of 256 rows, warps with
    # no rows, the tile's last row on a lane that is no warp's last, the
    # ring between the warps wrapping around (shards of 200 > 128 columns)
    case = make_case(13 + warps, 12, Qp=300, Rp=200, qlo=0, qhi=300, rlo=0,
                     rhi=200, A=5)
    case["qlen"][:5] = (300, 257, 150, 151, 149)
    case["rlen"][:5] = (200, 129, 128, 200, 1)
    for name, (open_, ext) in (("sw", (11, 1)), ("nw", (1, 3))):
        mode, free = MODES[name]
        kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs,
                  width="sat")
        key = ("tile_warps", warps, outputs, name)
        want = plain_once(key, lambda: one_shot(case, kw))
        for D, qc in ((1, 150), (2, 100)):
            got, recs = run_tiles(host_tile_fn(host_lib, warps, rows,
                                               cluster), case, D, qc, kw)
            same(got, want, f"{name} {outputs} D {D} warps {warps} rows "
                 f"{rows} cluster {cluster}")
            # groups of 96 rows in a tile of 150: the scratch between the
            # groups must not reach the down-state of the pair that ends
            # on row 148; and one group of 256 rows over tiles of 100
            if (D, warps) in ((1, 3), (2, 8)):
                _, wrecs = plain_once(key + (D,), lambda: run_tiles(
                    tk.score_rowseg_plain, case, D, qc, kw))
                same_records(recs, wrecs, f"{name} {outputs}")


@pytest.mark.parametrize("name", ["nw", "sw", "sg_qb_de"])
def test_host_tiles_match_golden(host_lib, name):
    # the reference's own problem (Qp = Rp = 256, D = 8, q_chunk 64)
    mode, free = MODES[name]
    for k, (open_, ext) in enumerate(((5, 1), (2, 2))):
        pen = dict(open_=open_, ext=ext, mode=mode, free=free)
        for outputs in CLASSES:
            got, _ = run_tiles(host_tile_fn(host_lib, 2, *FORMS[k + 1]),
                               PROBLEM, 8, 64,
                               dict(pen, outputs=outputs, width="sat"))
            check_golden(PROBLEM, got, pen, outputs)


def test_host_tiles_shared_query_and_profile_rows(host_lib):
    rng = np.random.default_rng(5)
    case = make_case(5, 16, Qp=64, Rp=120, qhi=64, rhi=120)
    case["qlen"][:] = case["qlen"][0]
    kw = dict(open_=4, ext=2, mode="nw", free=(False,) * 4, outputs="stats",
              width="sat")
    got, recs = run_tiles(host_tile_fn(host_lib, 2, 4, 2), case, 3, 16, kw,
                          shared=True)
    want, wrecs = run_tiles(tk.score_rowseg_plain, case, 3, 16, kw,
                            shared=True)
    same(got, want, "shared query")
    same_records(recs, wrecs, "shared query")
    rows = rng.integers(-4, 12, size=(16, 64, 25)).astype(np.int32)
    for outputs in CLASSES:
        kw["outputs"] = outputs
        got, recs = run_tiles(host_tile_fn(host_lib, 1, 8, 2), case, 2, 32,
                              kw, profile=rows)
        want, wrecs = run_tiles(tk.score_rowseg_plain, case, 2, 32, kw,
                                profile=rows)
        same(got, want, f"profile rows {outputs}")
        same_records(recs, wrecs, f"profile rows {outputs}")
