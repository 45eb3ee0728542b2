"""The chunked sweep's own lanes (kernel K1f), built with g++, against the
plain version.

``csrc/score_host.cc::pt_chunked_host`` steps the lanes of the block
kernel as ``csrc/scan_chunked.cu`` launches it: one segment of all Rp
columns from column 0, with the rows a lane, warps a block and blocks a
pair the CUDA kernel's launch would have, with the plane forms' writes (``SegPlanes`` in
``csrc/score_cell.cuh``: the H and payload tables, the last row and the
last column).  So the code the card runs is held here, exactly, to
``score_align_plain`` (what ``score_chunked`` runs on the CPU) in all
seven output classes: NW, the nine semi-global free-end sets and SW at
11/1, 2/2 and 1/3, two to eight rows a lane, one to eight warps, one to
three blocks a pair, one to four groups of rows, with empty sides, ragged
stripes and the last row in any group.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402
from parasail_rs_tpu_torch.ops.wavefront import (  # noqa: E402
    PLANES,
    STATS_CLASSES,
)

from test_torch_kernel_host import build_host_lib  # noqa: E402
from test_torch_segment import (  # noqa: E402
    MODES,
    PENALTIES,
    make_case,
    same,
    tensors,
)
from test_torch_segment_host import (  # noqa: E402
    FORMS,
    lane_rows,
    plain_once,
    tie_case,
)

OUTPUTS = tk.OUTPUTS
SG_NAMES = sorted(n for n in MODES if n.startswith("sg"))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host_lib(tmp_path_factory)
    lib.pt_chunked_host.restype = ctypes.c_int
    lib.pt_chunked_host.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11 +
                                    [ctypes.c_int] * 13)
    return lib


def run_host_chunked(lib, case, *, open_, ext, mode, free, outputs, warps,
                     rows=2, cluster=1, shared=False, profile=None,
                     bandwidth=None):
    """``pt_chunked_host`` over the case, ``rows`` rows a lane (the stats
    classes: at most 4), ``warps`` warps a block and ``cluster`` blocks a
    pair; returns ``score_align``'s dict (width sat) as numpy, the tables
    as (B, Qp, Rp) like the plain version's.  With ``bandwidth``, the
    masked form (``pt_chunked_banded_host``, in a build with the banded
    twins)."""
    lane = lane_rows(outputs, rows)
    ridx, table = case["ridx"], case["table"]
    qidx = np.ascontiguousarray(case["qidx"][:1] if shared else case["qidx"])
    B, Rp = ridx.shape
    Bq, Qp = qidx.shape
    stats = outputs in STATS_CLASSES
    subs = table if profile is None else np.ascontiguousarray(profile)
    out = np.zeros((8, B), np.int32)
    trace = np.zeros((B, Qp, Rp), np.int8) if outputs == "trace" else None
    tab = (np.zeros((4, B, Rp, Qp), np.int32)
           if outputs in ("table", "stats_table") else None)
    rows = cols = None
    if outputs in ("rowcol", "stats_rowcol"):
        rows = np.zeros((4, B, Rp), np.int32)
        cols = np.zeros((4, B, Qp), np.int32)

    def ptr(a):
        return None if a is None else a.ctypes.data

    entry, band = ((lib.pt_chunked_host, ()) if bandwidth is None else
                   (lib.pt_chunked_banded_host, (bandwidth,)))
    rc = entry(
        OUTPUTS.index(outputs), ptr(subs), None if profile is not None
        else ptr(qidx), ptr(qidx) if stats else None, ptr(ridx),
        ptr(case["qlen"]), ptr(case["rlen"]), ptr(out), ptr(trace), ptr(tab),
        ptr(rows), ptr(cols), B, Bq, Bq if stats else 0, Qp, Rp,
        subs.shape[-1], open_, ext, tk.MODES[mode], tk._free_bits(free),
        *band, warps, lane, cluster)
    assert rc == 0
    res = {"score": out[0], "end_query": out[1], "end_ref": out[2],
           "saturated": out[4] != 0, "promoted": out[3] != 0}
    if stats:
        res.update(matches=out[5], similar=out[6], length=out[7])
    if trace is not None:
        res["trace_table"] = trace
    for k, name in enumerate(PLANES[:4 if stats else 1]):
        if tab is not None:
            res[f"{name}_table"] = tab[k].transpose(0, 2, 1)
        if rows is not None:
            res[f"{name}_row"], res[f"{name}_col"] = rows[k], cols[k]
    return res


def plain(case, kw, **subs_over):
    args, subs = tensors(case)
    subs.update(subs_over)
    return {k: v.numpy()
            for k, v in tk.score_chunked(*args, **kw, **subs).items()}


@pytest.mark.parametrize("rows,cluster", FORMS[:2])
@pytest.mark.parametrize("open_,ext", PENALTIES,
                         ids=[f"{a}_{b}" for a, b in PENALTIES])
@pytest.mark.parametrize("outputs", OUTPUTS)
def test_host_chunked_matches_plain(host_lib, outputs, open_, ext, rows,
                                    cluster):
    # NW, SW and, in turn over the 21 cases, each semi-global free-end
    # set; 100 query rows in groups of 32, 64 and 96 rows (one, two and
    # three warps), the last row in any group
    n = OUTPUTS.index(outputs) * len(PENALTIES) + PENALTIES.index((open_,
                                                                   ext))
    case = make_case(40 + n, 12, Qp=100, Rp=72, qlo=0, qhi=100, rlo=0,
                     rhi=72, edge=True, A=5)
    case["qlen"][5:9] = (97, 63, 64, 100)
    case["rlen"][5:9] = (72, 1, 71, 40)
    for name in ("nw", "sw", SG_NAMES[n % len(SG_NAMES)]):
        mode, free = MODES[name]
        kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs)
        want = plain_once(("chunked", outputs, open_, ext, name),
                          lambda: plain(case, dict(kw, width="sat")))
        for warps in (1, 2, 3):
            got = run_host_chunked(host_lib, case, warps=warps, rows=rows,
                                   cluster=cluster, **kw)
            same(got, want, f"{name} {outputs} warps {warps} rows {rows} "
                 f"cluster {cluster}")


@pytest.mark.parametrize("rows,cluster", FORMS)
@pytest.mark.parametrize("outputs", OUTPUTS)
@pytest.mark.parametrize("warps", [3, 8])
def test_host_chunked_several_groups(host_lib, warps, outputs, rows,
                                     cluster):
    # 300 query rows: two groups of 256 rows at eight warps (warps with no
    # rows in the second), four of 96 at three; the last row on a lane
    # that is no warp's last, in either group
    case = make_case(60 + warps, 6, Qp=300, Rp=48, qlo=0, qhi=300, rlo=0,
                     rhi=48, A=5)
    case["qlen"][:5] = (300, 257, 255, 150, 0)
    case["rlen"][:5] = (48, 31, 48, 1, 20)
    name = ("sw", "sg_qe_db")[warps % 2]
    mode, free = MODES[name]
    kw = dict(open_=(11, 2)[warps % 2], ext=(1, 2)[warps % 2], mode=mode,
              free=free, outputs=outputs)
    got = run_host_chunked(host_lib, case, warps=warps, rows=rows,
                           cluster=cluster, **kw)
    want = plain_once(("groups", warps, outputs),
                      lambda: plain(case, dict(kw, width="sat")))
    same(got, want,
         f"{name} {outputs} warps {warps} rows {rows} cluster {cluster}")


def test_host_chunked_profile_and_shared_query(host_lib):
    # (B, Qp, A) profile rows (stats: with letters), and one query against
    # every reference
    rng = np.random.default_rng(8)
    case = make_case(8, 6, Qp=70, Rp=40, qhi=70, rhi=40, A=5)
    rows = rng.integers(-4, 12, size=(6, 70, 5)).astype(np.int32)
    kw = dict(open_=5, ext=2, mode="sg", free=(True, False, False, True))
    for outputs in OUTPUTS:
        stats = outputs in STATS_CLASSES
        args, subs = tensors(case)
        want = tk.score_chunked(
            *args, **kw, outputs=outputs, width="sat",
            profile=torch.from_numpy(rows),
            **({"qidx": subs["qidx"]} if stats else {}))
        got = run_host_chunked(host_lib, case, outputs=outputs, warps=2,
                               rows=8, cluster=2, profile=rows, **kw)
        same(got, {k: v.numpy() for k, v in want.items()},
             f"profile {outputs}")
    case["qlen"][:] = case["qlen"][0]
    for outputs in ("stats_table", "rowcol"):
        got = run_host_chunked(host_lib, case, outputs=outputs, warps=1,
                               rows=4, shared=True, **kw)
        want = plain(case, dict(kw, outputs=outputs, width="sat"),
                     qidx=torch.from_numpy(case["qidx"][:1].copy()))
        same(got, want, f"shared query {outputs}")


@pytest.mark.parametrize("rows,cluster", FORMS)
def test_host_chunked_end_cell_on_two_rows_of_a_lane(host_lib, rows,
                                                    cluster):
    # the end cell on two rows of one lane at descending columns, every
    # class (test_torch_segment_host.py's tie_case)
    case, _ = tie_case()
    kw = dict(open_=5, ext=1, mode="sw", free=(True,) * 4)
    for outputs in OUTPUTS:
        got = run_host_chunked(host_lib, case, outputs=outputs, warps=1,
                               rows=rows, cluster=cluster, **kw)
        want = plain_once(("chunked_tie", outputs), lambda: plain(
            case, dict(kw, outputs=outputs, width="sat")))
        same(got, want, f"{outputs} rows {rows} cluster {cluster}")
