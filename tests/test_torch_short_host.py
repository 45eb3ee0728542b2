"""The short form's own lanes (kernels K1b and K1c, one warp a pair), built
with g++, against the plain version, golden and the JAX kernel.

``csrc/score_cell.cuh``'s short form (``ShortLane``, ``short_lane_step``,
the stats payloads packed by ``PackOps`` / ``Pack2Ops``) stepped lane by
lane in a loop (``short_pair_host`` through ``csrc/score_host.cc``'s
``pt_short_host``), at the rows a lane and payload layout that the CUDA
kernel's launcher takes (``pt_short_plan_host``, its rule) and at the
other form, so that the code the card runs is held here, exactly, to
``score_align_plain`` (the scalars, every flag cell and stats payload, the
walk of the plane), golden, and the JAX ``scan_score_align`` in interpret
mode.  The CUDA kernel itself is held to the plain version by the tests
marked ``cuda`` in ``test_torch_trace_kernel.py`` and
``test_torch_stats_kernel.py`` and by ``chip_smoke.py``.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu.constants import cigar_runs_string  # noqa: E402
from parasail_rs_tpu.golden import model as golden  # noqa: E402

from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402
from parasail_rs_tpu_torch.ops import trace_walk as tw  # noqa: E402
from parasail_rs_tpu_torch.ops.wavefront import (  # noqa: E402
    PLANES,
    STATS_CLASSES,
)

from test_torch_kernel_host import build_host_lib, run_host_walk  # noqa: E402
from test_torch_segment_host import tie_case  # noqa: E402
from test_torch_stats_kernel import (  # noqa: E402
    assert_matches_golden,
    golden_pair,
    make_case,
    run_jax,
)
from test_torch_trace_kernel import (  # noqa: E402
    EMPTY_QS,
    EMPTY_RS,
    empty_case,
    golden_empty,
    run_jax_trace,
)

NW, SW = (False,) * 4, (True,) * 4
# NW, three SG free-end sets and SW
MODES = {"nw": ("nw", NW), "sg_qb_de": ("sg", (True, False, False, True)),
         "sg_qe_db": ("sg", (False, True, True, False)),
         "sg_all": ("sg", SW), "sw": ("sw", SW)}
# open > ext, open == ext, open < ext
PENALTIES = [(11, 1), (2, 2), (1, 3)]
CLASSES = ("trace", "stats")


def build_short_lib(tmp_path_factory):
    """The g++ build with the short form's entry points declared."""
    lib = build_host_lib(tmp_path_factory)
    lib.pt_short_host.restype = ctypes.c_int
    lib.pt_short_host.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11 +
                                  [ctypes.c_int] * 12)
    lib.pt_short_plan_host.restype = ctypes.c_int
    lib.pt_short_plan_host.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_short_lib(tmp_path_factory)


def short_plan(lib, outputs, B, Bq, Qp, Rp, A, profile=False):
    """(rows a lane, pairs a block, stats layout) of the launcher's rule."""
    plan = np.zeros(3, np.int32)
    assert lib.pt_short_plan_host(tk.OUTPUTS.index(outputs), B, Bq, Qp, Rp,
                                  A, int(profile), plan.ctypes.data) == 0
    return tuple(int(x) for x in plan)


def _sides(case):
    """(substitution array, Bq, A, profile?) of a case."""
    profile = "profile" in case
    subs = np.ascontiguousarray(case["profile" if profile else "table"],
                                np.int32)
    Bq = subs.shape[0] if profile else case["qidx"].shape[0]
    return subs, Bq, subs.shape[-1], profile


def run_short(lib, case, outputs, *, open_, ext, mode, free, width="32",
              rows=None, layout=None, bandwidth=None):
    """``pt_short_host`` on a numpy case: score_align's dict (numpy), the
    trace plane as the kernel leaves it, the (B, Rp, Qp) tables as
    (B, Qp, Rp) views.  ``rows`` and ``layout`` default to the launcher's
    rule.  With ``bandwidth``, the masked form (``pt_short_banded_host``,
    in a build with the banded twins)."""
    subs, Bq, A, profile = _sides(case)
    qidx, ridx = (np.ascontiguousarray(case[k], np.int32)
                  for k in ("qidx", "ridx"))
    qlen, rlen = (np.ascontiguousarray(case[k], np.int32)
                  for k in ("qlen", "rlen"))
    B, Rp = ridx.shape
    Qp = qidx.shape[1]
    rule = short_plan(lib, outputs, B, Bq, Qp, Rp, A, profile)
    rows = rows or rule[0]
    layout = rule[2] if layout is None else layout
    stats = outputs in STATS_CLASSES
    n = 4 if stats else 1
    out = np.zeros((8, B), np.int32)
    plane = np.zeros((B, Qp, Rp), np.int8) if outputs == "trace" else None
    tab = (np.zeros((n, B, Rp, Qp), np.int32)
           if outputs in ("table", "stats_table") else None)
    row, col = ((np.zeros((n, B, Rp), np.int32), np.zeros((n, B, Qp),
                                                          np.int32))
                if outputs in ("rowcol", "stats_rowcol") else (None, None))

    def ptr(a):
        return None if a is None else a.ctypes.data

    entry, band = ((lib.pt_short_host, ()) if bandwidth is None else
                   (lib.pt_short_banded_host, (bandwidth,)))
    rc = entry(
        tk.OUTPUTS.index(outputs), subs.ctypes.data,
        None if profile else qidx.ctypes.data,
        qidx.ctypes.data if stats else None, ridx.ctypes.data,
        qlen.ctypes.data, rlen.ctypes.data, out.ctypes.data, ptr(plane),
        ptr(tab), ptr(row), ptr(col), B, Bq, qidx.shape[0], Qp, Rp, A, open_,
        ext, tk.MODES[mode], tk._free_bits(free), *band, rows, layout)
    assert rc == 0, (outputs, rows, layout)
    res = {k: v.numpy() for k, v in tk._kernel_scalars(
        torch.from_numpy(out[:8 if stats else 5]), width).items()}
    if plane is not None:
        res["trace_table"] = plane
    for k, name in enumerate(PLANES[:n]):
        if tab is not None:
            res[f"{name}_table"] = tab[k].transpose(0, 2, 1)
        if row is not None:
            res[f"{name}_row"] = row[k]
            res[f"{name}_col"] = col[k]
    return res


def run_plain(case, outputs, **kw):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         case.items()}
    out = tk.score_align_plain(t.pop("ridx"), t.pop("qlen"), t.pop("rlen"),
                               outputs=outputs, **kw, **t)
    return {k: v.numpy() for k, v in out.items()}


def same(got, want, what):
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}/{k}")


def check_walk(lib, case, got, want, mode, free, what):
    """The walk kernel's host code on the short form's plane against the
    plain walk of the plain version's plane: opcodes and begins."""
    ops, beg = run_host_walk(lib, got["trace_table"], case["qidx"],
                             case["ridx"], got["end_query"], got["end_ref"],
                             mode, free)
    p_ops, p_bq, p_br = tw.device_walk_plain(
        torch.from_numpy(want["trace_table"]),
        torch.from_numpy(case["qidx"]), torch.from_numpy(case["ridx"]),
        torch.from_numpy(want["end_query"]), torch.from_numpy(want["end_ref"]),
        mode, free)
    np.testing.assert_array_equal(ops, p_ops.numpy(), err_msg=what)
    np.testing.assert_array_equal(beg, np.stack([p_bq, p_br]), err_msg=what)
    return ops, beg


@pytest.mark.parametrize("open_,ext", PENALTIES,
                         ids=[f"{a}_{b}" for a, b in PENALTIES])
@pytest.mark.parametrize("name", sorted(MODES))
def test_short_lanes_match_plain(host_lib, name, open_, ext):
    # both substitution forms, 0-38 by 0-42 or 0-46 letters (empty sides),
    # the flags a byte a cell (Rp = 44) or 16 columns a store (Rp = 48); 4
    # rows a lane and, by penalty pair, 5, 6 or 8; both payload layouts;
    # widths sat and 16 in turn
    mode, free = MODES[name]
    seed = 7 * open_ + ext + 100 * len(name)
    width = "16" if open_ == 2 else "sat"
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, width=width)
    for case in (make_case(seed, n=12, Qp=40, Rp=44, minlen=0),
                 make_case(seed + 1, n=12, Qp=40, Rp=48, minlen=0,
                           profile=True, lo=-4, hi=12)):
        form = "profile" if "profile" in case else "table"
        for outputs in CLASSES:
            want = run_plain(case, outputs, **kw)
            for rows in (4, (5, 6, 8)[PENALTIES.index((open_, ext))]):
                for layout in ((1, 2) if outputs == "stats" else (0,)):
                    what = f"{name} {form} {outputs} R {rows} L {layout}"
                    got = run_short(host_lib, case, outputs, rows=rows,
                                    layout=layout, **kw)
                    same(got, want, what)
                    if outputs == "trace":
                        check_walk(host_lib, case, got, want, mode, free,
                                   what)


@pytest.mark.parametrize("name", sorted(MODES))
def test_short_lanes_match_golden(host_lib, name):
    # Rp = 27: the flags a byte a cell, and golden's walk
    mode, free = MODES[name]
    case = make_case(("golden", name), n=10, Qp=24, Rp=27)
    for open_, ext in ((11, 1), (1, 3)):
        kw = dict(open_=open_, ext=ext, mode=mode, free=free)
        for outputs in CLASSES:
            got = run_short(host_lib, case, outputs, **kw, width="32")
            assert_matches_golden(case, got, open_, ext, mode, free,
                                  f"{name} {outputs} {open_}/{ext}")
            if outputs != "trace":
                continue
            ops, beg = run_host_walk(host_lib, got["trace_table"],
                                     case["qidx"], case["ridx"],
                                     got["end_query"], got["end_ref"], mode,
                                     free)
            for b in range(len(case["qlen"])):
                ql, rl = case["qlen"][b], case["rlen"][b]
                g = golden_pair(case, b, open_, ext, mode, free)
                w = golden.walk_trace(
                    g.trace_table,
                    bytes(case["qidx"][b, :ql].astype(np.uint8)),
                    bytes(case["ridx"][b, :rl].astype(np.uint8)),
                    g.end_query, g.end_ref, mode, free)
                assert cigar_runs_string(tw.ops_to_runs(ops[b])) == \
                    w.cigar_string(), (name, b)
                assert tuple(beg[:, b]) == (w.beg_query, w.beg_ref)


@pytest.mark.parametrize("Qp,rows", [(128, 4), (129, 5), (160, 5), (161, 6),
                                     (192, 6), (193, 8), (256, 8)])
def test_short_lanes_at_the_rows_bound(host_lib, Qp, rows):
    # a warp's 32 kR rows: the whole query at Qp = 32 kR, one row past a
    # form's at 129, 161 and 193; pairs with every row, and one short of it
    case = make_case(("rows", Qp), n=6, Qp=Qp, Rp=24, A=5)
    case["qlen"][:2] = (Qp, Qp - 1)
    case["qidx"][:2] = np.random.default_rng(Qp).integers(0, 5, (2, Qp))
    case["qidx"][1, Qp - 1] = -1
    for outputs, (mode, free), (open_, ext) in (
            ("trace", MODES["sg_qe_db"], (5, 2)),
            ("stats", MODES["sw"], (2, 2)),
            ("stats", MODES["nw"], (1, 3))):
        kw = dict(open_=open_, ext=ext, mode=mode, free=free)
        assert short_plan(host_lib, outputs, 6, 6, Qp, 24, 5)[0] == rows
        same(run_short(host_lib, case, outputs, **kw),
             run_plain(case, outputs, **kw), f"Qp {Qp} {outputs} {mode}")


@pytest.mark.parametrize("Qp,Rp,layout", [(24, 24, 1), (16, 1100, 2)])
def test_short_lanes_both_payload_layouts(host_lib, Qp, Rp, layout):
    # the reference's rule picks [m | s | l] in one word, or [m | s] + l
    # where its three fields do not fit 31 bits
    from parasail_rs_tpu.ops.scan_kernel import (stats_pack2_params,
                                                 stats_pack_params)

    packed, *_ = stats_pack_params(Qp, Rp)
    pack2, _ = stats_pack2_params(Qp)
    assert packed == (layout == 1) and pack2
    assert short_plan(host_lib, "stats", 8, 8, Qp, Rp, 6)[2] == layout
    case = make_case(("layout", Qp, Rp), n=8, Qp=Qp, Rp=Rp)
    case["qlen"][0], case["rlen"][0] = Qp, Rp     # the longest path
    for name, (open_, ext) in (("nw", (2, 2)), ("sw", (11, 1)),
                               ("sg_all", (1, 3))):
        mode, free = MODES[name]
        kw = dict(open_=open_, ext=ext, mode=mode, free=free)
        got = run_short(host_lib, case, "stats", **kw)
        same(got, run_plain(case, "stats", **kw), f"{name} layout {layout}")
        assert_matches_golden(case, {k: v for k, v in got.items()
                                     if k not in ("saturated", "promoted")},
                              open_, ext, mode, free, f"{name} golden")


def test_short_lanes_empty_sides_and_ties(host_lib):
    case = empty_case(EMPTY_QS, EMPTY_RS)
    for name, (mode, free) in MODES.items():
        kw = dict(open_=5, ext=2, mode=mode, free=free)
        for outputs in CLASSES:
            got = run_short(host_lib, case, outputs, **kw)
            same(got, run_plain(case, outputs, **kw), f"empty {name}")
            for b, (q, r) in enumerate(zip(EMPTY_QS, EMPTY_RS)):
                assert (int(got["score"][b]), int(got["end_query"][b]),
                        int(got["end_ref"][b])) == \
                    golden_empty(q, r, mode, free), (name, outputs, b)
    # the best H on two rows of one lane at descending columns: the end
    # cell is the first in row-major order
    tie, spots = tie_case()
    for outputs in CLASSES:
        kw = dict(open_=5, ext=1, mode="sw", free=SW)
        got = run_short(host_lib, tie, outputs, **kw)
        same(got, run_plain(tie, outputs, **kw), f"tie {outputs}")
        assert got["end_query"].tolist() == [i for i, _ in spots]
        assert got["end_ref"].tolist() == [j + 1 for _, j in spots]


def test_short_lanes_match_jax_scan_kernel(host_lib):
    # the Pallas kernel in interpret mode, 128 pairs: its one-pass stats
    # payloads serve open > ext
    trace_kw = dict(mode="sg", free=SW, open_=1, ext=3, width="32")
    case = make_case(4)
    got = run_short(host_lib, case, "trace", **trace_kw)
    want = run_jax_trace(case, **trace_kw)
    for k in ("score", "end_query", "end_ref", "saturated"):
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype),
                                      err_msg=k)
    for b in range(len(case["qlen"])):
        ql, rl = case["qlen"][b], case["rlen"][b]
        np.testing.assert_array_equal(got["trace_table"][b, :ql, :rl],
                                      want["trace_table"][b, :ql, :rl],
                                      err_msg=f"pair {b}")
    stats_kw = dict(mode="sw", free=SW, open_=11, ext=1, width="sat")
    case = make_case(9, profile=True, shared=True, lo=-4, hi=8)
    got = run_short(host_lib, case, "stats", **stats_kw)
    want = run_jax(case, "stats", **stats_kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype),
                                      err_msg=k)


def test_short_plan_of_the_main_paths(host_lib):
    # align_cigars' 512-pair chunks of cfg4b (Qp = Rp = 192, BLOSUM62's
    # 24 letters): 6 rows a lane, 4 pairs a block, 128 blocks
    assert short_plan(host_lib, "trace", 512, 512, 192, 192, 24) == (6, 4, 0)
    # bench.py's stats headline: per-pair profiles of 160 rows, 5 rows a
    # lane, packed
    rows, pairs, layout = short_plan(host_lib, "stats", 8192, 8192, 160, 160,
                                     25, profile=True)
    assert (rows, layout) == (5, 1) and 2 <= pairs <= 8
    # a warp's 128 rows hold the query: 4 rows a lane
    assert short_plan(host_lib, "stats", 1024, 1024, 128, 128, 24)[0] == 4
    # every class is the short form's (the plane classes:
    # test_torch_short_planes_host.py); the block kernel's: past 256 rows,
    # letters a block cannot stage
    assert short_plan(host_lib, "score", 512, 512, 160, 160, 24)[0] == 5
    assert short_plan(host_lib, "table", 512, 512, 160, 160, 24)[0] == 5
    assert short_plan(host_lib, "trace", 512, 512, 257, 192, 24)[0] == 0
    assert short_plan(host_lib, "trace", 4, 4, 16, 65536, 24)[0] == 0
