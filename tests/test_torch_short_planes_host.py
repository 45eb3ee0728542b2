"""The short form's score and plane classes (kernels K1a and K1d, one warp a
pair), built with g++, against the plain version, golden and the JAX
kernel.

``csrc/score_cell.cuh``'s short form stepped lane by lane in a loop
(``short_pair_host`` through ``csrc/score_host.cc``'s ``pt_short_host``)
in the classes it took over from the one-thread-per-pair kernel: score,
table, stats_table, rowcol and stats_rowcol, with the plane writers the
CUDA kernel runs (``short_lane_planes``: tables laid out (nplanes, B, Rp,
Qp), the last row, the last column; a lane with rows past the pair stores
row by row).  At the rows a lane and payload layouts the launcher takes
(``pt_short_plan_host``) and at the others, every output is held, exactly,
to ``score_align_plain`` (every scalar and every plane, row and column
cell), golden, and the JAX ``scan_score_align`` in interpret mode.  The
CUDA kernel itself is held to the plain version by the tests marked
``cuda`` in ``test_torch_scan_kernel.py`` and
``test_torch_stats_kernel.py`` and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_segment_host import tie_case  # noqa: E402
from test_torch_short_host import (  # noqa: E402
    MODES,
    PENALTIES,
    build_short_lib,
    run_plain,
    run_short,
    same,
    short_plan,
)
from test_torch_stats_kernel import (  # noqa: E402
    assert_matches_golden,
    assert_same,
    make_case,
    run_jax,
)
from test_torch_trace_kernel import (  # noqa: E402
    EMPTY_QS,
    EMPTY_RS,
    empty_case,
    golden_empty,
)

CLASSES = ("score", "table", "stats_table", "rowcol", "stats_rowcol")
STATS = ("stats_table", "stats_rowcol")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_short_lib(tmp_path_factory)


def layouts(outputs):
    return (1, 2) if outputs in STATS else (0,)


def lane_edges(case, kR, rng):
    """Put the first pairs' query lengths on a lane's edge: kR n, kR n - 1
    and kR n + 1 rows (the last row the last of a lane, one short of it,
    the first of the next), each under the padded query."""
    Qp = case["qidx"].shape[1]
    n = max(1, (Qp - 2) // kR)
    edges = [x for x in (kR * n, kR * n - 1, kR * n + 1, kR, kR + 1)
             if 0 < x <= Qp]
    for b, ql in enumerate(edges):
        case["qlen"][b] = ql
        if case["qidx"].shape[0] > 1:
            case["qidx"][b, :ql] = rng.integers(0, 6, size=ql)
    return case


@pytest.mark.parametrize("open_,ext", PENALTIES,
                         ids=[f"{a}_{b}" for a, b in PENALTIES])
@pytest.mark.parametrize("name", sorted(MODES))
def test_short_planes_match_plain(host_lib, name, open_, ext):
    # the table form, per-pair and shared profiles; 0-38 by 0-42 or 0-46
    # letters (empty sides); Qp = 40 (whole vectors at 4 and 8 rows, none
    # at 5) and 42 (at none of 4 and 8, 6's pairs of words); lengths on a
    # lane's edge; 4 rows a lane and, by penalty pair, 5, 6 or 8; both
    # payload layouts; widths sat and 16 in turn
    mode, free = MODES[name]
    seed = 7 * open_ + ext + 100 * len(name)
    width = "16" if open_ == 2 else "sat"
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, width=width)
    other = (5, 6, 8)[PENALTIES.index((open_, ext))]
    rng = np.random.default_rng(seed)
    cases = {
        "table": lane_edges(make_case(seed, n=12, Qp=40, Rp=44, minlen=0),
                            other, rng),
        "profile": lane_edges(make_case(seed + 1, n=12, Qp=42, Rp=48,
                                        minlen=0, profile=True, lo=-4,
                                        hi=12), 4, rng),
        "shared profile": make_case(seed + 2, n=8, Qp=40, Rp=44,
                                    profile=True, shared=True, lo=-4, hi=12),
    }
    for form, case in cases.items():
        for outputs in CLASSES:
            want = run_plain(case, outputs, **kw)
            for rows in (4, other):
                for layout in layouts(outputs):
                    got = run_short(host_lib, case, outputs, rows=rows,
                                    layout=layout, **kw)
                    same(got, want, f"{name} {form} {outputs} R {rows} "
                                    f"L {layout}")


@pytest.mark.parametrize("name", sorted(MODES))
def test_short_planes_match_golden(host_lib, name):
    mode, free = MODES[name]
    case = make_case(("planes golden", name), n=10, Qp=24, Rp=27)
    for open_, ext in ((11, 1), (1, 3)):
        kw = dict(open_=open_, ext=ext, mode=mode, free=free)
        for outputs in CLASSES:
            got = run_short(host_lib, case, outputs, **kw, width="32")
            assert_matches_golden(case, got, open_, ext, mode, free,
                                  f"{name} {outputs} {open_}/{ext}")


@pytest.mark.parametrize("Qp,rows", [(128, 4), (129, 5), (160, 5), (161, 6),
                                     (192, 6), (193, 8), (256, 8)])
def test_short_planes_at_the_rows_bound(host_lib, Qp, rows):
    # a warp's 32 kR rows: the whole query at Qp = 32 kR, one row past a
    # form's at 129, 161 and 193; the last row on the last lane, one short
    # of it and on a lane's edge
    case = make_case(("planes rows", Qp), n=6, Qp=Qp, Rp=20, A=5)
    case["qlen"][:4] = (Qp, Qp - 1, rows * 20, rows * 20 + 1)
    case["qidx"][:4] = np.random.default_rng(Qp).integers(0, 5, (4, Qp))
    case["qidx"][1, Qp - 1] = -1
    for outputs, (mode, free), (open_, ext) in (
            ("score", MODES["sg_qe_db"], (5, 2)),
            ("table", MODES["nw"], (1, 3)),
            ("stats_table", MODES["sw"], (2, 2)),
            ("rowcol", MODES["sg_all"], (11, 1)),
            ("stats_rowcol", MODES["sg_qb_de"], (1, 3))):
        kw = dict(open_=open_, ext=ext, mode=mode, free=free)
        assert short_plan(host_lib, outputs, 6, 6, Qp, 20, 5)[0] == rows
        same(run_short(host_lib, case, outputs, **kw),
             run_plain(case, outputs, **kw), f"Qp {Qp} {outputs} {mode}")


def test_short_planes_empty_sides_and_ties(host_lib):
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
                if not (q and r):
                    # no cell of a pair with an empty side is written
                    for k, v in got.items():
                        if k.endswith(("_table", "_row", "_col")):
                            assert not v[b].any(), (name, outputs, k, b)
    # the best H on two rows of one lane at descending columns: the end
    # cell is the first in row-major order
    tie, spots = tie_case()
    for outputs in CLASSES:
        kw = dict(open_=5, ext=1, mode="sw", free=(True,) * 4)
        got = run_short(host_lib, tie, outputs, **kw)
        same(got, run_plain(tie, outputs, **kw), f"tie {outputs}")
        assert got["end_query"].tolist() == [i for i, _ in spots]
        assert got["end_ref"].tolist() == [j + 1 for _, j in spots]


def test_short_planes_match_jax_scan_kernel(host_lib):
    # the Pallas kernel in interpret mode, one case a class (its one-pass
    # stats payloads serve open > ext); every cell inside each pair
    for outputs, mode, free, (open_, ext), width, form in (
            ("score", "sg", MODES["sg_qb_de"][1], (11, 1), "sat", {}),
            ("table", "sw", MODES["sw"][1], (11, 1), "sat",
             dict(profile=True)),
            ("stats_table", "nw", MODES["nw"][1], (4, 2), "32", {}),
            ("rowcol", "sg", MODES["sg_all"][1], (5, 2), "sat",
             dict(profile=True, shared=True)),
            ("stats_rowcol", "sw", MODES["sw"][1], (11, 1), "8", {})):
        case = make_case(("planes jax", outputs), n=128, **form)
        kw = dict(open_=open_, ext=ext, mode=mode, free=free, width=width)
        got = run_short(host_lib, case, outputs, **kw)
        assert_same(got, run_jax(case, outputs, **kw), case, outputs)


def test_short_plan_of_the_planes_main_paths(host_lib):
    # the score headline (bench.py: 8,192 per-pair profiles of 160 rows):
    # 5 rows a lane, several pairs a block within the shared memory
    rows, pairs, layout = short_plan(host_lib, "score", 8192, 8192, 160, 160,
                                     25, profile=True)
    assert (rows, layout) == (5, 0) and 2 <= pairs <= 8
    # one profile against 16,384 references (Bq = 1): 8 pairs a block
    assert short_plan(host_lib, "score", 16384, 1, 192, 192, 24,
                      profile=True) == (6, 8, 0)
    # use_table() of 512 BLOSUM62 pairs (Qp = Rp = 192): 6 rows, 4 pairs
    # a block, 128 blocks; stats packed [m | s | l]
    assert short_plan(host_lib, "table", 512, 512, 192, 192, 24) == (6, 4, 0)
    assert short_plan(host_lib, "stats_table", 512, 512, 192, 192,
                      24) == (6, 4, 1)
    # use_last_rowcol() of the 8,192 SW pairs: 8 pairs a block
    assert short_plan(host_lib, "rowcol", 8192, 8192, 192, 192,
                      24) == (6, 8, 0)
    assert short_plan(host_lib, "stats_rowcol", 8192, 8192, 192, 192,
                      24) == (6, 8, 1)
    # Aligner.align's single pair (150 bp, padded to 192): one warp
    assert short_plan(host_lib, "score", 1, 1, 192, 192, 5) == (6, 1, 0)
    # past 256 rows: the block kernel's one-shot form
    for outputs in CLASSES:
        assert short_plan(host_lib, outputs, 512, 512, 257, 192, 24)[0] == 0
