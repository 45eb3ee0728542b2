"""The packed score form's own lanes, built with g++, against the int32
form's lanes, golden and the dispatch's rerun.

``csrc/segment16.cuh`` holds the block kernel's score class on 16x2 DPX:
two pairs a lane as the halves of int32 words, the band of 16-bit values
inside which nothing wraps, and the ``over`` flag of a pair that leaves
it.  ``csrc/score_host.cc::pt_segment16_host`` steps the kernel's lanes,
chain of warps and groups of rows in a loop on int16 halves (wrapping as
the card's adds do), with the rows a lane, warps a block and blocks a
unit the launch would have.  Every case here is held to
``pt_segment_host`` (the int32 form's lanes, which
``test_torch_segment_host.py`` holds to the plain versions), to golden,
and, for pairs that leave the band, through
``engine.dispatch.PendingResult``'s rerun to the int32 form; the route's
choice (``dispatch.packed_units``) and its counters are asserted too.
No card is needed.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu.golden import model as golden  # noqa: E402

from parasail_rs_tpu_torch.engine import dispatch  # noqa: E402
from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402
from parasail_rs_tpu_torch.utils import stages  # noqa: E402

from test_torch_kernel_host import build_host_lib  # noqa: E402
from test_torch_scan_kernel import SG_FREE  # noqa: E402

MODES = {"nw": ("nw", (False,) * 4), "sw": ("sw", (True,) * 4),
         **{name: ("sg", f) for name, f in SG_FREE.items()}}
P, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host_lib(tmp_path_factory)
    lib.pt_segment_host.restype = I
    lib.pt_segment_host.argtypes = [I] + [P] * 12 + [I] * 15
    lib.pt_segment16_host.restype = I
    lib.pt_segment16_host.argtypes = [P] * 11 + [I] * 16
    lib.pt_segment16_plan_host.restype = I
    lib.pt_segment16_plan_host.argtypes = [I] * 8 + [P]
    lib.pt_block_plan_host.restype = I
    lib.pt_block_plan_host.argtypes = [I] * 9 + [P]
    return lib


def ptr(a):
    return None if a is None else a.ctypes.data


def make_case(seed, B, *, Qp, Rp, A, subs, lo=-4, hi=8, edge=True):
    """Seeded letters, ragged lengths (``edge``: empty sides, whole
    stripes and a full pair), and the scores: a table of A letters
    (``subs`` "table"), or one query's (Qp, A) profile rows."""
    rng = np.random.default_rng(seed)
    qlen = rng.integers(0, Qp + 1, size=B).astype(np.int32)
    rlen = rng.integers(0, Rp + 1, size=B).astype(np.int32)
    if edge:
        qlen[:6] = (0, 5, Qp, 32, 33, 64 if Qp >= 64 else Qp)
        rlen[:6] = (7, 0, Rp, 64, 65, Rp - 1)
    table = rng.integers(lo, hi, size=(A, A)).astype(np.int32)
    shared = subs == "profile"
    qidx = rng.integers(0, A, size=(1 if shared else B, Qp)).astype(np.int32)
    if shared:
        qlen[:] = rng.integers(Qp // 2, Qp + 1)
    return dict(table=table, qidx=qidx, qlen=qlen, rlen=rlen,
                ridx=rng.integers(0, A, size=(B, Rp)).astype(np.int32),
                profile=np.ascontiguousarray(table[qidx[:1]])
                if shared else None)


def segments(case, seg):
    B, Rp = case["ridx"].shape
    nseg = -(-Rp // seg)
    padded = np.zeros((B, nseg * seg), np.int32)
    padded[:, :Rp] = case["ridx"]
    for si in range(nseg):
        yield si, np.ascontiguousarray(padded[:, si * seg:(si + 1) * seg])


def subs_of(case):
    if case["profile"] is not None:
        return case["profile"], None, 1
    return case["table"], case["qidx"], case["qidx"].shape[0]


def run_int32(lib, case, seg, *, open_, ext, mode, free, rows, warps,
              cluster):
    """``pt_segment_host`` (the int32 form) chained over the case."""
    subs, qidx, Bq = subs_of(case)
    B = len(case["qlen"])
    Qp = case["qidx"].shape[1]
    st_h, st_f = np.zeros((B, Qp), np.int32), np.zeros((B, Qp), np.int32)
    acc, out = np.zeros((B, 8), np.int32), np.zeros((8, B), np.int32)
    for si, cols in segments(case, seg):
        assert lib.pt_segment_host(
            0, ptr(subs), ptr(qidx), None, ptr(cols), ptr(case["qlen"]),
            ptr(case["rlen"]), ptr(st_h), ptr(st_f), None, ptr(acc),
            ptr(out), None, B, Bq, 0, Qp, seg, subs.shape[-1], open_, ext,
            tk.MODES[mode], tk._free_bits(free), si * seg, int(si > 0),
            warps, rows, cluster) == 0
    return out[:5], {"h": st_h, "f": st_f, "acc": acc}


def run_packed(lib, case, seg, *, open_, ext, mode, free, rows, warps,
               cluster, units=None):
    """``pt_segment16_host`` (the packed form) chained over the case on
    ``units`` (default: ``pair_units``); returns (out (6, B), state)."""
    subs, qidx, Bq = subs_of(case)
    B = len(case["qlen"])
    Qp = case["qidx"].shape[1]
    if units is None:
        units = tk.pair_units(case["qlen"], case["rlen"])
    units = np.ascontiguousarray(units, np.int32)
    bound = int(np.abs(subs).max())
    st_h, st_f = np.zeros((B, Qp), np.int32), np.zeros((B, Qp), np.int32)
    acc, over = np.zeros((B, 8), np.int32), np.zeros(B, np.int32)
    out = np.zeros((6, B), np.int32)
    for si, cols in segments(case, seg):
        assert lib.pt_segment16_host(
            ptr(subs), ptr(qidx), ptr(cols), ptr(case["qlen"]),
            ptr(case["rlen"]), ptr(units), ptr(st_h), ptr(st_f), ptr(acc),
            ptr(over), ptr(out), len(units), B, Bq, Qp, seg, subs.shape[-1],
            open_, ext, tk.MODES[mode], tk._free_bits(free), si * seg,
            int(si > 0), bound, warps, rows, cluster) == 0
    return out, {"h": st_h, "f": st_f, "acc": acc, "over": over}


def same_as_int32(case, got, gst, want, wst, what):
    """Every pair the packed form did not flag equals the int32 form's:
    its five outputs, its state rows and its accumulator."""
    over = got[5] != 0
    np.testing.assert_array_equal(got[:5][:, ~over], want[:, ~over],
                                  err_msg=what)
    for b in np.nonzero(~over)[0]:
        q = int(case["qlen"][b])
        if case["rlen"][b] > 0:
            np.testing.assert_array_equal(gst["h"][b, :q], wst["h"][b, :q],
                                          err_msg=f"{what} h {b}")
            np.testing.assert_array_equal(gst["f"][b, :q], wst["f"][b, :q],
                                          err_msg=f"{what} f {b}")
        np.testing.assert_array_equal(gst["acc"][b, :5], wst["acc"][b, :5],
                                      err_msg=f"{what} acc {b}")
    return over


def check_golden(case, out, *, open_, ext, mode, free):
    """Each pair with two sides against golden (an empty side's end cell
    is the int32 form's, held above)."""
    for b in range(len(case["qlen"])):
        ql, rl = int(case["qlen"][b]), int(case["rlen"][b])
        if not ql or not rl:
            continue
        qi = case["qidx"][0 if case["qidx"].shape[0] == 1 else b, :ql]
        ri = case["ridx"][b, :rl]
        sub = case["table"][qi[:, None], ri[None, :]].astype(np.int64)
        g = golden.align(sub, qi[:, None] == ri[None, :], open_, ext, mode,
                         free)
        assert (out[0][b], out[1][b], out[2][b]) == \
            (g.score, g.end_query, g.end_ref), b


# (rows a lane, warps a block, blocks a unit, segment columns): 2, 4 and 8
# rows a lane; one segment, several, a chain over a cluster
FORMS = [(2, 1, 1, 48), (4, 2, 1, 120), (8, 1, 2, 40)]
SUBS = ("pair", "table", "profile")


@pytest.mark.parametrize("form", FORMS, ids=[f"R{f[0]}" for f in FORMS])
@pytest.mark.parametrize("subs", SUBS)
@pytest.mark.parametrize("name", sorted(MODES))
def test_packed_lanes_match_int32_and_golden(host_lib, name, subs, form):
    """Every mode, the pair table (4 letters), a 20-letter table and one
    query's profile, 2, 4 and 8 rows a lane, one and several segments
    with resume, an odd B with ragged lengths: the packed lanes flag
    nothing and equal the int32 lanes, state included, and golden."""
    mode, free = MODES[name]
    rows, warps, cluster, seg = form
    A = 4 if subs == "pair" else 20
    case = make_case(7 * rows + len(name) + len(subs), 13, Qp=70, Rp=120,
                     A=A, subs=subs)
    kw = dict(open_=11, ext=1, mode=mode, free=free, rows=rows, warps=warps,
              cluster=cluster)
    want, wst = run_int32(host_lib, case, seg, **kw)
    got, gst = run_packed(host_lib, case, seg, **kw)
    over = same_as_int32(case, got, gst, want, wst, f"{name} {subs} {form}")
    assert not over.any()
    check_golden(case, got, open_=11, ext=1, mode=mode, free=free)


@pytest.mark.parametrize("open_,ext", [(2, 2), (1, 3), (6, 2)])
@pytest.mark.parametrize("name", ["nw", "sw", "sg_qe", "sg_de", "sg"])
def test_packed_lanes_at_other_penalties(host_lib, name, open_, ext):
    """open == ext and open < ext, which the recurrence takes literally."""
    mode, free = MODES[name]
    case = make_case(31 + open_ * ext + len(name), 9, Qp=60, Rp=90, A=4,
                     subs="pair")
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, rows=4, warps=1,
              cluster=1)
    want, wst = run_int32(host_lib, case, 32, **kw)
    got, gst = run_packed(host_lib, case, 32, **kw)
    assert not same_as_int32(case, got, gst, want, wst, name).any()
    check_golden(case, got, open_=open_, ext=ext, mode=mode, free=free)


@pytest.mark.parametrize("name", ["nw", "sw", "sg_qe", "sg_de", "sg_qb_de"])
def test_two_halves_of_different_shapes(host_lib, name):
    """Units whose halves differ widely in rows and columns (and a half
    with an empty side, and one beside nothing): each half's cells past
    its pair are neither candidates, extremes nor state."""
    mode, free = MODES[name]
    case = make_case(5, 8, Qp=96, Rp=150, A=4, subs="pair", edge=False)
    case["qlen"][:] = (96, 3, 40, 96, 0, 70, 1, 50)
    case["rlen"][:] = (2, 150, 150, 9, 30, 150, 1, 77)
    units = np.array([[0, 1], [2, 3], [4, 5], [7, 6]], np.int32)
    odd = np.array([[6, 0], [1, 2], [3, 4], [5, -1], [7, -1]], np.int32)
    kw = dict(open_=11, ext=1, mode=mode, free=free, rows=2, warps=2,
              cluster=1)
    want, wst = run_int32(host_lib, case, 64, **kw)
    for u in (units, odd):
        got, gst = run_packed(host_lib, case, 64, units=u, **kw)
        assert not same_as_int32(case, got, gst, want, wst, name).any()
    check_golden(case, got, open_=11, ext=1, mode=mode, free=free)


@pytest.mark.parametrize("name", ["nw", "sw", "sg", "sg_qe", "sg_de"])
def test_end_cell_ties(host_lib, name):
    """Equal H in many cells: within a half across rows and columns (a
    table of one score), and across the two halves of a lane (a unit of
    two copies of one pair, and of a pair beside its transposed twin):
    each half's end cell is the int32 form's and golden's."""
    mode, free = MODES[name]
    case = make_case(3, 6, Qp=64, Rp=64, A=4, subs="pair", edge=False)
    case["table"][:] = 2
    case["qlen"][:] = (64, 64, 40, 40, 17, 33)
    case["rlen"][:] = (64, 64, 40, 40, 33, 17)
    case["ridx"][1] = case["ridx"][0]
    case["qidx"][1] = case["qidx"][0]
    case["ridx"][3, :40] = case["qidx"][2, :40]
    case["qidx"][3, :40] = case["ridx"][2, :40]
    units = np.array([[0, 1], [2, 3], [4, 5]], np.int32)
    for rows in (2, 4, 8):
        kw = dict(open_=3, ext=1, mode=mode, free=free, rows=rows, warps=1,
                  cluster=1)
        want, wst = run_int32(host_lib, case, 24, **kw)
        got, gst = run_packed(host_lib, case, 24, units=units, **kw)
        assert not same_as_int32(case, got, gst, want, wst, name).any()
    check_golden(case, got, open_=3, ext=1, mode=mode, free=free)


def band_case(kind):
    """Pairs built to leave the 16-bit band beside pairs that stay in it:
    SW of identical sequences scoring past 32,767 (a match of 120), NW
    borders past -32,768 (an extend of 120)."""
    rng = np.random.default_rng(11)
    A, B, Qp, Rp = 4, 7, 320, 320
    table = np.full((A, A), -3, np.int32)
    np.fill_diagonal(table, 120 if kind == "sw" else 5)
    q = rng.integers(0, A, size=(B, Qp)).astype(np.int32)
    r = rng.integers(0, A, size=(B, Rp)).astype(np.int32)
    r[:3] = q[:3]
    qlen = np.array([320, 300, 290, 320, 40, 12, 100], np.int32)
    rlen = np.array([320, 300, 290, 60, 320, 14, 90], np.int32)
    return dict(table=table, qidx=q, ridx=r, qlen=qlen, rlen=rlen,
                profile=None)


@pytest.mark.parametrize("rows", [2, 8])
@pytest.mark.parametrize("kind,name,open_,ext", [
    ("sw", "sw", 14, 1), ("sw", "sg", 14, 1), ("nw", "nw", 150, 120),
    ("nw", "sg_qe", 150, 120), ("nw", "sg_de", 150, 120)])
def test_band_crossing_pairs_are_flagged_and_rerun(host_lib, kind, name,
                                                   open_, ext, rows):
    """Every pair that leaves the band (the int32 form's sat16 among them)
    is flagged; every other equals the int32 form; the dispatch's fetch
    recomputes the flagged ones through the int32 form, so that every
    output, sat16 included, is the int32 form's and golden's, and counts
    them as ``score16_reruns``."""
    mode, free = MODES[name]
    case = band_case(kind)
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, rows=rows,
              warps=2, cluster=1)
    want, _ = run_int32(host_lib, case, 128, **kw)
    got, gst = run_packed(host_lib, case, 128, **kw)
    _, wst = run_int32(host_lib, case, 128, **kw)
    over = same_as_int32(case, got, gst, want, wst, name)
    assert over[:3].all() and over[want[4] != 0].all(), (over, want[4])
    assert not over.all()
    batch = dispatch.PairBatch(
        None, torch.from_numpy(case["qidx"]), torch.from_numpy(case["ridx"]),
        case["qlen"], case["rlen"], table=torch.from_numpy(case["table"]),
        device="cpu", score_bound=int(np.abs(case["table"]).max()))
    cols = {"score": got[0], "end_query": got[1], "end_ref": got[2],
            "promoted": got[3] != 0, "saturated": got[4] != 0,
            "over16": got[5] != 0}
    stages.reset()
    stages.enable(True)
    try:
        fixed, _ = dispatch.PendingResult(
            {k: torch.from_numpy(np.asarray(v)) for k, v in cols.items()},
            rerun=dispatch._rerun16(batch, gap_open=open_, gap_extend=ext,
                                    mode=mode, free=free,
                                    width="sat")).fetch()
        snap = stages.snapshot()
    finally:
        stages.enable(False)
    assert snap["count.score16_reruns"]["n"] == int(over.sum())
    assert "over16" not in fixed
    np.testing.assert_array_equal(fixed["score"], want[0])
    np.testing.assert_array_equal(fixed["end_query"], want[1])
    np.testing.assert_array_equal(fixed["end_ref"], want[2])
    np.testing.assert_array_equal(fixed["promoted"], want[3] != 0)
    np.testing.assert_array_equal(fixed["saturated"], want[4] != 0)
    check_golden(case, (fixed["score"], fixed["end_query"],
                        fixed["end_ref"]), open_=open_, ext=ext, mode=mode,
                 free=free)


def test_pair_units_are_sorted_neighbours():
    qlen = np.array([5, 3, 9, 3, 1], np.int32)
    rlen = np.array([1, 2, 3, 4, 5], np.int32)
    np.testing.assert_array_equal(tk.pair_units(qlen, rlen),
                                  [[4, 1], [3, 0], [2, -1]])
    assert tk.pair_units(qlen[:4], rlen[:4]).shape == (2, 2)
    assert tk.pair_units(qlen[:0], rlen[:0]).shape == (0, 2)


def cpu_batch(B=6, Qp=40, Rp=60, A=4, profile_rows=0, score=5):
    rng = np.random.default_rng(B)
    table = torch.full((A, A), score, dtype=torch.int32)
    prof = (None if not profile_rows else
            torch.zeros((profile_rows, Qp, A), dtype=torch.int32))
    return dispatch.PairBatch(
        prof, None if prof is not None else torch.zeros((B, Qp),
                                                        dtype=torch.int32),
        torch.from_numpy(rng.integers(0, A, size=(B, Rp)).astype(np.int32)),
        np.full(B, Qp, np.int32), np.arange(B, dtype=np.int32) + 1,
        table=None if prof is not None else table, device="cpu")


@pytest.mark.parametrize("route,outputs,batch_kw,open_,want", [
    ("cuda_segments", "score", {}, 11, "score16_pairs"),
    ("cuda_kernel:block", "score", {}, 11, "score16_pairs"),
    ("cuda_kernel:block", "score", {"profile_rows": 6}, 11,
     "score32_pairs"),
    ("cuda_kernel:short", "score", {}, 11, None),
    ("cuda_chunked", "score", {}, 11, "score16_pairs"),
    ("cuda_segments", "score", {"profile_rows": 1}, 11, "score16_pairs"),
    ("cuda_segments", "score", {"profile_rows": 6}, 11, "score32_pairs"),
    ("cuda_segments", "score", {"score": 5000}, 11, "score32_pairs"),
    ("cuda_segments", "score", {}, -1, "score32_pairs"),
    ("cuda_segments", "stats", {}, 11, None),
    ("cuda_chunked", "trace", {}, 11, None),
    ("cuda_kernel:block", "stats", {}, 11, None),
    ("torch_segments", "score", {}, 11, None),
    ("torch_plain", "score", {}, 11, None),
])
def test_route_picks_the_packed_form_and_counts(monkeypatch, route, outputs,
                                                batch_kw, open_, want):
    """The block kernel's score class on the card runs packed where the
    penalties and scores leave a band and the scores are a table or one
    query's profile: on the segment and chunked routes, and on the
    one-shot route where the short form does not take the batch (its
    rule, ``short_plan``, stands in here for the card's); otherwise the
    int32 form takes it (``score32_pairs``), and every other route, form
    or class is not the packed form's to count."""
    route, _, form = route.partition(":")
    monkeypatch.setattr(dispatch, "short_plan",
                        lambda *a: (4 if form == "short" else 0, 0, 0))
    batch = cpu_batch(**batch_kw)
    stages.reset()
    stages.enable(True)
    try:
        units = dispatch.packed_units(batch, route, outputs, open_, 1)
        snap = stages.snapshot()
    finally:
        stages.enable(False)
    counted = {k[len("count."):]: v["n"] for k, v in snap.items()
               if k.startswith("count.score")}
    if want is None:
        assert units is None and not counted
    else:
        assert counted == {want: batch.size}
        assert (units is not None) == (want == "score16_pairs")
    if units is not None:
        np.testing.assert_array_equal(
            units.numpy(), tk.pair_units(batch.qlen, batch.rlen))


@pytest.mark.parametrize("U,Qs,ncols,plan", [
    (64, 12288, 8192, (8, 8, 2)),     # the 10 kbp score cell's 128 pairs
    (8, 4096, 8192, (8, 8, 2)),
    (200, 600, 8192, (2, 8, 1)),
    (3, 100, 40, (2, 2, 1)),
])
def test_packed_plan_is_the_rule_on_units(host_lib, U, Qs, ncols, plan):
    """seg16_plan is seg_plan's rule with the launch's units as its B."""
    got = (ctypes.c_int * 3)()
    host_lib.pt_segment16_plan_host(U, Qs, ncols, 4, 0, 0, 0, 0,
                                    ctypes.cast(got, P))
    ref = (ctypes.c_int * 3)()
    host_lib.pt_block_plan_host(0, U, Qs, ncols, 4, 0, 0, 0, 0,
                                ctypes.cast(ref, P))
    assert tuple(got) == tuple(ref) == plan


def test_usable_band_limits(host_lib):
    """The host's rule of a band matches the kernel's: it refuses the
    penalties and scores the route sends to the int32 form."""
    case = make_case(1, 3, Qp=20, Rp=20, A=4, subs="pair", edge=False)
    for open_, ext, score, ok in ((11, 1, 11, True), (-1, 1, 5, False),
                                  (11, 1, 5000, False), (4000, 1, 1, True)):
        case["table"][:] = score
        assert tk.packed_usable(open_, ext, score) == ok
        subs, qidx, Bq = subs_of(case)
        units = tk.pair_units(case["qlen"], case["rlen"])
        out = np.zeros((6, 3), np.int32)
        z = np.zeros((3, 20), np.int32)
        acc, over = np.zeros((3, 8), np.int32), np.zeros(3, np.int32)
        rc = host_lib.pt_segment16_host(
            ptr(subs), ptr(qidx), ptr(case["ridx"]), ptr(case["qlen"]),
            ptr(case["rlen"]), ptr(units), ptr(z), ptr(z.copy()), ptr(acc),
            ptr(over), ptr(out), len(units), 3, Bq, 20, 20, 4, open_, ext, 0,
            0, 0, 0, score, 1, 2, 1)
        assert (rc == 0) == ok
