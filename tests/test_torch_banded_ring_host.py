"""The banded warp form (kernel K1e's score class: a pair's row blocks on a
ring of 8, 16 or 32 lanes), built with g++, against ``score_pair``'s
band-only sweep, the plain version, golden and the JAX package.

``csrc/score_cell.cuh``'s ring (``BandLane``, ``band_lane_iter``,
``band_finish``) stepped lane by lane in a loop (``band_pair_host``
through ``csrc/score_host.cc``'s ``pt_band_host``, each lane reading what
its ring predecessor left a step before, as the kernel's shuffle does),
at the form the launcher's rule picks (``pt_band_plan_host``) and at each
(G, kR) at the edge of its reach, must equal exactly ``score_pair``'s
band-only sweep, one pair at a time (``pt_banded_host``), ``score_align_plain(banded=True)``,
golden's ``banded_nw_fill`` and the JAX wavefront and Pallas kernel in
interpret mode where those agree (ROADMAP Queue 3): scores, end cells
and both saturation flags, at bands -1 to past the ring's reach (where
the rule gives the masked full sweep), in NW, SG free-end sets and SW, at
open > ext, open == ext and open < ext, in the table and profile forms
with a query shared by every pair, on sides far apart in length and
lengths that are no multiple of kR, with repeated maxima for the end
cell's tie order, and on the empty-side and unreachable-corner pairs.
The CUDA kernel is held to the plain version by the tests marked
``cuda``, which also assert which form each launch took.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu.golden import banded_nw_fill  # noqa: E402

from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402

from test_torch_banded import (  # noqa: E402
    DNA,
    STEP0,
    oracle,
    run_jax_wavefront,
)
from test_torch_banded_classes import (  # noqa: E402
    run_jax,
    seed3_batch,
)
from test_torch_kernel_host import build_host_lib, ragged  # noqa: E402

NEG = -(1 << 30)
SG_FREE = [(True, False, False, False), (False, True, False, False),
           (False, False, True, True), (True, False, False, True),
           (False, True, True, False), (True, True, True, True)]
MODES = [("nw", (False,) * 4)] + [("sg", f) for f in SG_FREE] + \
    [("sw", (True,) * 4)]
PENALTIES = [(4, 1), (2, 2), (1, 3)]
# every form the kernel has: (G lanes, kR rows)
FORMS = [(g, r) for g in (8, 16, 32) for r in (4, 5, 6, 8)]


def reach(G, kR):
    return (G - 1) * kR + G + 1


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_host_lib(tmp_path_factory)
    lib.pt_band_host.restype = ctypes.c_int
    lib.pt_band_host.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
    lib.pt_band_plan_host.restype = ctypes.c_int
    lib.pt_band_plan_host.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


def plan(lib, B, Qp, Rp, bw, A=20, profile=False):
    p = np.zeros(2, np.int32)
    assert lib.pt_band_plan_host(B, Qp, Rp, bw, A, int(profile),
                                 p.ctypes.data) == 0
    return tuple(int(x) for x in p)


def _inputs(case):
    """(subs, qidx or None, Bq, Qp, A) of a table or profile case."""
    if "profile" in case:
        prof = np.ascontiguousarray(case["profile"], np.int32)
        return prof, None, prof.shape[0], prof.shape[1], prof.shape[2]
    q = np.ascontiguousarray(case["qidx"], np.int32)
    t = np.ascontiguousarray(case["table"], np.int32)
    return t, q, q.shape[0], q.shape[1], t.shape[0]


def run_ring(lib, case, *, open_, ext, mode, free, bw, form=(0, 0)):
    """``pt_band_host``: (5, B) score, end_query, end_ref, sat8, sat16, or
    None where the form does not reach the band."""
    subs, q, Bq, Qp, A = _inputs(case)
    ridx, qlen, rlen = (np.ascontiguousarray(case[k], np.int32)
                        for k in ("ridx", "qlen", "rlen"))
    B, Rp = ridx.shape
    out = np.zeros((5, B), np.int32)
    rc = lib.pt_band_host(subs.ctypes.data, None if q is None else
                          q.ctypes.data, ridx.ctypes.data, qlen.ctypes.data,
                          rlen.ctypes.data, out.ctypes.data, B, Bq, Qp, Rp,
                          A, open_, ext, tk.MODES[mode], tk._free_bits(free),
                          bw, form[0], form[1])
    return None if rc == -1 else out


def run_thread(lib, case, *, open_, ext, mode, free, bw):
    """score_pair's band-only sweep, one pair at a time
    (``pt_banded_host``, class 0)."""
    subs, q, Bq, Qp, A = _inputs(case)
    ridx, qlen, rlen = (np.ascontiguousarray(case[k], np.int32)
                        for k in ("ridx", "qlen", "rlen"))
    B, Rp = ridx.shape
    out = np.zeros((8, B), np.int32)
    assert lib.pt_banded_host(
        0, subs.ctypes.data, None if q is None else q.ctypes.data, None,
        ridx.ctypes.data, qlen.ctypes.data, rlen.ctypes.data,
        out.ctypes.data, None, None, None, None, B, Bq, 0, Qp, Rp, A, open_,
        ext, tk.MODES[mode], tk._free_bits(free), bw) == 0
    return out[:5]


def run_plain(case, *, width="sat", **kw):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         case.items()}
    out = tk.score_align(t.pop("ridx"), t.pop("qlen"), t.pop("rlen"),
                         width=width, banded=True,
                         bandwidth=kw.pop("bw"), **kw, **t)
    return {k: v.numpy() for k, v in out.items()}


def assert_equals_plain(out, case, what, widths=("sat",), **kw):
    """The host's scalars against the plain version's at each width (sat:
    promoted = sat8, saturated = sat16; 8 and 16: saturated)."""
    for width in widths:
        p = run_plain(case, width=width, **kw)
        for row, k in enumerate(("score", "end_query", "end_ref")):
            np.testing.assert_array_equal(out[row], p[k], err_msg=what)
        if width == "sat":
            np.testing.assert_array_equal(out[3] != 0, p["promoted"],
                                          err_msg=what)
            np.testing.assert_array_equal(out[4] != 0, p["saturated"],
                                          err_msg=what)
        else:
            np.testing.assert_array_equal(
                out[3 if width == "8" else 4] != 0, p["saturated"],
                err_msg=f"{what} width {width}")


def test_rule_on_the_main_paths(lib):
    # cfg2 at bw 16: G = 8, kR = 4 (37 > 32); the long banded batch at bw
    # 64: G = 32, kR = 4 (157 > 128), not G = 16, kR = 8, which would
    # half-fill the card; G = 32 at kR = 8 reaches bw 140 and no further
    assert plan(lib, 8192, 192, 192, 16) == (8, 4)
    assert plan(lib, 128, 4096, 4096, 64) == (32, 4)
    assert plan(lib, 128, 4096, 4096, 140) == (32, 8)
    assert plan(lib, 128, 4096, 4096, 141) == (0, 0)
    assert plan(lib, 8192, 192, 192, 141) == (0, 0)
    # a band wider than the padded pair is the whole pair
    assert plan(lib, 256, 64, 64, 4096) == (32, 4)
    assert plan(lib, 1, 192, 192, 16) == (8, 4)
    assert plan(lib, 8192, 192, 192, -1) == (8, 4)
    # a table past 32 KB takes the masked full sweep; a profile needs none
    assert plan(lib, 8192, 192, 192, 16, A=90) == (0, 0)
    assert plan(lib, 8192, 192, 192, 16, A=90, profile=True) == (8, 4)
    # the pick reaches its band with the fewest rows for its lanes
    for bw in range(0, 141, 7):
        G, kR = plan(lib, 512, 2048, 2048, bw)
        assert 2 * bw < reach(G, kR)
        assert all(2 * bw >= reach(G, r) for r in (4, 5, 6, 8) if r < kR)


@pytest.mark.parametrize("mode,free", MODES)
def test_ring_matches_one_thread_and_plain(lib, mode, free):
    # ragged pairs with empty sides, bands from none to wider than the
    # pair, every penalty pair, the rule's form and every form that
    # reaches; scores beyond int8 on one case, so in-band cells saturate
    n = MODES.index((mode, free))
    for p, (open_, ext) in enumerate(PENALTIES):
        rng = np.random.default_rng([n, p, 31])
        case = ragged(rng, 24, 40, 44, 5, 0)
        if p == 0:
            case["table"] = rng.integers(-300, 400,
                                         size=(5, 5)).astype(np.int32)
        for bw in (-1, 0, 1, 3, 8, 64):
            kw = dict(open_=open_, ext=ext, mode=mode, free=free, bw=bw)
            want = run_thread(lib, case, **kw)
            forms = [(0, 0)] + FORMS[p::3]
            for form in forms:
                got = run_ring(lib, case, form=form, **kw)
                if got is None:
                    assert 2 * min(bw, 44) >= reach(*form)
                    continue
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"bw={bw} {form}")
            assert_equals_plain(want, case, f"bw={bw}",
                                widths=("sat", "8", "16") if bw == 3
                                else ("sat",), **kw)


@pytest.mark.parametrize("form", FORMS, ids=[f"G{g}R{r}" for g, r in FORMS])
def test_ring_at_the_edge_of_its_reach(lib, form):
    # the widest band each form reaches, on pairs longer than the band, one
    # side far longer, lengths no multiple of kR; one past it the form is
    # refused (and past G = 32, kR = 8 the rule gives the masked sweep)
    G, kR = form
    bw = (reach(G, kR) - 1) // 2
    rng = np.random.default_rng([G, kR])
    L = 2 * bw + 37
    lens = [(L, L), (L - kR - 1, L), (L, 9), (11, L), (L - 3, L - 50)]
    case = ragged(rng, len(lens), L, L, 4, 1)
    for b, (ql, rl) in enumerate(lens):
        case["qlen"][b], case["rlen"][b] = ql, rl
        case["qidx"][b, :ql] = rng.integers(0, 4, size=ql)
        case["qidx"][b, ql:] = -1
        case["ridx"][b, :rl] = rng.integers(0, 4, size=rl)
    for mode, free in (MODES[0], MODES[4], MODES[-1]):
        kw = dict(open_=3, ext=1, mode=mode, free=free, bw=bw)
        got = run_ring(lib, case, form=form, **kw)
        want = run_thread(lib, case, **kw)
        np.testing.assert_array_equal(got, want, err_msg=f"{mode} {free}")
        assert run_ring(lib, case, form=form, **dict(kw, bw=bw + 1)) is None
    assert_equals_plain(got, case, "sw", **kw)
    if form == (32, 8):
        assert plan(lib, 4, L, L, bw + 1) == (0, 0)


def test_ring_profile_form_and_shared_query(lib):
    # per-pair profile rows, one profile for every pair (Bq = 1), and a
    # table with one query row for every pair
    rng = np.random.default_rng(3)
    case = ragged(rng, 16, 60, 70, 6, 1)
    rows = rng.integers(-4, 6, size=(16, 60, 6)).astype(np.int32)
    shared = dict(case, qlen=np.full(16, case["qlen"][0], np.int32))
    cases = {"profile": {k: v for k, v in case.items()
                         if k not in ("table", "qidx")} | {"profile": rows},
             "shared profile": {k: v for k, v in shared.items()
                                if k not in ("table", "qidx")} |
             {"profile": rows[:1]},
             "shared query": shared | {"qidx": shared["qidx"][:1]}}
    for name, c in cases.items():
        for mode, free in (MODES[0], MODES[2], MODES[-1]):
            for bw in (2, 9, 30):
                kw = dict(open_=5, ext=2, mode=mode, free=free, bw=bw)
                want = run_thread(lib, c, **kw)
                for form in ((0, 0), (8, 4), (16, 5), (32, 8)):
                    got = run_ring(lib, c, form=form, **kw)
                    if got is None:
                        assert 2 * bw >= reach(*form)
                        continue
                    np.testing.assert_array_equal(
                        got, want, err_msg=f"{name} {mode} bw={bw} {form}")
                assert_equals_plain(want, c, name, **kw)


@pytest.mark.parametrize("mode,free", [MODES[i] for i in (1, 3, 5, 7)])
def test_ring_end_cell_tie_order(lib, mode, free):
    # two letters, a match of one scoring 3 and everything else -5: equal
    # maxima in many rows, blocks and lanes; the end cell is the first in
    # row-major order (H descending, then i, then j)
    rng = np.random.default_rng(7)
    case = ragged(rng, 32, 50, 50, 2, 10)
    case["table"] = np.array([[3, -5], [-5, -5]], np.int32)
    for bw in (2, 5, 12):
        kw = dict(open_=6, ext=6, mode=mode, free=free, bw=bw)
        want = run_thread(lib, case, **kw)
        assert len(set(want[0].tolist())) < len(want[0])   # tied scores
        for form in ((0, 0), (8, 4), (8, 6), (16, 4), (32, 5)):
            np.testing.assert_array_equal(
                run_ring(lib, case, form=form, **kw), want,
                err_msg=f"bw={bw} {form}")
        assert_equals_plain(want, case, f"bw={bw}", **kw)


@pytest.mark.parametrize("lens,want", STEP0, ids=[f"{q}x{r}"
                                                  for (q, r), _ in STEP0])
def test_ring_empty_side_and_unreachable_corner(lib, lens, want):
    # NW, DNA +2/-3, open 4, ext 1, bandwidth 2 (test_torch_banded.py's
    # cases): empty sides follow golden's banded oracle
    ql, rl = lens
    rng = np.random.default_rng(ql * 10 + rl)
    P = 16
    case = dict(table=DNA.data.astype(np.int32),
                qidx=np.full((1, P), -1, np.int32),
                ridx=np.zeros((1, P), np.int32),
                qlen=np.array([ql], np.int32), rlen=np.array([rl], np.int32))
    case["qidx"][0, :ql] = rng.integers(0, 4, size=ql)
    case["ridx"][0, :rl] = rng.integers(0, 4, size=rl)
    exp = oracle(case, 0, 4, 1, 2)
    if want != "oracle":
        assert exp == (NEG if want is None else want)
    for mode, free in MODES:
        kw = dict(open_=4, ext=1, mode=mode, free=free, bw=2)
        got = run_ring(lib, case, **kw)
        np.testing.assert_array_equal(got, run_thread(lib, case, **kw))
        assert_equals_plain(got, case, f"{mode} {free}", **kw)
        if mode == "nw":
            assert got[0, 0] == exp


@pytest.mark.parametrize("open_,ext", PENALTIES)
def test_ring_matches_golden_and_jax_wavefront(lib, open_, ext):
    # NW at bands 0 to wider than the pair: golden's scalar fill and the
    # JAX jitted wavefront (no empty side, where the JAX package gives
    # -2^30 against the oracle)
    rng = np.random.default_rng([open_, ext, 12])
    case = ragged(rng, 16, 16, 16, 5, 1)
    nw = MODES[0]
    for bw in (0, 1, 3, 8, 64):
        got = run_ring(lib, case, open_=open_, ext=ext, mode=nw[0],
                       free=nw[1], bw=bw)
        want = run_jax_wavefront(case, open_, ext, bw)
        for row, k in enumerate(("score", "end_query", "end_ref")):
            np.testing.assert_array_equal(got[row], want[k])
        np.testing.assert_array_equal(got[4] != 0, want["saturated"])
        for b in range(16):
            ql, rl = case["qlen"][b], case["rlen"][b]
            sub = case["table"][case["qidx"][b, :ql][:, None],
                                case["ridx"][b, :rl][None, :]]
            g = banded_nw_fill(sub.astype(np.int64), open_, ext, bw)
            assert got[0, b] == (NEG if g < -(10 ** 8) else g)


@pytest.mark.parametrize("mode_name,bw", [("nw", 2), ("nw", 5), ("sw", 2),
                                          ("sw", 5), ("sg_all", 2),
                                          ("sg_all", 5)])
def test_ring_matches_jax_on_the_seed3_batch(lib, mode_name, bw):
    # tests/test_scan_kernel.py's seed-3 batch (profile form, BLOSUM62,
    # 5/1): the JAX wavefront and Pallas kernel in interpret mode agree on
    # the score class in these modes (an SG pair with no candidate in the
    # band ends elsewhere in Pallas, ROADMAP Queue 3: the SG sets with one
    # end free are left out)
    from test_torch_banded_classes import MODES as CLASS_MODES

    mode, free = CLASS_MODES[mode_name]
    c = seed3_batch()
    case = {k: c[k] for k in ("profile", "ridx", "qlen", "rlen")}
    got = run_ring(lib, case, open_=5, ext=1, mode=mode, free=free, bw=bw)
    for route in ("wavefront", "pallas"):
        want = run_jax(route, "score", mode_name, bw)
        for row, k in enumerate(("score", "end_query", "end_ref")):
            np.testing.assert_array_equal(got[row], want[k], err_msg=route)
        np.testing.assert_array_equal(got[4] != 0, want["saturated"])
        np.testing.assert_array_equal(got[3] != 0, want["promoted"])


# -- the cells the ring's schedule sweeps -----------------------------------


def ring_schedule(qlens, rlens, Qp, Rp, bw, G, kR):
    """(lane rows the warps step through, the in-band cells of real rows
    the busy lanes visit) of a launch at form (G, kR), by stepping each
    pair's lanes as ``band_lane_iter`` does: block k on lane k mod G
    computes column s - k of its rows at step s over its band's columns,
    then the lane takes block k + G; a warp of 32 / G pairs steps until
    its longest pair's last block ends, each lane kR rows a step."""
    bw = min(max(bw, -1), Qp + Rp, max(Qp, Rp))
    steps, seen_all = [], 0
    for ql, rl in zip(qlens, rlens):
        kb, last, seen, s = list(range(G)), -1, set(), 0

        def span(k):
            return max(0, k * kR - bw), min(rl - 1, k * kR + kR - 1 + bw)

        def live(k):
            lo, hi = span(k)
            return bw >= 0 and rl > 0 and k * kR < ql and lo <= hi

        while any(live(k) for k in kb):
            for gl in range(G):
                k = kb[gl]
                if not live(k):
                    continue
                lo, hi = span(k)
                c = s - k
                if lo <= c <= hi:
                    last = s
                    seen.update((i, c) for i in range(k * kR, min(ql, k * kR
                                                                  + kR))
                                if abs(i - c) <= bw)
                    if c == hi:
                        kb[gl] += G
            s += 1
        steps.append(last + 1)
        seen_all += len(seen)
    per = 32 // G
    warp = [max(steps[w:w + per]) for w in range(0, len(steps), per)]
    return G * kR * sum(warp[b // per] for b in range(len(steps))), seen_all


def _lengths(rng, B, Qp, Rp):
    """Ragged lengths up to the padded sizes, with an empty side and a
    pair whose corner lies far off the diagonal."""
    ql = rng.integers(1, Qp + 1, B)
    rl = rng.integers(1, Rp + 1, B)
    ql[0], rl[1 % B] = 0, Rp
    ql[1 % B] = 1
    return ql, rl


SWEPT_SHAPES = [(5, 64, 64, 3), (9, 48, 80, 10), (3, 96, 64, 30),
                (40, 32, 32, 2), (17, 64, 128, 0), (6, 40, 24, 200)]


@pytest.mark.parametrize("B,Qp,Rp,bw", SWEPT_SHAPES,
                         ids=[f"{b}x{q}x{r}bw{w}" for b, q, r, w in
                              SWEPT_SHAPES])
def test_band_swept_at_the_rules_form(lib, B, Qp, Rp, bw):
    rng = np.random.default_rng([B, Qp, Rp, bw])
    ql, rl = _lengths(rng, B, Qp, Rp)
    form = plan(lib, B, Qp, Rp, bw, A=4)
    assert form[0]
    slots, seen = ring_schedule(ql, rl, Qp, Rp, bw, *form)
    assert tk.band_swept(ql, rl, Qp, Rp, bw, form) == slots
    # the schedule visits every in-band cell, each once
    band = sum(int((np.abs(np.subtract.outer(np.arange(q), np.arange(r)))
                    <= bw).sum()) for q, r in zip(ql, rl))
    assert tk.band_cells(ql, rl, bw) == seen == band
    assert slots >= band
    assert tk.band_swept(ql, rl, Qp, Rp, bw, (0, 0)) == B * Qp * Rp


@pytest.mark.parametrize("form", FORMS, ids=[f"G{g}R{r}" for g, r in FORMS])
def test_band_swept_at_every_form(form):
    # the widest band each form reaches; several pairs a warp below G 32
    G, kR = form
    bw = (reach(G, kR) - 1) // 2
    rng = np.random.default_rng([G, kR])
    ql, rl = _lengths(rng, 11, 3 * bw, 3 * bw + 7)
    slots, seen = ring_schedule(ql, rl, 3 * bw, 3 * bw + 7, bw, G, kR)
    assert tk.band_swept(ql, rl, 3 * bw, 3 * bw + 7, bw, form) == slots
    assert tk.band_cells(ql, rl, bw) == seen


def test_band_swept_at_the_cells_shape(lib):
    # 1,024 pairs of 10 kbp at bw 100: G 32, kR 6 (219 > 200); a lane is
    # busy 206 of every 224 steps, so the band fills under 201 / 224
    assert plan(lib, 1024, 12288, 12288, 100, A=4) == (32, 6)
    ql = np.full(1024, 10000)
    rl = 10000 + np.random.default_rng(5).integers(-74, 75, 1024)
    swept = tk.band_swept(ql, rl, 12288, 12288, 100, (32, 6))
    share = tk.band_cells(ql, rl, 100) / swept
    assert 0.85 < share < 201 / 224


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def card_case(case, dev):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in case.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS + [None, (0, 0)],
                         ids=[f"G{g}R{r}" for g, r in FORMS] +
                         ["rule", "one-thread"])
def test_ring_kernel_matches_plain_on_card(form, cuda_device):
    # every form at the edge of its reach, the rule's, and (0, 0), which
    # forces the masked full sweep; each launch moves its own counter
    rng = np.random.default_rng(len(str(form)))
    G, kR = form if form else (32, 8)
    bw = (reach(G, kR) - 1) // 2 if G else 40
    L = 2 * bw + 21
    case = card_case(ragged(rng, 200, L, L + 5, 5, 0), cuda_device)
    try:
        tk._BAND_FORM = form
        for n, (mode, free) in enumerate(MODES):
            open_, ext = PENALTIES[n % 3]
            for b in (bw, n % 5 - 1, 2 * bw // 3):
                kw = dict(open_=open_, ext=ext, mode=mode, free=free,
                          width="sat", table=case["table"],
                          qidx=case["qidx"], banded=True, bandwidth=b)
                args = (case["ridx"], case["qlen"], case["rlen"])
                before = (tk.BANDED_WARP_LAUNCHES,
                          tk.BANDED_CLASS_LAUNCHES["score"])
                if form and form[0] and 2 * min(b, L + 5) >= reach(*form):
                    continue
                got = tk.score_align(*args, **kw)
                want = tk.score_align_plain(*args, **kw)
                torch.cuda.synchronize()
                warp = form[0] if form else tk.band_plan(200, L, L + 5, 5,
                                                         b)[0]
                assert (tk.BANDED_WARP_LAUNCHES - before[0],
                        tk.BANDED_CLASS_LAUNCHES["score"] - before[1]) == \
                    ((1, 0) if warp else (0, 1))
                for k in got:
                    assert torch.equal(got[k], want[k]), (mode, free, b, k)
    finally:
        tk._BAND_FORM = None


@pytest.mark.cuda
def test_ring_kernel_profile_and_past_reach_on_card(cuda_device):
    # profile rows, per pair and shared; a band past the ring's reach on
    # long pairs takes the masked full sweep, there the block kernel's
    # (Qp 400)
    rng = np.random.default_rng(9)
    case = ragged(rng, 300, 400, 420, 6, 0)
    t = card_case(case, cuda_device)
    rows = torch.from_numpy(rng.integers(-4, 6, size=(300, 400, 6)).astype(
        np.int32)).to(cuda_device)
    args = (t["ridx"], t["qlen"], t["rlen"])
    for subs in ({"profile": rows}, {"profile": rows[:1]},
                 {"table": t["table"], "qidx": t["qidx"]}):
        for bw, warp in ((16, 1), (100, 1), (141, 0), (300, 0)):
            kw = dict(open_=5, ext=2, mode="sg", free=(True, False, False,
                                                       True),
                      width="sat", banded=True, bandwidth=bw, **subs)
            before = (tk.BANDED_WARP_LAUNCHES,
                      tk.BANDED_CLASS_LAUNCHES["score"],
                      tk.BANDED_FORM_LAUNCHES["block"])
            got = tk.score_align(*args, **kw)
            want = tk.score_align_plain(*args, **kw)
            torch.cuda.synchronize()
            assert (tk.BANDED_WARP_LAUNCHES - before[0],
                    tk.BANDED_CLASS_LAUNCHES["score"] - before[1],
                    tk.BANDED_FORM_LAUNCHES["block"] - before[2]) == \
                (warp, 1 - warp, 1 - warp)
            for k in got:
                assert torch.equal(got[k], want[k]), (bw, k)
