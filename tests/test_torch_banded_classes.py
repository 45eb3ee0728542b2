"""The banded mode (kernel K1e) in every output class and mode against
the plain version, golden and the JAX package.

``csrc/score_cell.cuh``'s banded forms, built with g++ through
``csrc/score_host.cc`` (``pt_banded_host``: ``score_pair``'s score form's
band-only sweep and the other six classes' masked full sweep), must
equal the port's plain version (the wavefront with ``banded=True``) in
every output, flag cell, plane cell, row and column, under NW, SG free
sets and SW, at bands from -1 to wider than the pair, open > ext,
open == ext and open < ext, and widths sat and 32; the traceback walk
of their flag planes must equal the plain walk, end cells outside the
plane included.

The card runs that masked sweep (every banded launch the ring does not
take) on the short form and the block kernel.  Their own code, built
with ``-DPT_HOST_BANDED``, the short form's warp
(``pt_short_banded_host``: ``short_pair_host`` with kBanded, what
``csrc/scan_short_banded.cu`` runs) and the block kernel's lanes
(``pt_chunked_banded_host``: ``segment_pair_host`` with kBanded, what
``csrc/scan_chunked_banded.cu`` runs, one segment of all columns from
column 0) stepped in a loop at given forms, must equal the plain version
in every output and cell inside and outside the band: every class x NW,
each of the nine SG free-end sets and SW, at bands -1, 0, 2, 5 and 16,
rows a lane 4-8 (the short form; both payload layouts) and 2-8 on one to
three warps (the block kernel), empty sides and unreachable corners, and
pairs past 256 query rows, which the short form does not take; NW scores
also golden's banded oracle (``banded_nw_fill``).

Against the JAX ``scan_score_align(banded=True)`` in interpret mode, on
``tests/test_scan_kernel.py``'s seed-3 batch (one 128-lane tile, Qp = Rp
= 24, BLOSUM62, open 5, ext 1), the port is held where the JAX package
agrees with itself: scores, saturation flags and stats, the end cells of
reachable pairs, every score plane cell, row and column, the stats
payloads inside the band, and the walked opcodes and begin cells of
every reachable pair.  Where the JAX package's wavefront and its Pallas
kernel disagree (flags and payloads outside the band, flags of gap
states at -2^30 on the band's edge, the end cell of an SG pair with no
candidate in the band; ROADMAP Queue 3), the differences are asserted
with their inputs, and the port follows the wavefront; both masked forms
are held there to the plain version, to the Pallas kernel where the
package agrees with itself and to its wavefront.  Every comparison is
exact: the outputs are integers.
"""

import ctypes
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu.golden import banded_nw_fill  # noqa: E402

from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402
from parasail_rs_tpu_torch.ops import trace_walk as tw  # noqa: E402

from test_torch_chunked_host import run_host_chunked  # noqa: E402
from test_torch_kernel_host import (  # noqa: E402
    build_host_lib,
    ragged,
    run_host_walk,
    run_outputs_host,
)
from test_torch_short_host import run_short  # noqa: E402

NEG = -(1 << 30)
NW = ("nw", (False,) * 4)
SW = ("sw", (True,) * 4)
SG_ALL = ("sg", (True,) * 4)
SG_QB_DE = ("sg", (True, False, False, True))
SG_QE_DB = ("sg", (False, True, True, False))
MODES = {"nw": NW, "sg_qb_de": SG_QB_DE, "sg_all": SG_ALL,
         "sg_qe_db": SG_QE_DB, "sw": SW}
# bands from none to wider than the pairs (Qp 20, Rp 22)
BANDS = (-1, 0, 1, 3, 8, 64)
PENALTIES = ((4, 1), (2, 2), (1, 3))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    # with the masked forms' twins, and their entry points declared
    lib = build_host_lib(tmp_path_factory, banded=True)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pt_short_banded_host.restype = i
    lib.pt_short_banded_host.argtypes = [i] + [p] * 11 + [i] * 13
    lib.pt_chunked_banded_host.restype = i
    lib.pt_chunked_banded_host.argtypes = [i] + [p] * 11 + [i] * 14
    lib.pt_short_plan_host.restype = i
    lib.pt_short_plan_host.argtypes = [i] * 7 + [p]
    lib.pt_block_plan_host.restype = i
    lib.pt_block_plan_host.argtypes = [i] * 9 + [p]
    return lib


def plain(case, outputs, **kw):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         case.items()}
    out = tk.score_align(t.pop("ridx"), t.pop("qlen"), t.pop("rlen"),
                         outputs=outputs, banded=True, **kw, **t)
    return {k: v.numpy() for k, v in out.items()}


def walk(plane, case, end_q, end_r, mode, free):
    ops, bq, br = tw.device_walk_plain(
        *(torch.from_numpy(np.array(a)) for a in (
            plane, case["qidx"], case["ridx"], end_q, end_r)), mode, free)
    return ops.numpy(), bq.numpy(), br.numpy()


CLASS_MODES = [(cls, m) for cls in tk.OUTPUTS for m in MODES]


@pytest.mark.parametrize("outputs,mode_name", CLASS_MODES)
def test_host_banded_class_matches_plain(host_lib, outputs, mode_name):
    n = CLASS_MODES.index((outputs, mode_name))
    mode, free = MODES[mode_name]
    open_, ext = PENALTIES[n % 3]
    width = ("sat", "32")[n % 2]
    rng = np.random.default_rng([n, 8])
    case = ragged(rng, 24, 20, 22, 5, 0)     # empty sides included
    if n % 4 == 0:
        # scores beyond int8, so that cells in the band saturate too
        case["table"] = rng.integers(-300, 400, size=(5, 5)).astype(np.int32)
    reached = []
    for bw in BANDS:
        kw = dict(open_=open_, ext=ext, mode=mode, free=free, width=width,
                  bandwidth=bw)
        want = plain(case, outputs, **kw)
        got = run_outputs_host(host_lib, outputs, **case, **kw)
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"bw={bw} {k}")
        if outputs == "trace":
            # the walk of the kernel's plane, from every end cell (an SG
            # pair with no candidate in the band ends at (Qp, Rp))
            h_ops, h_beg = run_host_walk(
                host_lib, got["trace_table"], case["qidx"], case["ridx"],
                got["end_query"], got["end_ref"], mode, free)
            p_ops, p_bq, p_br = walk(want["trace_table"], case,
                                     want["end_query"], want["end_ref"],
                                     mode, free)
            np.testing.assert_array_equal(h_ops, p_ops, err_msg=f"bw={bw}")
            np.testing.assert_array_equal(h_beg, np.stack([p_bq, p_br]))
        reached.append(want["score"] > NEG)
    if mode != "sw":
        # the band cut some corners or end rows and left others
        assert not np.all(reached) and np.any(reached)


# -- the JAX package on tests/test_scan_kernel.py's seed-3 batch --------------

OPEN, EXT = 5, 1
# (class, bw) -> mode: every class at both bands, every mode three or four
# times, and the configurations of the JAX package's own disagreements
JAX_CASES = {
    ("score", 2): "sg_qb_de", ("score", 5): "sg_qb_de",
    ("trace", 2): "sw", ("trace", 5): "sg_all",
    ("stats", 2): "nw", ("stats", 5): "sw",
    ("table", 2): "sg_all", ("table", 5): "nw",
    ("stats_table", 2): "sw", ("stats_table", 5): "sg_qb_de",
    ("rowcol", 2): "sg_qb_de", ("rowcol", 5): "sw",
    ("stats_rowcol", 2): "sg_all", ("stats_rowcol", 5): "nw",
}


@functools.lru_cache(maxsize=None)
def seed3_batch() -> dict:
    from test_scan_kernel import _random_batch

    b = _random_batch(seed=3, n=128, maxlen=20)
    return {k: np.asarray(getattr(b, k), np.int32)
            for k in ("profile", "qidx", "ridx", "qlen", "rlen")}


@functools.lru_cache(maxsize=None)
def run_jax(route, outputs, mode_name, bw) -> dict:
    """The JAX package's banded outputs on the seed-3 batch: ``route``
    "wavefront" (jitted XLA) or "pallas" (interpret mode)."""
    mode, free = MODES[mode_name]
    c = seed3_batch()
    kw = dict(open_=np.int32(OPEN), ext=np.int32(EXT), mode=mode, free=free,
              width="sat", outputs=outputs, banded=True,
              bandwidth=np.int32(bw))
    if route == "pallas":
        from parasail_rs_tpu.ops.scan_kernel import scan_score_align

        out = scan_score_align(c["profile"], c["ridx"], c["qlen"], c["rlen"],
                               c["qidx"], interpret=True, **kw)
    else:
        from parasail_rs_tpu.ops.wavefront import wavefront_align

        out = wavefront_align(c["profile"], c["qidx"], c["ridx"], c["qlen"],
                              c["rlen"], **kw)
    return {k: np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def run_port(outputs, mode_name, bw) -> dict:
    mode, free = MODES[mode_name]
    return plain(seed3_batch(), outputs, open_=OPEN, ext=EXT, mode=mode,
                 free=free, width="sat", bandwidth=bw)


def seed3_masks(bw):
    """(in-sequence cells, cells of the band) of the seed-3 batch."""
    c = seed3_batch()
    B, Qp = c["qidx"].shape
    Rp = c["ridx"].shape[1]
    i = np.arange(Qp)[None, :, None]
    j = np.arange(Rp)[None, None, :]
    inseq = (i < c["qlen"][:, None, None]) & (j < c["rlen"][:, None, None])
    return inseq, np.broadcast_to(np.abs(i - j) <= bw, inseq.shape)


def assert_agrees_with_pallas(got, outputs, mode_name, bw):
    """``got``, the port's outputs on the seed-3 batch, against the JAX
    Pallas kernel in interpret mode where the JAX package agrees with
    itself: the scalars, the end cells of reachable pairs, every score
    plane cell, row and column, the payloads inside the band, and the
    walk of the trace plane from every reachable pair's end."""
    mode, free = MODES[mode_name]
    c = seed3_batch()
    want = run_jax("pallas", outputs, mode_name, bw)
    assert set(got) == set(want)
    reach = got["score"] > NEG
    inseq, band = seed3_masks(bw)
    pairs = np.arange(len(reach))
    views = {  # a (B, Qp, Rp) mask's cells of the planes, last rows, columns
        "table": lambda m: m,
        "row": lambda m: m[pairs, c["qlen"] - 1],
        "col": lambda m: m[pairs, :, c["rlen"] - 1],
    }
    for k in want:
        if k == "trace_table":
            continue                 # compared through the walk below
        if k in ("end_query", "end_ref"):
            keep = reach
        elif k.rsplit("_", 1)[-1] in views:
            view = views[k.rsplit("_", 1)[-1]]
            keep = view(inseq)
            if not k.startswith("score"):
                keep = keep & view(band)      # payloads: inside the band
        else:
            keep = np.ones(want[k].shape, bool)
        np.testing.assert_array_equal(got[k][keep], want[k][keep],
                                      err_msg=k)
    if outputs == "trace":
        p_ops, p_bq, p_br = walk(want["trace_table"], c, got["end_query"],
                                 got["end_ref"], mode, free)
        ops, bq, br = walk(got["trace_table"], c, got["end_query"],
                           got["end_ref"], mode, free)
        np.testing.assert_array_equal(ops[reach], p_ops[reach])
        np.testing.assert_array_equal(bq[reach], p_bq[reach])
        np.testing.assert_array_equal(br[reach], p_br[reach])


@pytest.mark.parametrize("outputs,bw", sorted(JAX_CASES))
def test_plain_and_host_match_jax_pallas_interpret(host_lib, outputs, bw):
    mode_name = JAX_CASES[(outputs, bw)]
    mode, free = MODES[mode_name]
    c = seed3_batch()
    got = run_port(outputs, mode_name, bw)
    assert_agrees_with_pallas(got, outputs, mode_name, bw)
    # the kernel's own forms, through g++, equal the plain version
    host = run_outputs_host(host_lib, outputs, ridx=c["ridx"],
                            qlen=c["qlen"], rlen=c["rlen"], open_=OPEN,
                            ext=EXT, mode=mode, free=free, qidx=c["qidx"],
                            profile=c["profile"], bandwidth=bw)
    assert set(host) == set(got)
    for k in got:
        np.testing.assert_array_equal(host[k], got[k], err_msg=k)


def test_jax_package_disagrees_with_itself():
    """ROADMAP Queue 3: the JAX package's banded wavefront and Pallas
    kernel differ on the seed-3 batch (open 5, ext 1); the port equals
    the wavefront on every in-sequence cell."""
    c = seed3_batch()

    def differ(outputs, mode_name, bw, key):
        w = run_jax("wavefront", outputs, mode_name, bw)[key]
        p = run_jax("pallas", outputs, mode_name, bw)[key]
        port = run_port(outputs, mode_name, bw)[key]
        inseq, band = seed3_masks(bw)
        if w.ndim == 3:
            assert np.array_equal(port[inseq], w[inseq]), key
            d = (w != p) & inseq
            return int((d & ~band).sum()), int((d & band).sum())
        assert np.array_equal(port, w), key
        return np.flatnonzero(w != p)

    # SW, bw 2: flags of 1,034 in-sequence cells outside the band and of
    # 229 inside it; payloads of 231 cells outside it, none inside
    assert differ("trace", "sw", 2, "trace_table") == (1034, 229)
    for k in ("matches_table", "similar_table", "length_table"):
        assert differ("stats_table", "sw", 2, k) == (231, 0), k
    # an in-band flag at the band's edge: pair 0, cell (6, 8)
    w = run_jax("wavefront", "trace", "sw", 2)["trace_table"][0, 6, 8]
    p = run_jax("pallas", "trace", "sw", 2)["trace_table"][0, 6, 8]
    assert (w, p, run_port("trace", "sw", 2)["trace_table"][0, 6, 8]) == \
        (82, 74, 82)
    # SG (qb, de free): every end candidate outside the band -> -2^30,
    # ending at (Qp, Rp) = (24, 24) in the wavefront and the port, at
    # (24, 2^30) in Pallas; 51 pairs at bw 2 (pair 5: qlen 4, rlen 18),
    # 37 at bw 5
    for bw, n in ((2, 51), (5, 37)):
        pairs = differ("score", "sg_qb_de", bw, "end_ref")
        port = run_port("score", "sg_qb_de", bw)
        pallas = run_jax("pallas", "score", "sg_qb_de", bw)
        assert len(pairs) == n and 5 in pairs
        assert (port["score"][pairs] == NEG).all()
        assert (port["end_query"][pairs] == 24).all()
        assert (port["end_ref"][pairs] == 24).all()
        assert (pallas["end_query"][pairs] == 24).all()
        assert (pallas["end_ref"][pairs] == 1 << 30).all()
        assert len(differ("score", "sg_qb_de", bw, "end_query")) == 0
    assert (c["qlen"][5], c["rlen"][5]) == (4, 18)



# -- the masked forms of the short form and the block kernel ------------------

SG_FREE = [(True, False, False, False), (False, True, False, False),
           (True, True, False, False), (False, False, True, False),
           (False, False, False, True), (False, False, True, True),
           (True, False, False, True), (False, True, True, False),
           (True, True, True, True)]
# NW, the nine SG free-end sets one by one, SW
MASK_MODES = ([NW] + [("sg", f) for f in SG_FREE] + [SW])
MASK_BANDS = (-1, 0, 2, 5, 16)
# the block kernel's forms: (rows a lane, warps a block)
BLOCK_FORMS = ((2, 1), (4, 2), (8, 3))


def assert_same(got, want, what):
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def short_rule(lib, outputs, case):
    """(rows a lane, pairs a block, layout) of the short form's rule for
    a table case (rows 0: the block kernel takes it)."""
    plan = np.zeros(3, np.int32)
    B, Rp = case["ridx"].shape
    lib.pt_short_plan_host(tk.OUTPUTS.index(outputs), B, 1,
                           case["qidx"].shape[1], Rp,
                           case["table"].shape[0], 0, plan.ctypes.data)
    return tuple(int(x) for x in plan)


def block_rule(lib, outputs, case):
    """(rows a lane, warps, cluster) of the block kernel's rule."""
    plan = np.zeros(3, np.int32)
    B, Rp = case["ridx"].shape
    lib.pt_block_plan_host(tk.OUTPUTS.index(outputs), B,
                           case["qidx"].shape[1], Rp,
                           case["table"].shape[0], 0, 0, 0, 0,
                           plan.ctypes.data)
    return tuple(int(x) for x in plan)


def oracle(case, b, open_, ext, bw):
    """golden's banded NW score of pair b (its sentinel as -2^30)."""
    ql, rl = case["qlen"][b], case["rlen"][b]
    sub = case["table"][case["qidx"][b, :ql][:, None],
                        case["ridx"][b, :rl][None, :]]
    want = banded_nw_fill(sub.astype(np.int64), open_, ext, bw)
    return NEG if want < -(10 ** 8) else want


MASK_CASES = [(cls, m) for cls in tk.OUTPUTS for m in range(len(MASK_MODES))]


@pytest.mark.parametrize("outputs,m", MASK_CASES,
                         ids=[f"{c}-{MASK_MODES[m][0]}{m}"
                              for c, m in MASK_CASES])
def test_masked_forms_match_plain(host_lib, outputs, m):
    # 8 pairs of 0-20 x 0-22 letters (empty sides included), every band;
    # the short form at 4, 5, 6 and 8 rows a lane and both payload
    # layouts in turn, the block kernel at 2-8 rows on one to three warps
    n = MASK_CASES.index((outputs, m))
    mode, free = MASK_MODES[m]
    open_, ext = PENALTIES[n % 3]
    rng = np.random.default_rng([n, 14])
    case = ragged(rng, 8, 20, 22, 5, 0)
    if n % 4 == 0:
        # scores beyond int8, so that cells in the band saturate too
        case["table"] = rng.integers(-300, 400, size=(5, 5)).astype(np.int32)
    rows = (4, 5, 6, 8)[n % 4]
    layout = 1 + n % 2
    lane, warps = BLOCK_FORMS[n % 3]
    assert short_rule(host_lib, outputs, case)[0] == 4   # the short form's
    kw = dict(open_=open_, ext=ext, mode=mode, free=free)
    band_kw = dict(kw, width="sat")
    reached = []
    for bw in MASK_BANDS:
        want = plain(case, outputs, bandwidth=bw, **band_kw)
        got = run_short(host_lib, case, outputs, width="sat", rows=rows,
                        layout=layout, bandwidth=bw, **kw)
        assert_same(got, want, f"short R{rows} L{layout} bw {bw}")
        got = run_host_chunked(host_lib, case, outputs=outputs, warps=warps,
                               rows=lane, bandwidth=bw, **kw)
        assert_same(got, want, f"block R{lane} W{warps} bw {bw}")
        if mode == "nw" and outputs == "score":
            np.testing.assert_array_equal(
                want["score"], [oracle(case, b, open_, ext, bw)
                                for b in range(8)], err_msg=f"bw {bw}")
        reached.append(want["score"] > NEG)
    if mode != "sw":
        # the bands cut some corners or end rows and left others
        assert not np.all(reached) and np.any(reached)


@pytest.mark.parametrize("outputs", tk.OUTPUTS)
def test_block_form_past_the_short_form(host_lib, outputs):
    # 4 pairs of up to 300 x 40 letters: past 256 query rows the short
    # form does not take the batch, and the block kernel's masked form at
    # its rule's rows and warps (several warps, groups of rows handing
    # their last row down) equals the plain version
    n = tk.OUTPUTS.index(outputs)
    rng = np.random.default_rng([n, 300])
    case = ragged(rng, 4, 300, 40, 5, 0)
    case["qlen"][:2] = (300, 260)
    case["rlen"][:2] = (40, 37)
    assert short_rule(host_lib, outputs, case)[0] == 0
    lane, warps, cluster = block_rule(host_lib, outputs, case)
    assert warps > 1
    for k, bw in enumerate((5, 64)):
        mode, free = MASK_MODES[(n + 5 * k) % len(MASK_MODES)]
        kw = dict(open_=4, ext=1, mode=mode, free=free)
        want = plain(case, outputs, bandwidth=bw, width="sat", **kw)
        got = run_host_chunked(host_lib, case, outputs=outputs, warps=warps,
                               rows=lane, cluster=cluster, bandwidth=bw,
                               **kw)
        assert_same(got, want, f"R{lane} W{warps} C{cluster} bw {bw}")


# the empty-side and unreachable-corner pairs of ROADMAP Queue 3: (qlen,
# rlen) at bw 2, NW, identity DNA +2/-3, open 4, ext 1
CORNERS = ((0, 5), (5, 0), (0, 2), (2, 0), (3, 9), (6, 6), (0, 0))


@pytest.mark.parametrize("outputs", tk.OUTPUTS)
def test_masked_forms_empty_sides_and_corners(host_lib, outputs):
    P = 16
    rng = np.random.default_rng(9)
    table = np.where(np.eye(4, dtype=bool), 2, -3).astype(np.int32)
    case = dict(table=table,
                qidx=np.full((len(CORNERS), P), -1, np.int32),
                ridx=np.zeros((len(CORNERS), P), np.int32),
                qlen=np.array([q for q, _ in CORNERS], np.int32),
                rlen=np.array([r for _, r in CORNERS], np.int32))
    for b, (ql, rl) in enumerate(CORNERS):
        case["qidx"][b, :ql] = rng.integers(0, 4, size=ql)
        case["ridx"][b, :rl] = rng.integers(0, 4, size=rl)
    for mode, free in MASK_MODES[:1] + MASK_MODES[1::4] + MASK_MODES[-1:]:
        kw = dict(open_=4, ext=1, mode=mode, free=free)
        want = plain(case, outputs, bandwidth=2, width="sat", **kw)
        assert_same(run_short(host_lib, case, outputs, width="sat",
                              bandwidth=2, **kw), want, f"short {mode}")
        assert_same(run_host_chunked(host_lib, case, outputs=outputs,
                                     warps=1, rows=4, bandwidth=2, **kw),
                    want, f"block {mode}")
        if mode == "nw":
            assert list(want["score"]) == [
                oracle(case, b, 4, 1, 2) for b in range(len(CORNERS))]
            # (0, 2): the all-gap border inside the band, golden's -5
            assert want["score"][2] == -5 and want["score"][0] == NEG


def run_masked_seed3(lib, outputs, mode_name, bw):
    """Both masked forms' twins on the seed-3 batch (profile rows a pair,
    letters for the stats classes), at their rules' forms and at one
    warp of 4 rows: (form, outputs) pairs."""
    mode, free = MODES[mode_name]
    c = seed3_batch()
    kw = dict(open_=OPEN, ext=EXT, mode=mode, free=free, bandwidth=bw)
    return (("short", run_short(lib, c, outputs, width="sat", **kw)),
            ("block", run_host_chunked(lib, dict(c, table=None),
                                       outputs=outputs, warps=1, rows=4,
                                       profile=c["profile"], **kw)))


@pytest.mark.parametrize("outputs,bw", sorted(JAX_CASES))
def test_masked_forms_match_jax_pallas_interpret(host_lib, outputs, bw):
    # the masked forms equal the plain version on every output and cell,
    # and the JAX Pallas kernel where the JAX package agrees with itself
    mode_name = JAX_CASES[(outputs, bw)]
    want = run_port(outputs, mode_name, bw)
    for form, got in run_masked_seed3(host_lib, outputs, mode_name, bw):
        assert_same(got, want, form)
        assert_agrees_with_pallas(got, outputs, mode_name, bw)


# the inputs of the JAX package's own disagreements (ROADMAP Queue 3)
WAVEFRONT_CASES = (("trace", "sw", 2), ("stats_table", "sw", 2),
                   ("score", "sg_qb_de", 2), ("score", "sg_qb_de", 5))


@pytest.mark.parametrize("outputs,mode_name,bw", WAVEFRONT_CASES)
def test_masked_forms_match_jax_wavefront(host_lib, outputs, mode_name, bw):
    # where the JAX package's wavefront and Pallas kernel disagree, the
    # masked forms give the wavefront's scalars and in-sequence cells
    want = run_jax("wavefront", outputs, mode_name, bw)
    inseq, _ = seed3_masks(bw)
    for form, got in run_masked_seed3(host_lib, outputs, mode_name, bw):
        assert set(got) == set(want), form
        for k in want:
            keep = inseq if want[k].ndim == 3 else np.ones(want[k].shape,
                                                          bool)
            np.testing.assert_array_equal(got[k][keep], want[k][keep],
                                          err_msg=f"{form} {k}")
