"""The banded mode (kernel K1e) in every output class and mode against
the plain version and the JAX package.

``csrc/score_cell.cuh``'s banded forms, built with g++ through
``csrc/score_host.cc`` (``pt_banded_host``: the score form's
band-only sweep and the other six classes' masked full sweep), must
equal the port's plain version (the wavefront with ``banded=True``) in
every output, flag cell, plane cell, row and column, under NW, SG free
sets and SW, at bands from -1 to wider than the pair, open > ext,
open == ext and open < ext, and widths sat and 32; the traceback walk
of their flag planes must equal the plain walk, end cells outside the
plane included.

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
with their inputs, and the port follows the wavefront.  Every
comparison is exact: the outputs are integers.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402
from parasail_rs_tpu_torch.ops import trace_walk as tw  # noqa: E402

from test_torch_kernel_host import (  # noqa: E402
    build_host_lib,
    ragged,
    run_host_walk,
    run_outputs_host,
)

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
    return build_host_lib(tmp_path_factory)


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


@pytest.mark.parametrize("outputs,bw", sorted(JAX_CASES))
def test_plain_and_host_match_jax_pallas_interpret(host_lib, outputs, bw):
    mode_name = JAX_CASES[(outputs, bw)]
    mode, free = MODES[mode_name]
    c = seed3_batch()
    got = run_port(outputs, mode_name, bw)
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
