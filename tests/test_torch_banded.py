"""The banded score form (kernel K1e) and ``banded_nw`` against the JAX
package and golden's scalar banded oracle.

``csrc/score_cell.cuh``'s banded form, built with g++ through
``csrc/score_host.cc`` (``pt_banded_host``), and the port's plain version
(the wavefront with ``banded=True``) must equal ``golden.banded_nw_fill``
wherever that oracle is finite, give exactly -2^30 where its corner is
unreachable (the oracle's own sentinel is -10^9), and equal each other in
every output, saturation flags included, at bands from 0 to wider than
the pair, at open > ext, open == ext and open < ext.  On pairs with no
empty side both must also equal the JAX package's jitted wavefront and
its Pallas kernel in interpret mode; on an empty side the JAX package
gives -2^30 even where the oracle is finite (ROADMAP Queue 3), and the
port follows the oracle.  ``banded_nw`` / ``banded_nw_batch`` are held to
the JAX ``Aligner`` on its own tests' cases.  Every comparison is exact.
The other classes and modes of the banded mode are in
``test_torch_banded_classes.py``; on the card (tests marked ``cuda``)
every class in every mode is held to the plain version here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parasail_rs_tpu as ref  # noqa: E402
from parasail_rs_tpu.golden import banded_nw_fill  # noqa: E402

import parasail_rs_tpu_torch as port  # noqa: E402
from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402
from parasail_rs_tpu_torch.ops import trace_walk as tw  # noqa: E402

from test_torch_engine import (  # noqa: E402
    _seqs,
    _summary,
    matrix_for,
    port_matrix,
)
from test_torch_kernel_host import build_host_lib, ragged  # noqa: E402

NEG = -(1 << 30)
BANDS = (0, 1, 3, 8, 64)
NW = dict(mode="nw", free=(False,) * 4)
DNA = ref.Matrix.create(b"ACGT", 2, -3)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory)


def run_banded_host(lib, case, open_, ext, bw):
    """pt_banded_host's NW score form on a table case: (5, B) score,
    end_query, end_ref, sat8, sat16."""
    B, Rp = case["ridx"].shape
    Bq, Qp = case["qidx"].shape
    out = np.zeros((8, B), np.int32)
    table, qidx, ridx, qlen, rlen = (
        np.ascontiguousarray(case[k], np.int32)
        for k in ("table", "qidx", "ridx", "qlen", "rlen"))
    rc = lib.pt_banded_host(
        0, table.ctypes.data, qidx.ctypes.data, None, ridx.ctypes.data,
        qlen.ctypes.data, rlen.ctypes.data, out.ctypes.data, None, None,
        None, None, B, Bq, 0, Qp, Rp, table.shape[0], open_, ext, 0, 0, bw)
    assert rc == 0
    return out[:5]


def run_plain(case, open_, ext, bw, width="sat"):
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    out = tk.score_align(t["ridx"], t["qlen"], t["rlen"], open_=open_,
                         ext=ext, width=width, table=t["table"],
                         qidx=t["qidx"], banded=True, bandwidth=bw, **NW)
    return {k: v.numpy() for k, v in out.items()}


def oracle(case, b, open_, ext, bw):
    """banded_nw_fill of pair b, its unreachable sentinel mapped to
    -2^30."""
    ql, rl = case["qlen"][b], case["rlen"][b]
    sub = case["table"][case["qidx"][b, :ql][:, None],
                        case["ridx"][b, :rl][None, :]]
    want = banded_nw_fill(sub.astype(np.int64), open_, ext, bw)
    return NEG if want < -(10 ** 8) else want


def assert_host_equals_plain(out, plain, what):
    for row, k in enumerate(("score", "end_query", "end_ref")):
        np.testing.assert_array_equal(out[row], plain[k], err_msg=what)
    np.testing.assert_array_equal(out[3] != 0, plain["promoted"],
                                  err_msg=what)
    np.testing.assert_array_equal(out[4] != 0, plain["saturated"],
                                  err_msg=what)


# (open, ext, table low, table high): open > ext, == and <, and scores
# beyond int8 so that in-band cells saturate too
PENALTIES = [(4, 1, -5, 7), (11, 1, -5, 7), (5, 2, -300, 400), (2, 2, -5, 7),
             (1, 3, -5, 7)]


@pytest.mark.parametrize("open_,ext,lo,hi", PENALTIES)
def test_host_banded_matches_oracle_and_plain(host_lib, open_, ext, lo, hi):
    rng = np.random.default_rng([open_, ext, hi])
    case = ragged(rng, 24, 20, 22, 5, 0)
    case["table"] = rng.integers(lo, hi, size=(5, 5)).astype(np.int32)
    scores = []
    for bw in BANDS:
        out = run_banded_host(host_lib, case, open_, ext, bw)
        assert_host_equals_plain(out, run_plain(case, open_, ext, bw),
                                 f"bw={bw}")
        want = [oracle(case, b, open_, ext, bw)
                for b in range(len(case["qlen"]))]
        np.testing.assert_array_equal(out[0], want, err_msg=f"bw={bw}")
        scores.append(out[0])
    # both kinds of corner occurred: reachable and unreachable
    assert (np.array(scores) == NEG).any() and (scores[-1] > NEG).all()


def test_host_banded_saturation_flags_in_closed_form(host_lib):
    # the plain version counts each in-sequence cell outside the band as
    # -2^30, so both flags are set exactly when the longer side exceeds
    # the band (scores stay small, so nothing in the band saturates)
    rng = np.random.default_rng(11)
    case = ragged(rng, 32, 12, 12, 4, 1)
    for bw in (0, 2, 5, 11, 12):
        out = run_banded_host(host_lib, case, 3, 1, bw)
        want = np.maximum(case["qlen"], case["rlen"]) - 1 > bw
        np.testing.assert_array_equal(out[3] != 0, want)
        np.testing.assert_array_equal(out[4] != 0, want)
        for width in ("8", "16", "32"):
            plain = run_plain(case, 3, 1, bw, width)
            np.testing.assert_array_equal(
                plain["saturated"], want if width != "32" else False)


def run_jax_wavefront(case, open_, ext, bw):
    from parasail_rs_tpu.ops.wavefront import wavefront_align

    rows = case["table"][np.clip(case["qidx"], 0, None)]
    rows = np.where((case["qidx"] >= 0)[..., None], rows, 0).astype(np.int32)
    out = wavefront_align(
        rows, case["qidx"], case["ridx"], case["qlen"], case["rlen"],
        open_=np.int32(open_), ext=np.int32(ext), outputs="score",
        width="sat", banded=True, bandwidth=np.int32(bw), **NW)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("open_,ext", [(4, 1), (2, 2), (1, 3)])
def test_host_banded_matches_jax_wavefront(host_lib, open_, ext):
    rng = np.random.default_rng([open_, ext, 5])
    case = ragged(rng, 16, 16, 16, 5, 1)
    for bw in BANDS:
        out = run_banded_host(host_lib, case, open_, ext, bw)
        want = run_jax_wavefront(case, open_, ext, bw)
        assert_host_equals_plain(out, want, f"bw={bw}")


@pytest.mark.parametrize("bw", [2, 7, 50])
def test_host_banded_matches_jax_pallas_interpret(host_lib, bw):
    # the reference's banded kernel (scan_kernel.py:1307-1308) in
    # interpret mode, as tests/test_scan_kernel.py runs it
    from parasail_rs_tpu.ops.scan_kernel import scan_score_align

    rng = np.random.default_rng(bw)
    case = ragged(rng, 128, 24, 24, 5, 1)     # one 128-lane tile
    rows = case["table"][np.clip(case["qidx"], 0, None)].astype(np.int32)
    got = scan_score_align(
        rows, case["ridx"], case["qlen"], case["rlen"], open_=np.int32(5),
        ext=np.int32(1), width="32", banded=True, bandwidth=np.int32(bw),
        interpret=True, **NW)
    out = run_banded_host(host_lib, case, 5, 1, bw)
    np.testing.assert_array_equal(out[0], np.asarray(got["score"]))
    np.testing.assert_array_equal(out[0], run_plain(case, 5, 1, bw)["score"])


# The empty-side fault (ROADMAP Queue 3): NW, identity DNA +2/-3, open 4,
# ext 1, bandwidth 2; (qlen, rlen) -> the score golden's banded oracle
# gives (None: its corner is unreachable, -2^30 in both packages).  The
# JAX package gives -2^30 on every empty side.
STEP0 = [((0, 5), None), ((5, 0), None), ((0, 2), -5), ((3, 9), None),
         ((6, 6), "oracle")]


@pytest.mark.parametrize("lens,want", STEP0, ids=[f"{q}x{r}"
                                                  for (q, r), _ in STEP0])
def test_empty_side_and_unreachable_corner(host_lib, lens, want):
    ql, rl = lens
    q, r = _seqs(ql * 10 + rl, b"ACGT", 2, 9, 10)
    q, r = q[:ql], r[:rl]
    P = 16
    case = dict(table=DNA.data.astype(np.int32),
                qidx=np.full((1, P), -1, np.int32),
                ridx=np.zeros((1, P), np.int32),
                qlen=np.array([ql], np.int32), rlen=np.array([rl], np.int32))
    case["qidx"][0, :ql] = DNA.encode(q)
    case["ridx"][0, :rl] = DNA.encode(r)
    exp = oracle(case, 0, 4, 1, 2)
    if want != "oracle":
        assert exp == (NEG if want is None else want)
    host = run_banded_host(host_lib, case, 4, 1, 2)
    plain = run_plain(case, 4, 1, 2)
    aligner = (port.Aligner.new().matrix(port_matrix(DNA)).gap_open(4)
               .gap_extend(1).bandwidth(2).device("cpu").build())
    api = aligner.banded_nw(q, r)
    assert (host[0, 0], plain["score"][0], api.get_score()) == (exp,) * 3
    if ql and rl:
        jax_al = (ref.Aligner.new().matrix(DNA).gap_open(4).gap_extend(1)
                  .bandwidth(2).build())
        assert _summary([api]) == _summary([jax_al.banded_nw(q, r)])


# -- banded_nw / banded_nw_batch against the JAX Aligner --------------------


def _pair(port_cfg, ref_cfg=None):
    p = port_cfg(port.Aligner.new()).device("cpu").build()
    r = (ref_cfg or port_cfg)(ref.Aligner.new()).build()
    return p, r


def test_banded_nw():
    # tests/test_engine.py:277-284 (reference test_parasail.rs:725-736)
    p, r = _pair(lambda b: b.bandwidth(2))
    got = p.banded_nw(b"ACGT", b"ACGT")
    assert got.get_score() == 4
    assert got.is_banded() and got.is_global() and not got.is_striped()
    assert _summary([got]) == _summary([r.banded_nw(b"ACGT", b"ACGT")])
    assert p.route_counter == {("torch_plain", "batch on the cpu"): 1}


def test_banded_nw_matches_full_nw_when_band_covers():
    # tests/test_engine.py:287-298
    rng = np.random.default_rng(7)
    for _ in range(5):
        q, r = (rng.choice(list(b"ACGT"), size=rng.integers(5, 20))
                .astype("uint8").tobytes() for _ in range(2))

        def cfg(b, bw=None):
            b = b.matrix(matrix_for(b, DNA)).gap_open(5).gap_extend(1)
            return b if bw is None else b.bandwidth(bw)
        full = cfg(port.Aligner.new()).device("cpu").build().align(q, r)
        p, jx = _pair(lambda b: cfg(b, max(len(q), len(r))))
        got = p.banded_nw(q, r)
        assert got.get_score() == full.get_score()
        assert _summary([got]) == _summary([jx.banded_nw(q, r)])


@pytest.mark.parametrize("open_,ext", [(4, 1), (2, 2), (1, 3)])
@pytest.mark.parametrize("bw", [1, 3, 8])
def test_banded_nw_batch_matches_reference_and_oracle(bw, open_, ext):
    # tests/test_engine.py:425-451, and open <= ext, which the JAX banded
    # path takes without a gate
    rng = np.random.default_rng(21)
    qs, rs = [], []
    for _ in range(6):
        qs.append(rng.choice(list(b"ACGT"), size=rng.integers(4, 30))
                  .astype("uint8").tobytes())
        rs.append(rng.choice(list(b"ACGT"), size=rng.integers(4, 30))
                  .astype("uint8").tobytes())
    p, jx = _pair(lambda b: b.matrix(matrix_for(b, DNA)).gap_open(open_)
                  .gap_extend(ext).bandwidth(bw))
    got = p.banded_nw_batch(qs, rs)
    assert _summary(got) == _summary(jx.banded_nw_batch(qs, rs))
    for q, r, res in zip(qs, rs, got):
        sub = DNA.scores_for(DNA.encode(q), DNA.encode(r)).astype(np.int64)
        want = banded_nw_fill(sub, open_, ext, bw)
        assert res.get_score() == (NEG if want < -(10 ** 8) else want)
        assert res.is_banded() and not res.is_saturated()


def test_banded_nw_requires_bandwidth():
    with pytest.raises(port.errors.NoBandwidth):
        port.Aligner.new().device("cpu").build().banded_nw(b"ACGT", b"ACGT")


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def banded_score_launches():
    """(warp form, masked full sweep) launches of the banded score
    class."""
    return tk.BANDED_WARP_LAUNCHES, tk.BANDED_CLASS_LAUNCHES["score"]


def banded_score_moved(before, ridx, qidx, bw, A=5):
    """The counts after one banded score launch of the table form: the
    warp form's where its rule takes the batch, else the masked full
    sweep's."""
    warp = tk.band_plan(ridx.shape[0], qidx.shape[1], ridx.shape[1], A,
                        bw)[0]
    return (before[0] + 1, before[1]) if warp else (before[0],
                                                    before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("open_,ext,lo,hi", PENALTIES)
def test_banded_kernel_matches_plain_on_card(open_, ext, lo, hi, cuda_device):
    rng = np.random.default_rng([open_, ext, hi])
    case = ragged(rng, 96, 40, 44, 5, 0)
    case["table"] = rng.integers(lo, hi, size=(5, 5)).astype(np.int32)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in case.items()}
    for bw in (*BANDS, -1):
        kw = dict(open_=open_, ext=ext, width="sat", table=t["table"],
                  qidx=t["qidx"], banded=True, bandwidth=bw, **NW)
        before = banded_score_launches()
        got = tk.score_align(t["ridx"], t["qlen"], t["rlen"], **kw)
        want = tk.score_align_plain(t["ridx"], t["qlen"], t["rlen"], **kw)
        torch.cuda.synchronize()
        assert banded_score_launches() == banded_score_moved(
            before, t["ridx"], t["qidx"], bw)
        assert set(got) == set(want)
        for k in got:
            assert torch.equal(got[k], want[k]), (bw, k)


# the bands of the masked sweep's CPU tests (test_torch_banded_classes.py)
MASK_BANDS = (-1, 0, 2, 5, 16)
# NW, the nine SG free-end sets of the other tests and SW
SG_FREE = [(True, False, False, False), (False, True, False, False),
           (True, True, False, False), (False, False, True, False),
           (False, False, False, True), (False, False, True, True),
           (True, False, False, True), (False, True, True, False),
           (True, True, True, True)]
CARD_MODES = ([("nw", (False,) * 4)] + [("sg", f) for f in SG_FREE] +
              [("sw", (True,) * 4)])


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", tk.OUTPUTS)
def test_banded_every_class_matches_plain_on_card(outputs, cuda_device):
    # every class in every mode launches its banded kernel form (the
    # ring, or the masked sweep on the short form: Qp 40) and equals the
    # plain version; the trace class's plane is walked by the walk kernel
    # as its plain version walks it
    rng = np.random.default_rng([7, tk.OUTPUTS.index(outputs)])
    case = ragged(rng, 96, 40, 44, 5, 0)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in case.items()}
    for n, (mode, free) in enumerate(CARD_MODES):
        open_, ext = PENALTIES[n % len(PENALTIES)][:2]
        for bw in (*BANDS, -1):
            kw = dict(open_=open_, ext=ext, mode=mode, free=free,
                      width="sat", table=t["table"], qidx=t["qidx"],
                      outputs=outputs, banded=True, bandwidth=bw)
            before = (banded_score_launches(),
                      dict(tk.BANDED_CLASS_LAUNCHES),
                      dict(tk.BANDED_FORM_LAUNCHES))
            got = tk.score_align(t["ridx"], t["qlen"], t["rlen"], **kw)
            want = tk.score_align_plain(t["ridx"], t["qlen"], t["rlen"], **kw)
            torch.cuda.synchronize()
            if outputs == "score":
                assert banded_score_launches() == banded_score_moved(
                    before[0], t["ridx"], t["qidx"], bw)
            else:
                assert tk.BANDED_CLASS_LAUNCHES[outputs] == \
                    before[1][outputs] + 1
            masked = tk.BANDED_CLASS_LAUNCHES[outputs] - before[1][outputs]
            assert tk.BANDED_FORM_LAUNCHES == {
                "short": before[2]["short"] + masked,
                "block": before[2]["block"]}
            assert set(got) == set(want)
            for k in got:
                assert torch.equal(got[k], want[k]), (mode, free, bw, k)
            if outputs == "trace":
                walk = (got["trace_table"], t["qidx"], t["ridx"],
                        got["end_query"], got["end_ref"], mode, free)
                for a, b in zip(tw.device_walk(*walk),
                                tw.device_walk_plain(*walk)):
                    assert torch.equal(a, b), (mode, free, bw)


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", tk.OUTPUTS)
def test_masked_forms_match_plain_on_card(outputs, cuda_device):
    # every class in every mode on the masked full sweep (the score class
    # forced off the ring): a short batch on the short form's masked
    # instantiation, and past 256 rows on the block kernel's; each launch
    # counted by class and by form
    rng = np.random.default_rng([11, tk.OUTPUTS.index(outputs)])
    cases = {"short": ragged(rng, 96, 40, 44, 5, 0),
             "block": ragged(rng, 24, 300, 64, 5, 0)}
    tk._BAND_FORM = (0, 0)
    try:
        for form, case in cases.items():
            t = {k: torch.from_numpy(v).to(cuda_device)
                 for k, v in case.items()}
            args = (t["ridx"], t["qlen"], t["rlen"])
            for n, (mode, free) in enumerate(CARD_MODES):
                open_, ext = PENALTIES[n % len(PENALTIES)][:2]
                for bw in (MASK_BANDS[n % len(MASK_BANDS)], 150):
                    kw = dict(open_=open_, ext=ext, mode=mode, free=free,
                              width="sat", table=t["table"],
                              qidx=t["qidx"], outputs=outputs, banded=True,
                              bandwidth=bw)
                    before = (tk.BANDED_CLASS_LAUNCHES[outputs],
                              dict(tk.BANDED_FORM_LAUNCHES))
                    got = tk.score_align(*args, **kw)
                    want = tk.score_align_plain(*args, **kw)
                    torch.cuda.synchronize()
                    assert tk.BANDED_CLASS_LAUNCHES[outputs] == before[0] + 1
                    assert tk.BANDED_FORM_LAUNCHES == {
                        k: v + (k == form) for k, v in before[1].items()}
                    assert set(got) == set(want)
                    for k in got:
                        assert torch.equal(got[k], want[k]), (
                            form, mode, free, bw, k)
    finally:
        tk._BAND_FORM = None


@pytest.mark.cuda
def test_banded_nw_batch_on_card_matches_cpu(cuda_device):
    qs = _seqs(41, b"ACGT", 40, 0, 60)
    rs = _seqs(42, b"ACGT", 40, 0, 60)

    def build(device):
        return (port.Aligner.new().matrix(port_matrix(DNA)).gap_open(4)
                .gap_extend(1).bandwidth(5).device(device).build())
    card = build(cuda_device)
    got = _summary(card.banded_nw_batch(qs, rs))
    assert got == _summary(build("cpu").banded_nw_batch(qs, rs))
    assert set(card.route_counter) == {("cuda_kernel", "")}
