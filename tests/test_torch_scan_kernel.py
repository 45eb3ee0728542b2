"""The port's score kernel module against the JAX package.

``parasail_rs_tpu_torch.ops.scan_kernel.score_align`` on CPU tensors (its
plain PyTorch version) is held, on identical numpy-seeded inputs fed to
both packages through ``convert.py``, against three references:

- the JAX ``scan_score_align`` run in interpret mode, as the JAX
  package's own tests run it (int8-range scores only: the Pallas kernel
  packs scores as int8 and the reference engine routes wider scores to
  the wavefront);
- ``wavefront_align`` (XLA);
- the scalar ``golden.align`` oracle, whose score table also gives the
  expected saturation flags.

Outputs are int32 and bool, so every comparison is exact.  The kernel
itself (CUDA) is compared with the plain version on the card by the
tests marked ``cuda``, which skip without one.  The JAX modules are
imported inside the reference runners, so on a card's machine without
jax the ``cuda`` tests run alone:
``python -m pytest --noconftest -m cuda tests/test_torch_scan_kernel.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu.golden import model as golden  # noqa: E402
from parasail_rs_tpu.matrices import Matrix  # noqa: E402

from parasail_rs_tpu_torch import convert  # noqa: E402
from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402

B = 128            # the Pallas kernel takes batches padded to 128 pairs
SG_FREE = {        # the nine semi-global free-end variants (qb, qe, db, de)
    "sg_qb": (True, False, False, False),
    "sg_qe": (False, True, False, False),
    "sg_qx": (True, True, False, False),
    "sg_db": (False, False, True, False),
    "sg_de": (False, False, False, True),
    "sg_dx": (False, False, True, True),
    "sg_qb_de": (True, False, False, True),
    "sg_qe_db": (False, True, True, False),
    "sg": (True, True, True, True),
}


def _lengths(rng, n, maxlen):
    return rng.integers(1, maxlen, size=n).astype(np.int32)


def table_case(seed, *, A=25, lo=-4, hi=8, Qp=32, Rp=32, maxlen=30,
               table=None, shared=False):
    """Random (A, A) table + query letters, ragged lengths < 32."""
    rng = np.random.default_rng(seed)
    if table is None:
        table = rng.integers(lo, hi, size=(A, A)).astype(np.int32)
    A = table.shape[0]
    Bq = 1 if shared else B
    qlen = _lengths(rng, B, maxlen)
    if shared:
        qlen[:] = qlen[0]
    rlen = _lengths(rng, B, maxlen)
    qidx = np.full((Bq, Qp), -1, np.int32)
    for b in range(Bq):
        qidx[b, :qlen[b]] = rng.integers(0, A, size=qlen[b])
    ridx = np.zeros((B, Rp), np.int32)
    for b in range(B):
        ridx[b, :rlen[b]] = rng.integers(0, A, size=rlen[b])
    return dict(table=table, qidx=qidx, ridx=ridx, qlen=qlen, rlen=rlen)


def profile_case(seed, *, A=25, lo=-4, hi=12, Qp=32, Rp=32, maxlen=30,
                 shared=False):
    """Random (1 or B, Qp, A) profile rows, ragged lengths < 32."""
    rng = np.random.default_rng(seed)
    Bq = 1 if shared else B
    profile = rng.integers(lo, hi, size=(Bq, Qp, A)).astype(np.int32)
    qlen = _lengths(rng, B, maxlen)
    if shared:
        qlen[:] = qlen[0]
    rlen = _lengths(rng, B, maxlen)
    ridx = np.zeros((B, Rp), np.int32)
    for b in range(B):
        ridx[b, :rlen[b]] = rng.integers(0, A, size=rlen[b])
    return dict(profile=profile, ridx=ridx, qlen=qlen, rlen=rlen)


def seq_case(matrix, seed, alphabet, maxlen=30, Qp=32, Rp=32):
    """Random sequences encoded by a Matrix: table form for a square
    matrix, shared position rows (the reference's PSSM packing) else."""
    rng = np.random.default_rng(seed)
    alpha = list(alphabet)
    qs = [rng.choice(alpha, size=rng.integers(1, maxlen)).astype(np.uint8)
          .tobytes() for _ in range(B)]
    rs = [rng.choice(alpha, size=rng.integers(1, maxlen)).astype(np.uint8)
          .tobytes() for _ in range(B)]
    qlen = np.array([len(q) for q in qs], np.int32)
    rlen = np.array([len(r) for r in rs], np.int32)
    ridx = np.zeros((B, Rp), np.int32)
    qidx = np.full((B, Qp), -1, np.int32)
    for b in range(B):
        ridx[b, :rlen[b]] = matrix.encode(rs[b])
        qidx[b, :qlen[b]] = matrix.encode(qs[b])
    case = dict(ridx=ridx, qlen=qlen, rlen=rlen)
    if matrix.is_square:
        case.update(table=matrix.data.astype(np.int32), qidx=qidx)
    else:
        rows = matrix.data[np.arange(Qp) % matrix.length].astype(np.int32)
        case.update(profile=rows[None])
    return case


def dense_rows(case):
    """(1 or B, Qp, A) rows of either form (invalid letters score 0)."""
    if "profile" in case:
        return case["profile"]
    table, qidx = case["table"], case["qidx"]
    A = table.shape[0]
    rows = table[np.clip(qidx, 0, A - 1)]
    return np.where((qidx >= 0)[..., None], rows, 0).astype(np.int32)


def run_port(case, *, open_, ext, mode, free, width, device="cpu"):
    batch = convert.batch_from_reference(
        qlen=case["qlen"], rlen=case["rlen"], ridx=case["ridx"],
        qidx=case.get("qidx"), table=case.get("table"),
        profile=case.get("profile"), device=device)
    subs = ({"table": batch.table, "qidx": batch.qidx}
            if batch.table is not None else {"profile": batch.profile})
    out = tk.score_align(batch.ridx, batch.qlen_t, batch.rlen_t,
                         open_=open_, ext=ext, mode=mode, free=free,
                         width=width, **subs)
    return {k: v.cpu().numpy() for k, v in out.items()}


def run_jax_scan(case, *, open_, ext, mode, free, width):
    from parasail_rs_tpu.ops.scan_kernel import (build_gpack_from_table,
                                                 scan_score_align)

    kw = dict(open_=np.int32(open_), ext=np.int32(ext), mode=mode,
              free=free, width=width, interpret=True)
    if "table" in case and case["table"].shape[0] <= 32:
        # the reference's table path: letter-indexed gpack from the table
        gp = build_gpack_from_table(case["table"], case["qidx"])
        out = scan_score_align(None, case["ridx"], case["qlen"],
                               case["rlen"], gpack=gp,
                               alphabet=case["table"].shape[0], **kw)
    else:
        out = scan_score_align(dense_rows(case), case["ridx"], case["qlen"],
                               case["rlen"], **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def run_wavefront(case, *, open_, ext, mode, free, width):
    from parasail_rs_tpu.ops.wavefront import wavefront_align

    rows = dense_rows(case)
    qidx = case.get("qidx", np.zeros((rows.shape[0], rows.shape[1]),
                                     np.int32))
    out = wavefront_align(
        rows, qidx, case["ridx"], case["qlen"], case["rlen"],
        open_=np.int32(open_), ext=np.int32(ext), mode=mode, free=free,
        outputs="score", width=width)
    return {k: np.asarray(v) for k, v in out.items()}


def golden_expect(case, *, open_, ext, mode, free, width):
    """Per-pair golden fill; flags from the in-sequence H extremes."""
    rows = dense_rows(case)
    keys = {k: np.zeros(B, np.int64) for k in ("score", "end_query",
                                                "end_ref")}
    sat8 = np.zeros(B, bool)
    sat16 = np.zeros(B, bool)
    for b in range(B):
        ql, rl = int(case["qlen"][b]), int(case["rlen"][b])
        p = rows[0 if rows.shape[0] == 1 else b, :ql]
        sub = p[np.arange(ql)[:, None], case["ridx"][b, :rl][None, :]]
        g = golden.align(sub.astype(np.int64), np.zeros_like(sub, bool),
                         open_, ext, mode, free)
        keys["score"][b] = g.score
        keys["end_query"][b] = g.end_query
        keys["end_ref"][b] = g.end_ref
        t = g.score_table
        sat8[b] = t.max() >= 127 or t.min() <= -128
        sat16[b] = t.max() >= 32767 or t.min() <= -32768
    out = dict(keys)
    if width == "8":
        out["saturated"] = sat8
    elif width in ("16", "sat"):
        out["saturated"] = sat16
        if width == "sat":
            out["promoted"] = sat8
    else:
        out["saturated"] = np.zeros(B, bool)
    return out


def assert_same(got, want, what):
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k in want:
        np.testing.assert_array_equal(
            np.asarray(got[k]).astype(want[k].dtype), want[k],
            err_msg=f"{what}/{k}")


BLOSUM62 = Matrix.from_name("blosum62")
PROTEIN = b"ARNDCQEGHILKMFPSTWYV"
PSSM = Matrix.create_pssm(
    b"ACGT", np.random.default_rng(5).integers(-3, 6, size=40 * 4), 40)

# name -> (case factory, kwargs, int8-range scores?)
CASES = {
    "nw_table": (lambda: table_case(1), dict(mode="nw", free=(False,) * 4,
                                             open_=11, ext=1, width="sat"),
                 True),
    "sw_table": (lambda: table_case(2), dict(mode="sw", free=(True,) * 4,
                                             open_=11, ext=1, width="sat"),
                 True),
    **{f"{name}_table": (lambda s=i: table_case(10 + s),
                         dict(mode="sg", free=f, open_=5, ext=2, width="sat"),
                         True)
       for i, (name, f) in enumerate(SG_FREE.items())},
    **{f"width_{w}": (lambda: profile_case(3, lo=-20, hi=60),
                      dict(mode="sw", free=(True,) * 4, open_=11, ext=1,
                           width=w), True)
       for w in ("8", "16", "32", "sat", "64")},
    "width16_wide_scores": (lambda: profile_case(4, lo=-200, hi=2400),
                            dict(mode="sw", free=(True,) * 4, open_=11,
                                 ext=1, width="sat"), False),
    "shared_profile": (lambda: profile_case(5, shared=True),
                       dict(mode="sw", free=(True,) * 4, open_=11, ext=1,
                            width="sat"), True),
    "per_pair_profile_sg": (lambda: profile_case(6),
                            dict(mode="sg", free=(True, False, False, True),
                                 open_=11, ext=1, width="sat"), True),
    "shared_query_table": (lambda: table_case(7, shared=True),
                           dict(mode="nw", free=(False,) * 4, open_=4, ext=2,
                                width="sat"), True),
    **{f"open{o}_ext{e}_{m}": (lambda s=o * 10 + e: table_case(20 + s),
                               dict(mode=m, free=(True,) * 4 if m == "sw"
                                    else (False,) * 4, open_=o, ext=e,
                                    width="32"), True)
       for o, e in ((1, 3), (2, 5), (0, 1), (0, 0), (2, 2), (3, 3))
       for m in ("nw", "sw")},
    "blosum62_sw": (lambda: seq_case(BLOSUM62, 8, PROTEIN),
                    dict(mode="sw", free=(True,) * 4, open_=11, ext=1,
                         width="sat"), True),
    "blosum62_sg": (lambda: seq_case(BLOSUM62, 9, PROTEIN),
                    dict(mode="sg", free=(False, True, True, False),
                         open_=10, ext=1, width="sat"), True),
    "pssm_sw": (lambda: seq_case(PSSM, 10, b"ACGT"),
                dict(mode="sw", free=(True,) * 4, open_=5, ext=2,
                     width="sat"), True),
    "pssm_nw": (lambda: seq_case(PSSM, 11, b"ACGT"),
                dict(mode="nw", free=(False,) * 4, open_=5, ext=2,
                     width="sat"), True),
    "beyond_int8_table": (lambda: table_case(12, lo=-300, hi=400),
                          dict(mode="sw", free=(True,) * 4, open_=11, ext=1,
                               width="sat"), False),
    "beyond_int8_nw": (lambda: table_case(13, lo=-300, hi=200),
                       dict(mode="nw", free=(False,) * 4, open_=50, ext=7,
                            width="16"), False),
    "alphabet_40": (lambda: table_case(14, A=40),
                    dict(mode="sw", free=(True,) * 4, open_=11, ext=1,
                         width="sat"), True),
}


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cache, name):
    if name not in cache:
        cache[name] = CASES[name][0]()
    return cache[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_golden(cases, name):
    case = _case(cases, name)
    kw = CASES[name][1]
    assert_same(run_port(case, **kw), golden_expect(case, **kw), name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_wavefront(cases, name):
    case = _case(cases, name)
    kw = CASES[name][1]
    assert_same(run_port(case, **kw), run_wavefront(case, **kw), name)


@pytest.mark.parametrize("name", sorted(n for n in CASES if CASES[n][2]))
def test_plain_matches_jax_scan_kernel(cases, name):
    case = _case(cases, name)
    kw = CASES[name][1]
    assert_same(run_port(case, **kw), run_jax_scan(case, **kw), name)


def test_saturation_cases_trip_both_ways(cases):
    # the width cases must exercise both outcomes of each flag
    got = run_port(_case(cases, "width_sat"),
                   **CASES["width_sat"][1])
    assert got["promoted"].any() and not got["promoted"].all()
    wide = run_port(_case(cases, "width16_wide_scores"),
                    **CASES["width16_wide_scores"][1])
    assert wide["saturated"].any() and not wide["saturated"].all()


def test_wrapper_runs_plain_version_on_cpu(cases, monkeypatch):
    case = _case(cases, "sw_table")
    kw = CASES["sw_table"][1]
    calls = []
    real = tk.score_align_plain
    monkeypatch.setattr(tk, "score_align_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    before = (dict(tk.SHORT_LAUNCHES), tk.CHUNKED_LAUNCHES)
    run_port(case, **kw)
    assert calls == [1]
    assert (tk.SHORT_LAUNCHES, tk.CHUNKED_LAUNCHES) == before


def test_wrapper_rejects_bad_inputs(cases):
    case = _case(cases, "sw_table")
    batch = convert.batch_from_reference(
        qlen=case["qlen"], rlen=case["rlen"], ridx=case["ridx"],
        qidx=case["qidx"], table=case["table"], device="cpu")
    kw = dict(open_=11, ext=1, mode="sw", free=(True,) * 4, width="sat")
    with pytest.raises(TypeError):
        tk.score_align(batch.ridx.long(), batch.qlen_t, batch.rlen_t,
                       table=batch.table, qidx=batch.qidx, **kw)
    with pytest.raises(ValueError):
        tk.score_align(batch.ridx, batch.qlen_t, batch.rlen_t,
                       table=batch.table, **kw)
    with pytest.raises(ValueError):
        tk.score_align(batch.ridx, batch.qlen_t[:-1], batch.rlen_t,
                       table=batch.table, qidx=batch.qidx, **kw)
    with pytest.raises(ValueError):
        tk.score_align(batch.ridx, batch.qlen_t, batch.rlen_t,
                       table=batch.table, qidx=batch.qidx,
                       **{**kw, "width": "12"})


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_card(cases, name, cuda_device):
    case = _case(cases, name)
    kw = CASES[name][1]
    before = tk.SHORT_LAUNCHES["score"]
    got = run_port(case, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert tk.SHORT_LAUNCHES["score"] == before + 1
    assert_same(got, run_port(case, **kw), name)


# (padded query rows, reference columns, pairs, form) of the score class on
# the short form (one warp a pair, 4 to 8 rows a lane) and past its 256
# rows: bench.py's headline shape on fewer pairs (per-pair profiles of
# 160 rows), one profile against many references, a lane's edges at 129
# and 193 rows, the single pair, and the block kernel's one-shot form
SHORT_SCORE = {
    "headline_profile_160": (160, 160, 64, "profile"),
    "shared_profile_192": (192, 192, 96, "shared"),
    "table_129": (129, 70, 64, "table"),
    "table_193": (193, 70, 64, "table"),
    "single_pair_192": (192, 192, 1, "table"),
    "table_300_block_form": (300, 64, 32, "table"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHORT_SCORE))
def test_short_score_matches_plain_on_card(name, cuda_device):
    Qp, Rp, n, form = SHORT_SCORE[name]
    rng = np.random.default_rng(Qp * 1000 + n)
    qlen = rng.integers(0, Qp + 1, size=n).astype(np.int32)
    qlen[:4] = (Qp, Qp - 1, 4 * (Qp // 8), 0)[:n]
    rlen = rng.integers(0, Rp + 1, size=n).astype(np.int32)
    rlen[:2] = (Rp, 1)[:n]
    t = {"ridx": rng.integers(0, 25, size=(n, Rp)), "qlen": qlen,
         "rlen": rlen}
    if form == "table":
        t.update(table=rng.integers(-4, 8, size=(25, 25)),
                 qidx=rng.integers(0, 25, size=(n, Qp)))
    else:
        t["profile"] = rng.integers(-4, 12, size=(
            1 if form == "shared" else n, Qp, 25))
    t = {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(
        cuda_device) for k, v in t.items()}
    args = (t.pop("ridx"), t.pop("qlen"), t.pop("rlen"))
    for mode, free, open_, ext in (("sw", (True,) * 4, 11, 1),
                                   ("nw", (False,) * 4, 1, 3),
                                   ("sg", SG_FREE["sg_qe_db"], 2, 2)):
        kw = dict(open_=open_, ext=ext, mode=mode, free=free, width="sat",
                  **t)
        before = (tk.SHORT_LAUNCHES["score"], tk.CHUNKED_LAUNCHES)
        got = tk.score_align(*args, **kw)
        torch.cuda.synchronize()
        short = Qp <= 256
        assert (tk.SHORT_LAUNCHES["score"], tk.CHUNKED_LAUNCHES) == (
            before[0] + short, before[1] + (not short))
        want = tk.score_align_plain(*args, **kw)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, mode, k)
