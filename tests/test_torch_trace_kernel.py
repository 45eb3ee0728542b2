"""The port's trace class (kernel K1b) against the JAX package and golden.

``score_align(..., outputs="trace")`` on CPU tensors (its plain PyTorch
version) is held, on identical numpy-seeded inputs, against:

- the JAX ``scan_score_align(..., outputs="trace")`` in interpret mode,
  on the in-sequence flag cells and the scalars (a few cases: interpret
  mode is slow, and the Pallas kernel takes batches of 128 pairs);
- the scalar ``golden.align`` oracle's ``trace_table``, score and end
  cell, on the mode, free-end and penalty grid of the score tests.

Flags are int8 and scalars int32, so every comparison is exact.  Pairs
with an empty side follow golden (the JAX package's two routes disagree
with it there; ROADMAP Queue 3).  The CUDA kernel is compared with the
plain version by the ``cuda`` tests, which skip without a card:
``python -m pytest --noconftest -m cuda tests/test_torch_trace_kernel.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu.golden import model as golden  # noqa: E402
from parasail_rs_tpu.matrices import Matrix  # noqa: E402

from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402

B = 128            # the Pallas kernel takes batches padded to 128 pairs
SW, NW = (True,) * 4, (False,) * 4
SG_FREE = [(True, False, False, False), (False, True, False, False),
           (True, True, False, False), (False, False, True, False),
           (False, False, False, True), (False, False, True, True),
           (True, False, False, True), (False, True, True, False),
           (True, True, True, True)]


def make_case(seed, *, A=6, lo=-5, hi=7, n=B, Qp=32, Rp=32, minlen=1,
              profile=False, shared=False, table=None):
    """Seeded ragged batch: an (A, A) table + query letters, or
    (1 or n, Qp, A) profile rows; lengths in [minlen, Qp - 2]."""
    rng = np.random.default_rng(seed)
    if table is not None:
        A = table.shape[0]
    qlen = rng.integers(minlen, Qp - 1, size=n).astype(np.int32)
    rlen = rng.integers(minlen, Rp - 1, size=n).astype(np.int32)
    if shared:
        qlen[:] = qlen[0]
    Bq = 1 if shared else n
    qidx = np.full((Bq, Qp), -1, np.int32)
    ridx = np.zeros((n, Rp), np.int32)
    for b in range(n):
        if b < Bq:
            qidx[b, :qlen[b]] = rng.integers(0, A, size=qlen[b])
        ridx[b, :rlen[b]] = rng.integers(0, A, size=rlen[b])
    case = dict(ridx=ridx, qlen=qlen, rlen=rlen)
    if profile:
        case["profile"] = rng.integers(lo, hi, size=(Bq, Qp, A)).astype(
            np.int32)
    else:
        case["table"] = (table if table is not None else
                         rng.integers(lo, hi, size=(A, A))).astype(np.int32)
        case["qidx"] = qidx
    return case


def dense_rows(case):
    if "profile" in case:
        return case["profile"]
    table, qidx = case["table"], case["qidx"]
    rows = table[np.clip(qidx, 0, table.shape[0] - 1)]
    return np.where((qidx >= 0)[..., None], rows, 0).astype(np.int32)


def run_plain(case, **kw):
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    out = tk.score_align(t.pop("ridx"), t.pop("qlen"), t.pop("rlen"),
                         outputs="trace", **kw, **t)
    return {k: v.numpy() for k, v in out.items()}


def golden_pair(case, b, open_, ext, mode, free):
    rows = dense_rows(case)
    ql, rl = int(case["qlen"][b]), int(case["rlen"][b])
    p = rows[0 if rows.shape[0] == 1 else b, :ql]
    sub = p[np.arange(ql)[:, None], case["ridx"][b, :rl][None, :]]
    return golden.align(sub.astype(np.int64), np.zeros_like(sub, bool),
                        open_, ext, mode, free)


def assert_matches_golden(case, got, open_, ext, mode, free):
    for b in range(len(case["qlen"])):
        ql, rl = int(case["qlen"][b]), int(case["rlen"][b])
        g = golden_pair(case, b, open_, ext, mode, free)
        np.testing.assert_array_equal(got["trace_table"][b, :ql, :rl],
                                      g.trace_table, err_msg=f"pair {b}")
        assert (got["score"][b], got["end_query"][b], got["end_ref"][b]) \
            == (g.score, g.end_query, g.end_ref), b
        # cells outside the pair's qlen x rlen stay zero
        pad = got["trace_table"][b].copy()
        pad[:ql, :rl] = 0
        assert not pad.any(), b


GRID = ([(m, f, o, e) for m, f in (("nw", NW), ("sw", SW))
         for o, e in ((11, 1), (5, 2), (1, 3), (0, 0), (2, 2), (0, 1))] +
        [("sg", f, 5, 2) for f in SG_FREE] +
        [("sg", f, 1, 3) for f in SG_FREE[:3]])


@pytest.mark.parametrize("mode,free,open_,ext", GRID)
def test_plain_trace_matches_golden(mode, free, open_, ext):
    case = make_case(hash((mode, free, open_, ext)) % 2 ** 32, n=24)
    got = run_plain(case, open_=open_, ext=ext, mode=mode, free=free,
                    width="sat")
    assert_matches_golden(case, got, open_, ext, mode, free)


@pytest.mark.parametrize("name,kw", [
    ("profile_per_pair", dict(profile=True, lo=-4, hi=12)),
    ("profile_shared", dict(profile=True, shared=True, lo=-4, hi=12)),
    ("table_shared_query", dict(shared=True)),
    ("blosum62", dict(table=Matrix.from_name("blosum62").data)),
    ("alphabet_40", dict(A=40, lo=-4, hi=8)),
    ("beyond_int8", dict(lo=-300, hi=400)),
])
def test_plain_trace_forms_match_golden(name, kw):
    case = make_case(len(name), n=24, **kw)
    for mode, free in (("sw", SW), ("sg", (True, False, False, True)),
                       ("nw", NW)):
        got = run_plain(case, open_=11, ext=1, mode=mode, free=free,
                        width="sat")
        assert_matches_golden(case, got, 11, 1, mode, free)


def run_jax_trace(case, **kw):
    from parasail_rs_tpu.ops.scan_kernel import (build_gpack_from_table,
                                                 scan_score_align)

    kw = dict(kw, open_=np.int32(kw["open_"]), ext=np.int32(kw["ext"]),
              outputs="trace", interpret=True)
    if "table" in case:
        gp = build_gpack_from_table(case["table"], case["qidx"])
        out = scan_score_align(None, case["ridx"], case["qlen"],
                               case["rlen"], gpack=gp,
                               alphabet=case["table"].shape[0], **kw)
    else:
        out = scan_score_align(case["profile"], case["ridx"], case["qlen"],
                               case["rlen"], **kw)
    return {k: np.asarray(v) for k, v in out.items()}


# few on purpose: each runs the Pallas kernel in interpret mode
JAX_CASES = {
    "nw_table_11_1": (dict(seed=1), dict(mode="nw", free=NW, open_=11,
                                         ext=1, width="sat")),
    "sw_table_5_2": (dict(seed=2), dict(mode="sw", free=SW, open_=5, ext=2,
                                        width="sat")),
    "sg_qe_db_profile": (dict(seed=3, profile=True, lo=-4, hi=12),
                         dict(mode="sg", free=(False, True, True, False),
                              open_=11, ext=1, width="sat")),
    "sg_all_open_below_ext": (dict(seed=4), dict(mode="sg", free=SW,
                                                 open_=1, ext=3,
                                                 width="32")),
    "sw_shared_profile_open_eq_ext": (
        dict(seed=5, profile=True, shared=True, lo=-4, hi=12),
        dict(mode="sw", free=SW, open_=2, ext=2, width="16")),
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_plain_trace_matches_jax_scan_kernel(name):
    make_kw, kw = JAX_CASES[name]
    case = make_case(**make_kw)
    got = run_plain(case, **kw)
    want = run_jax_trace(case, **kw)
    assert set(got) == set(want)
    for k in want:
        if k == "trace_table":
            continue
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype),
                                      err_msg=k)
    for b in range(B):
        ql, rl = case["qlen"][b], case["rlen"][b]
        np.testing.assert_array_equal(got["trace_table"][b, :ql, :rl],
                                      want["trace_table"][b, :ql, :rl],
                                      err_msg=f"pair {b}")


# The empty-side pairs (default DNA matrix, open 5, ext 2): golden's
# (score, end_query, end_ref).  Golden's SW raises on them (it indexes
# H[1, 1] of a one-row grid); its rule for an empty local alignment is
# score 0 at (0, 0), which the port gives.
EMPTY_QS = [b"", b"ACGT", b"ACGTACGTACGTACGTACGTACGTACGTAC", b""]
EMPTY_RS = [b"ACGT", b"", b"ACGTAC", b""]


def empty_case(qs, rs):
    m = Matrix.default()
    Qp = Rp = 32
    ridx = np.zeros((len(rs), Rp), np.int32)
    qidx = np.full((len(qs), Qp), -1, np.int32)
    for b, (q, r) in enumerate(zip(qs, rs)):
        qidx[b, :len(q)] = m.encode(q)
        ridx[b, :len(r)] = m.encode(r)
    return dict(ridx=ridx, qlen=np.array([len(q) for q in qs], np.int32),
                rlen=np.array([len(r) for r in rs], np.int32),
                table=m.data.astype(np.int32), qidx=qidx)


def golden_empty(q, r, mode, free):
    if mode == "sw" and not (q and r):
        return 0, 0, 0
    g = golden.align_seqs(q, r, Matrix.default(), 5, 2, mode, free)
    return g.score, g.end_query, g.end_ref


@pytest.mark.parametrize("mode,free", [("nw", NW), ("sw", SW)] +
                         [("sg", f) for f in SG_FREE])
@pytest.mark.parametrize("outputs", ["score", "trace"])
def test_empty_side_pairs_follow_golden(mode, free, outputs):
    case = empty_case(EMPTY_QS, EMPTY_RS)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    out = tk.score_align(t.pop("ridx"), t.pop("qlen"), t.pop("rlen"),
                         open_=5, ext=2, mode=mode, free=free, width="sat",
                         outputs=outputs, **t)
    for b, (q, r) in enumerate(zip(EMPTY_QS, EMPTY_RS)):
        got = (int(out["score"][b]), int(out["end_query"][b]),
               int(out["end_ref"][b]))
        assert got == golden_empty(q, r, mode, free), (b, got)
    if mode == "nw":
        assert [int(x) for x in out["score"][:2]] == [-11, -11]


def test_wrapper_runs_plain_trace_on_cpu(monkeypatch):
    case = make_case(9, n=8)
    calls = []
    real = tk.score_align_plain
    monkeypatch.setattr(tk, "score_align_plain",
                        lambda *a, **k: calls.append(k["outputs"]) or
                        real(*a, **k))
    def launches():
        return dict(tk.SHORT_LAUNCHES), tk.CHUNKED_LAUNCHES

    before = launches()
    run_plain(case, open_=5, ext=2, mode="sw", free=SW, width="sat")
    assert calls == ["trace"]
    assert launches() == before


def test_wrapper_rejects_unknown_outputs():
    # every class of the reference is ported; any other name raises
    case = make_case(10, n=4)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    with pytest.raises(ValueError, match="outputs"):
        tk.score_align(t.pop("ridx"), t.pop("qlen"), t.pop("rlen"),
                       open_=5, ext=2, mode="sw", free=SW, width="sat",
                       outputs="trace_stats", **t)


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,free,open_,ext", GRID)
def test_trace_kernel_matches_plain_on_card(mode, free, open_, ext,
                                            cuda_device):
    case = make_case(hash((mode, free, open_, ext)) % 2 ** 32, minlen=0)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in case.items()}
    args = (t.pop("ridx"), t.pop("qlen"), t.pop("rlen"))
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, width="sat",
              outputs="trace", **t)
    before = tk.SHORT_LAUNCHES["trace"]
    got = tk.score_align(*args, **kw)
    torch.cuda.synchronize()
    assert tk.SHORT_LAUNCHES["trace"] == before + 1
    want = tk.score_align_plain(*args, **kw)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
