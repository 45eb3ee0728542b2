"""The port's wavefront (the plain version of the stats, table and rowcol
kernel forms) against the JAX package's wavefront and golden.

``parasail_rs_tpu_torch.ops.wavefront.wavefront_align`` is fed, through
numpy, the same padded batches as the reference's jitted
``parasail_rs_tpu.ops.wavefront.wavefront_align`` on the CPU, for every
output class, banded and not: the scalars, stats and rows / columns must
be equal, and the planes in every in-sequence cell (the port zeroes the
padded cells, the reference leaves values there).  On every pair, those
with an empty side included, the port must equal the scalar
``golden.align`` oracle (the reference's wavefront does not there;
ROADMAP Queue 3).  Every comparison is exact: the outputs are integers.
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu.golden import align_seqs, free_flags  # noqa: E402
from parasail_rs_tpu.matrices import Matrix  # noqa: E402

from parasail_rs_tpu_torch.ops import wavefront as tw  # noqa: E402

DNA = b"ACGT"
PROT = b"ARNDCQEGHILKMFPSTWYV"
IDENT = Matrix.default()
B62 = Matrix.from_name("blosum62")
CLASSES = ("score", "trace", "stats", "table", "stats_table", "rowcol",
           "stats_rowcol")
SG_SETS = [(True, False, False, True), (False, True, True, False),
           (True, True, False, False), (False, False, True, True),
           (True, True, True, True)]


def _pairs(seed, alpha, n, lo, hi):
    """n seeded pairs; ``seed`` is an int or a tuple of names."""
    if not isinstance(seed, int):
        seed = zlib.crc32(repr(seed).encode())
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alpha, np.uint8)

    def seq():
        return a[rng.integers(0, len(a), int(rng.integers(lo, hi + 1)))] \
            .tobytes()
    return [(seq(), seq()) for _ in range(n)]


def pack(pairs, matrix, Qp=None, Rp=None):
    """Padded numpy inputs, as tests/test_wavefront.py packs them."""
    B = len(pairs)
    Qp = Qp or max(1, max(len(q) for q, _ in pairs))
    Rp = Rp or max(1, max(len(r) for _, r in pairs))
    prof = np.zeros((B, Qp, matrix.size), np.int32)
    qidx = np.zeros((B, Qp), np.int32)
    ridx = np.zeros((B, Rp), np.int32)
    qlen = np.zeros(B, np.int32)
    rlen = np.zeros(B, np.int32)
    for b, (q, r) in enumerate(pairs):
        qi, ri = matrix.encode(q), matrix.encode(r)
        qlen[b], rlen[b] = len(qi), len(ri)
        if matrix.kind == "square":
            prof[b, :len(qi)] = matrix.data[qi]
        else:
            prof[b, :len(qi)] = matrix.data[np.arange(len(qi)) % matrix.length]
        qidx[b, :len(qi)] = qi
        ridx[b, :len(ri)] = ri
    return dict(profile=prof, qidx=qidx, ridx=ridx, qlen=qlen, rlen=rlen)


def run_port(case, **kw):
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    out = tw.wavefront_align(t["profile"], t["qidx"], t["ridx"], t["qlen"],
                             t["rlen"], **kw)
    return {k: v.numpy() for k, v in out.items()}


def run_jax(case, **kw):
    from parasail_rs_tpu.ops.wavefront import wavefront_align

    kw = dict(kw, open_=np.int32(kw["open_"]), ext=np.int32(kw["ext"]))
    if "bandwidth" in kw:
        kw["bandwidth"] = np.int32(kw["bandwidth"])
    out = wavefront_align(case["profile"], case["qidx"], case["ridx"],
                          case["qlen"], case["rlen"], **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def assert_same_in_sequence(got, want, case, what):
    """Scalars exactly; planes on each pair's in-sequence cells, rows and
    columns over its lengths (both are 0 beyond them)."""
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        for b in range(len(case["qlen"])):
            ql, rl = int(case["qlen"][b]), int(case["rlen"][b])
            if k.endswith("_table"):
                g_b, w_b = g[b, :ql, :rl], w[b, :ql, :rl]
            elif k.endswith("_row"):
                g_b, w_b = g[b, :rl], w[b, :rl]
            elif k.endswith("_col"):
                g_b, w_b = g[b, :ql], w[b, :ql]
            else:
                g_b, w_b = g[b], w[b]
            np.testing.assert_array_equal(g_b, w_b, err_msg=f"{what}/{k}/{b}")


# (outputs, mode, free, open, ext): every class in every mode, the SG
# free sets and the penalty pairs rotating through them, open <= ext
# included
PENALTIES = [(11, 1), (2, 2), (1, 3)]
JAX_CASES = [
    (cls, mode, SG_SETS[n % 5] if mode == "sg" else free_flags(mode),
     *PENALTIES[(n + k) % 3])
    for n, cls in enumerate(CLASSES)
    for k, mode in enumerate(("nw", "sg", "sw"))
]


@pytest.mark.parametrize("outputs,mode,free,open_,ext", JAX_CASES)
def test_matches_jax_wavefront(outputs, mode, free, open_, ext):
    case = pack(_pairs((outputs, mode), PROT, 12, 1, 14),
                B62, Qp=16, Rp=16)
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs,
              width="sat")
    got = run_port(case, **kw)
    assert_same_in_sequence(got, run_jax(case, **kw), case,
                            f"{outputs}/{mode}/{free}/{open_},{ext}")
    for k, v in got.items():
        if k.endswith("_table"):
            for b, (ql, rl) in enumerate(zip(case["qlen"], case["rlen"])):
                assert not v[b, ql:].any() and not v[b, :, rl:].any()


# (outputs, mode, free): NW in three classes, then SG and SW in every
# class, the SG free sets rotating
BANDED_CASES = (
    [pytest.param(cls, "nw", (False,) * 4, id=cls)
     for cls in ("score", "stats_table", "stats_rowcol")] +
    [pytest.param(cls, mode, SG_SETS[n % 5] if mode == "sg" else (True,) * 4,
                  id=f"{mode}-{cls}")
     for n, cls in enumerate(CLASSES) for mode in ("sg", "sw")])


@pytest.mark.parametrize("outputs,mode,free", BANDED_CASES)
def test_banded_matches_jax_wavefront(outputs, mode, free):
    case = pack(_pairs(5, DNA, 10, 4, 14), IDENT, Qp=16, Rp=16)
    kw = dict(open_=3, ext=1, mode=mode, free=free, outputs=outputs,
              width="32", banded=True, bandwidth=4)
    assert_same_in_sequence(run_port(case, **kw), run_jax(case, **kw), case,
                            f"banded {mode} {outputs}")


def _golden(q, r, m, open_, ext, mode, free):
    if mode == "sw" and not (q and r):
        return None         # golden's SW indexes a cell an empty grid lacks
    return align_seqs(q, r, m, open_, ext, mode, free)


@pytest.mark.parametrize("open_,ext", [(11, 1), (2, 2), (1, 3)])
@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
def test_stats_match_golden(mode, open_, ext):
    # tests/test_wavefront.py:94-102, at every penalty regime
    pairs = _pairs(("stats", mode, open_), PROT, 16, 1, 11)
    for free in (SG_SETS if mode == "sg" else [free_flags(mode)]):
        out = run_port(pack(pairs, B62), open_=open_, ext=ext, mode=mode,
                       free=free, outputs="stats", width="32")
        for b, (q, r) in enumerate(pairs):
            g = align_seqs(q, r, B62, open_, ext, mode, free)
            got = tuple(int(out[k][b]) for k in (
                "score", "end_query", "end_ref", "matches", "similar",
                "length"))
            assert got == (g.score, g.end_query, g.end_ref, g.matches,
                           g.similar, g.length), (free, q, r)


@pytest.mark.parametrize("outputs", ["stats_table", "stats_rowcol"])
@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
def test_planes_match_golden(mode, outputs):
    # tests/test_wavefront.py:105-130
    pairs = _pairs((outputs, mode), DNA, 8, 2, 9)
    out = run_port(pack(pairs, IDENT), open_=2, ext=1, mode=mode,
                   free=free_flags(mode), outputs=outputs, width="32")
    for b, (q, r) in enumerate(pairs):
        g = align_seqs(q, r, IDENT, 2, 1, mode)
        ql, rl = len(q), len(r)
        for name in tw.PLANES:
            if outputs == "stats_table":
                np.testing.assert_array_equal(
                    out[f"{name}_table"][b, :ql, :rl],
                    getattr(g, f"{name}_table"), err_msg=f"{name} {b}")
            else:
                np.testing.assert_array_equal(
                    out[f"{name}_row"][b, :rl], getattr(g, f"{name}_row"))
                np.testing.assert_array_equal(
                    out[f"{name}_col"][b, :ql], getattr(g, f"{name}_col"))


EMPTY_QS = [b"", b"ACGT", b"ACGTACGTACGTACGTACGTACGTACGTAC", b""]
EMPTY_RS = [b"ACGT", b"", b"ACGTAC", b""]


@pytest.mark.parametrize("outputs", ["stats", "stats_rowcol"])
@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
def test_empty_side_pairs_follow_golden(mode, outputs):
    pairs = list(zip(EMPTY_QS, EMPTY_RS))
    case = pack(pairs, IDENT, Qp=32, Rp=32)
    for free in (SG_SETS if mode == "sg" else [free_flags(mode)]):
        out = run_port(case, open_=5, ext=2, mode=mode, free=free,
                       outputs=outputs, width="sat")
        for b, (q, r) in enumerate(pairs):
            g = _golden(q, r, IDENT, 5, 2, mode, free)
            want = ((0,) * 6 if g is None else
                    (g.score, g.end_query, g.end_ref, g.matches, g.similar,
                     g.length))
            got = tuple(int(out[k][b]) for k in (
                "score", "end_query", "end_ref", "matches", "similar",
                "length"))
            assert got == want, (free, q, r)
            if outputs != "stats_rowcol":
                continue
            for name in tw.PLANES:
                if q and r:
                    np.testing.assert_array_equal(
                        out[f"{name}_row"][b, :len(r)],
                        getattr(g, f"{name}_row"))
                else:
                    # golden has no last row of an empty table: zeros, as
                    # the reference's kernels leave them
                    assert not out[f"{name}_row"][b].any()
                    assert not out[f"{name}_col"][b].any()


def test_empty_side_border_payloads():
    # ROADMAP Queue 3: default DNA matrix, open 5, ext 2, golden's border
    # payloads
    case = pack(list(zip(EMPTY_QS[:3], EMPTY_RS[:3])), IDENT, Qp=32, Rp=32)
    got = run_port(case, open_=5, ext=2, mode="nw", free=(False,) * 4,
                   outputs="stats", width="sat")
    row = [tuple(int(got[k][b]) for k in ("score", "end_query", "end_ref",
                                          "matches", "similar", "length"))
           for b in range(2)]
    assert row == [(-11, -1, 3, 0, 0, 4), (-11, 3, -1, 0, 0, 4)]
    got = run_port(case, open_=5, ext=2, mode="sg", free=(True,) * 4,
                   outputs="stats", width="sat")
    assert tuple(int(got[k][0]) for k in (
        "score", "end_query", "end_ref", "matches", "similar", "length")) \
        == (0, -1, 0, 0, 0, 0)


def test_width_flags_and_shared_profile():
    # a (1, Qp, A) profile and (1, Qp) letters broadcast over the batch;
    # width sat reports the 16-bit flag and promotes on the 8-bit one
    m = Matrix.create(DNA, 3, -2)
    q = b"A" * 60
    refs = [b"A" * 60, b"A" * 20, b"C" * 30]
    case = pack([(q, r) for r in refs], m, Qp=64, Rp=64)
    case["profile"] = case["profile"][:1]
    case["qidx"] = case["qidx"][:1]
    out = run_port(case, open_=1, ext=1, mode="nw", free=(False,) * 4,
                   outputs="stats", width="sat")
    assert list(out["promoted"]) == [True, False, False]
    assert not out["saturated"].any()
    for b, r in enumerate(refs):
        g = align_seqs(q, r, m, 1, 1, "nw")
        assert (int(out["score"][b]), int(out["matches"][b]),
                int(out["length"][b])) == (g.score, g.matches, g.length)
