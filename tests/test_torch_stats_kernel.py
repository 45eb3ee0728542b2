"""The port's stats, table and rowcol classes (kernel forms K1c and K1d)
against the JAX package and golden.

``score_align(..., outputs=cls)`` on CPU tensors (its plain version, the
wavefront) and the g++ build of the kernel's own header forms
(``csrc/score_cell.cuh`` through ``csrc/score_host.cc``) are held, on
identical numpy-seeded inputs, against:

- the JAX ``scan_score_align(..., outputs=cls)`` in interpret mode, as
  the JAX package's own tests run it, at open > ext (its one-pass stats
  payloads serve only that regime; int8-range scores, 128-pair batches):
  the scalars and stats, and the planes, rows and columns on each pair's
  in-sequence cells;
- the scalar ``golden.align`` oracle at every penalty pair, with both
  substitution forms, shared and per-pair profiles, BLOSUM62, a PSSM and
  an alphabet of 40.

Every comparison is exact: the outputs are integers.  The CUDA kernel is
compared with the plain version by the tests marked ``cuda``, which skip
without a card: ``python -m pytest --noconftest -m cuda
tests/test_torch_stats_kernel.py``.
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu.golden import model as golden  # noqa: E402
from parasail_rs_tpu.matrices import Matrix  # noqa: E402

from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402

from test_torch_kernel_host import host_lib, run_outputs_host  # noqa: E402,F401

B = 128            # the Pallas kernel takes batches padded to 128 pairs
SW, NW = (True,) * 4, (False,) * 4
CLASSES = ("stats", "table", "stats_table", "rowcol", "stats_rowcol")
SG_FREE = [(True, False, False, False), (False, True, False, False),
           (True, True, False, False), (False, False, True, False),
           (False, False, False, True), (False, False, True, True),
           (True, False, False, True), (False, True, True, False),
           (True, True, True, True)]
BLOSUM62 = Matrix.from_name("blosum62")
PSSM = Matrix.create_pssm(
    b"ACGT", np.random.default_rng(5).integers(-3, 6, size=40 * 4), 40)


def make_case(seed, *, A=6, lo=-5, hi=7, n=B, Qp=32, Rp=32, minlen=1,
              profile=False, shared=False, table=None):
    """Seeded ragged batch with query letters: an (A, A) table, or
    (1 or n, Qp, A) profile rows beside the letters."""
    if not isinstance(seed, int):
        seed = zlib.crc32(repr(seed).encode())
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
    case = dict(ridx=ridx, qlen=qlen, rlen=rlen, qidx=qidx)
    if profile:
        case["profile"] = rng.integers(lo, hi, size=(Bq, Qp, A)).astype(
            np.int32)
    else:
        case["table"] = (table if table is not None else
                         rng.integers(lo, hi, size=(A, A))).astype(np.int32)
    return case


def matrix_case(matrix, seed, alphabet, n=24, Qp=32, Rp=32):
    """Random sequences encoded by a Matrix: table form for a square one,
    shared position rows (the PSSM packing) with the letters beside."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    qs = [alpha[rng.integers(0, len(alpha), rng.integers(1, Qp - 1))]
          .tobytes() for _ in range(n)]
    rs = [alpha[rng.integers(0, len(alpha), rng.integers(1, Rp - 1))]
          .tobytes() for _ in range(n)]
    qidx = np.full((n, Qp), -1, np.int32)
    ridx = np.zeros((n, Rp), np.int32)
    for b in range(n):
        qidx[b, :len(qs[b])] = matrix.encode(qs[b])
        ridx[b, :len(rs[b])] = matrix.encode(rs[b])
    case = dict(ridx=ridx, qidx=qidx,
                qlen=np.array([len(q) for q in qs], np.int32),
                rlen=np.array([len(r) for r in rs], np.int32))
    if matrix.is_square:
        case["table"] = matrix.data.astype(np.int32)
    else:
        case["profile"] = matrix.data[np.arange(Qp) % matrix.length][None] \
            .astype(np.int32)
    return case


def dense_rows(case):
    if "profile" in case:
        return case["profile"]
    table, qidx = case["table"], case["qidx"]
    rows = table[np.clip(qidx, 0, table.shape[0] - 1)]
    return np.where((qidx >= 0)[..., None], rows, 0).astype(np.int32)


def run_plain(case, outputs, device="cpu", **kw):
    t = {k: torch.from_numpy(v).to(device) for k, v in case.items()}
    out = tk.score_align(t.pop("ridx"), t.pop("qlen"), t.pop("rlen"),
                         outputs=outputs, **kw, **t)
    return {k: v.cpu().numpy() for k, v in out.items()}


def run_jax(case, outputs, **kw):
    from parasail_rs_tpu.ops.scan_kernel import scan_score_align

    kw = dict(kw, open_=np.int32(kw["open_"]), ext=np.int32(kw["ext"]))
    out = scan_score_align(dense_rows(case), case["ridx"], case["qlen"],
                           case["rlen"], case["qidx"], outputs=outputs,
                           interpret=True, **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def in_sequence(v, k, b, ql, rl):
    if k.endswith("_table"):
        return v[b, :ql, :rl]
    if k.endswith("_row"):
        return v[b, :rl]
    if k.endswith("_col"):
        return v[b, :ql]
    return v[b]


def assert_same(got, want, case, what):
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for b in range(len(case["qlen"])):
        ql, rl = int(case["qlen"][b]), int(case["rlen"][b])
        for k in want:
            np.testing.assert_array_equal(
                in_sequence(got[k], k, b, ql, rl),
                in_sequence(want[k], k, b, ql, rl), err_msg=f"{what}/{k}/{b}")


def golden_pair(case, b, open_, ext, mode, free):
    rows = dense_rows(case)
    ql, rl = int(case["qlen"][b]), int(case["rlen"][b])
    p = rows[0 if rows.shape[0] == 1 else b, :ql]
    ri = case["ridx"][b, :rl]
    qi = case["qidx"][0 if case["qidx"].shape[0] == 1 else b, :ql]
    sub = p[np.arange(ql)[:, None], ri[None, :]]
    return golden.align(sub.astype(np.int64), qi[:, None] == ri[None, :],
                        open_, ext, mode, free)


def assert_matches_golden(case, got, open_, ext, mode, free, what):
    for b in range(len(case["qlen"])):
        ql, rl = int(case["qlen"][b]), int(case["rlen"][b])
        g = golden_pair(case, b, open_, ext, mode, free)
        for k, v in got.items():
            if k in ("saturated", "promoted"):
                continue
            np.testing.assert_array_equal(
                in_sequence(v, k, b, ql, rl), getattr(g, k),
                err_msg=f"{what}/{k}/{b}")


# name -> (case, (outputs, mode, free, open, ext, width)); open > ext
JAX_CASES = {
    "stats_nw_table": (("t", 1), ("stats", "nw", NW, 11, 1, "sat")),
    "stats_sg_qb_de_table": (("t", 2), ("stats", "sg", SG_FREE[6], 5, 2,
                                        "sat")),
    "stats_sg_qe_db_profile": (("p", 3), ("stats", "sg", SG_FREE[7], 11, 1,
                                          "16")),
    "stats_sw_shared_profile": (("s", 4), ("stats", "sw", SW, 11, 1, "sat")),
    "table_sw": (("t", 5), ("table", "sw", SW, 11, 1, "sat")),
    "stats_table_nw": (("t", 6), ("stats_table", "nw", NW, 4, 2, "32")),
    "stats_table_sg_qb_de": (("p", 7), ("stats_table", "sg", SG_FREE[6], 5,
                                        2, "sat")),
    "rowcol_sg": (("t", 8), ("rowcol", "sg", SG_FREE[8], 5, 2, "sat")),
    "stats_rowcol_sw": (("t", 9), ("stats_rowcol", "sw", SW, 11, 1, "8")),
    "stats_rowcol_nw_profile": (("p", 10), ("stats_rowcol", "nw", NW, 11, 1,
                                            "sat")),
}


def _jax_case(form, seed):
    return make_case(seed, profile=form in "ps", shared=form == "s",
                     lo=-4, hi=8)


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_plain_and_host_match_jax_scan_kernel(name, host_lib):
    (form, seed), (outputs, mode, free, open_, ext, width) = JAX_CASES[name]
    case = _jax_case(form, seed)
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, width=width)
    want = run_jax(case, outputs, **kw)
    got = run_plain(case, outputs, **kw)
    assert_same(got, want, case, f"plain {name}")
    host = run_outputs_host(host_lib, outputs, **case, **kw)
    assert set(host) == set(got)
    for k in got:
        np.testing.assert_array_equal(host[k], got[k], err_msg=k)


GRID = ([(m, f, o, e) for m, f in (("nw", NW), ("sw", SW))
         for o, e in ((11, 1), (5, 2), (1, 3), (0, 0), (2, 2), (0, 1))] +
        [("sg", f, 5, 2) for f in SG_FREE] +
        [("sg", f, o, e) for f in SG_FREE[6:] for o, e in ((1, 3), (2, 2))])


@pytest.mark.parametrize("mode,free,open_,ext", GRID)
def test_plain_matches_golden(mode, free, open_, ext):
    case = make_case(("golden", mode, free, open_, ext), n=20, Qp=24, Rp=24)
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, width="32")
    for outputs in ("stats_table", "stats_rowcol"):
        got = run_plain(case, outputs, **kw)
        assert_matches_golden(case, got, open_, ext, mode, free,
                              f"{outputs}/{mode}/{free}/{open_},{ext}")


FORMS = {
    "profile_per_pair": (lambda: make_case(11, n=20, profile=True, lo=-4,
                                           hi=12), SW, "sw", 11, 1),
    "profile_shared": (lambda: make_case(12, n=20, profile=True,
                                         shared=True), NW, "nw", 1, 3),
    "blosum62_sg": (lambda: matrix_case(BLOSUM62, 13,
                                        b"ARNDCQEGHILKMFPSTWYV"),
                    (False, True, True, False), "sg", 2, 2),
    "pssm_sw": (lambda: matrix_case(PSSM, 14, b"ACGT"), SW, "sw", 5, 2),
    "alphabet_40": (lambda: make_case(15, n=20, A=40), NW, "nw", 11, 1),
    "scores_beyond_int8": (lambda: make_case(16, n=20, lo=-300, hi=400),
                           SW, "sw", 11, 1),
}


@pytest.mark.parametrize("name", sorted(FORMS))
def test_plain_forms_match_golden(name, host_lib):
    make, free, mode, open_, ext = FORMS[name]
    case = make()
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, width="sat")
    for outputs in ("stats", "stats_table", "stats_rowcol"):
        got = run_plain(case, outputs, **kw)
        assert_matches_golden(case, got, open_, ext, mode, free,
                              f"{name}/{outputs}")
        host = run_outputs_host(host_lib, outputs, **case, **kw)
        for k in got:
            np.testing.assert_array_equal(host[k], got[k], err_msg=k)


def test_matches_compares_letters_not_scores():
    # a letter pair that scores > 0 but differs is similar, not a match;
    # an equal pair outside the table's letters scores 0: a match that is
    # not similar (golden/model.py:268-270)
    table = np.array([[2, 1], [1, 2]], np.int32)
    case = dict(table=table, qidx=np.array([[0, 1, 7]], np.int32),
                ridx=np.array([[1, 1, 7]], np.int32),
                qlen=np.array([3], np.int32), rlen=np.array([3], np.int32))
    got = run_plain(case, "stats", open_=5, ext=1, mode="nw", free=NW,
                    width="32")
    assert (int(got["matches"][0]), int(got["similar"][0]),
            int(got["length"][0]), int(got["score"][0])) == (2, 2, 3, 3)


def test_wrapper_needs_letters_for_stats_in_the_profile_form():
    case = make_case(17, n=4, profile=True)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    kw = dict(open_=5, ext=2, mode="sw", free=SW, width="sat")
    with pytest.raises(ValueError, match="needs qidx"):
        tk.score_align(t["ridx"], t["qlen"], t["rlen"], profile=t["profile"],
                       outputs="stats", **kw)
    # outside the stats classes the profile form takes no letters
    out = tk.score_align(t["ridx"], t["qlen"], t["rlen"],
                         profile=t["profile"], outputs="rowcol", **kw)
    assert set(out) >= {"score_row", "score_col"}
    with pytest.raises(ValueError, match="qidx"):
        tk.score_align(t["ridx"], t["qlen"], t["rlen"], profile=t["profile"],
                       qidx=t["qidx"][:, :5], outputs="stats", **kw)


def test_wrapper_runs_the_wavefront_on_cpu(monkeypatch):
    from parasail_rs_tpu_torch.ops import scan_kernel

    case = make_case(18, n=8)
    calls = []
    real = scan_kernel.wavefront_align
    monkeypatch.setattr(scan_kernel, "wavefront_align",
                        lambda *a, **k: calls.append(k["outputs"]) or
                        real(*a, **k))
    before = (dict(tk.SHORT_LAUNCHES), tk.CHUNKED_LAUNCHES)
    for outputs in CLASSES:
        run_plain(case, outputs, open_=5, ext=2, mode="sw", free=SW,
                  width="sat")
    assert calls == list(CLASSES)
    assert (tk.SHORT_LAUNCHES, tk.CHUNKED_LAUNCHES) == before


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", CLASSES)
@pytest.mark.parametrize("mode,free,open_,ext", GRID)
def test_kernel_matches_plain_on_card(mode, free, open_, ext, outputs,
                                      cuda_device):
    case = make_case(("card", mode, free, open_, ext), minlen=0)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in case.items()}
    args = (t.pop("ridx"), t.pop("qlen"), t.pop("rlen"))
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, width="sat",
              outputs=outputs, **t)
    # every class is the short form's
    before = tk.SHORT_LAUNCHES[outputs]
    got = tk.score_align(*args, **kw)
    torch.cuda.synchronize()
    assert tk.SHORT_LAUNCHES[outputs] == before + 1
    want = tk.score_align_plain(*args, **kw)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FORMS))
def test_kernel_forms_match_plain_on_card(name, cuda_device):
    make, free, mode, open_, ext = FORMS[name]
    case = make()
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, width="sat")
    for outputs in CLASSES:
        got = run_plain(case, outputs, device=cuda_device, **kw)
        want = run_plain(case, outputs, **kw)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# (padded query rows, reference columns, pairs, form) of the plane classes
# on the short form: whole vector stores at 4 and 8 rows a lane (Qp a
# multiple of 4), pairs of words at 6, word by word at 5 and where Qp
# does not align them (130, 250), lanes' edges, the single pair, and
# BLOSUM62 pairs padded as the API pads them (192 x 192)
SHORT_PLANES = {
    "table_128": (128, 40, 48, "table"),
    "profile_130": (130, 40, 48, "profile"),
    "table_186": (186, 33, 48, "table"),
    "shared_profile_192": (192, 40, 32, "shared"),
    "table_250": (250, 24, 32, "table"),
    "single_pair_160": (160, 160, 1, "table"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", CLASSES[1:])
@pytest.mark.parametrize("name", sorted(SHORT_PLANES))
def test_short_planes_match_plain_on_card(name, outputs, cuda_device):
    Qp, Rp, n, form = SHORT_PLANES[name]
    case = make_case(("short planes", name), n=n, Qp=Qp, Rp=Rp, minlen=0,
                     profile=form != "table", shared=form == "shared",
                     lo=-4, hi=12)
    kR = tk.short_plan(outputs, n, case["qidx"].shape[0], Qp, Rp, 6,
                       form != "table")[0]
    assert kR in (4, 5, 6, 8)
    if form != "shared":
        # the last row the last of a lane, one short of it, the first of
        # the next, and the whole query
        edges = (kR * (Qp // kR - 1), kR * (Qp // kR - 1) - 1,
                 kR * (Qp // kR - 1) + 1, Qp)[:n]
        case["qlen"][:len(edges)] = edges
        case["qidx"][:len(edges)] = np.random.default_rng(Qp).integers(
            0, 6, size=(len(edges), Qp))
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in case.items()}
    args = (t.pop("ridx"), t.pop("qlen"), t.pop("rlen"))
    for mode, free, open_, ext in (("sw", SW, 11, 1), ("nw", NW, 1, 3),
                                   ("sg", SG_FREE[6], 2, 2)):
        kw = dict(open_=open_, ext=ext, mode=mode, free=free, width="sat",
                  outputs=outputs, **t)
        before = tk.SHORT_LAUNCHES[outputs]
        got = tk.score_align(*args, **kw)
        torch.cuda.synchronize()
        assert tk.SHORT_LAUNCHES[outputs] == before + 1
        want = tk.score_align_plain(*args, **kw)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, mode, k)
