"""The tiled traceback walk (``csrc/trace_walk.cu``, a warp a pair over
32 x 64 tiles of the flag plane), built with g++, against the plain walk,
the one-thread walk and the JAX walk.

``csrc/walk_step.cuh``'s ``walk_pair_tiled`` is the kernel's own loop:
the first tile ends at the walk's first cell, the tiles above, left and
above-left are copied while it walks, the opcodes leave from a stage of
128 bytes and the leading gaps as one run.  ``csrc/score_host.cc``'s
``pt_walk_tiled_host`` runs that loop over tiles copied on the host
(cells the walk must not read poisoned), and must give exactly the
opcode rows and begin cells of ``device_walk_plain``, of ``walk_pair``
(``pt_walk_host``) and of the JAX ``device_walk``: on paths that cross
tiles through their corners, a local walk that stops in its first tile,
leading-gap tails longer than the stage, rows that are or are not a
multiple of 16 bytes, batch-last (strided) planes, a query row shared by
every pair, and raw bytes that decide ``=`` against ``X``.  The opcode
row arrives filled with garbage: the loop writes it whole.  The CUDA
kernel is held to the plain walk by the tests marked ``cuda``.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu.constants import cigar_runs_string  # noqa: E402
from parasail_rs_tpu.golden import model as golden  # noqa: E402
from parasail_rs_tpu.matrices import Matrix  # noqa: E402

from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402
from parasail_rs_tpu_torch.ops import trace_walk as tw  # noqa: E402

from test_torch_kernel_host import build_host_lib, run_host_walk  # noqa: E402
from test_torch_trace_walk import walk_jax  # noqa: E402

SW, NW = (True,) * 4, (False,) * 4
DNA = Matrix.create(b"ACGT", 2, -3)
MODES = [("nw", NW), ("sw", SW), ("sg", SW), ("sg", (False, True, False,
                                                     False)),
         ("sg", (True, False, False, True)), ("sg", (False, False, True,
                                                     True))]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host_lib(tmp_path_factory)
    lib.pt_walk_tiled_host.restype = ctypes.c_int
    lib.pt_walk_tiled_host.argtypes = ([ctypes.c_void_p] +
                                       [ctypes.c_longlong] * 3 +
                                       [ctypes.c_void_p] * 6 +
                                       [ctypes.c_int] * 7)
    return lib


def run_tiled(lib, plane, qsym, rsym, end_q, end_r, mode, free,
              strided=False):
    """``pt_walk_tiled_host`` on a (B, Qp, Rp) plane, handed over as it is
    or batch-last ((Qp, Rp, B) memory, the banded classes' layout)."""
    B, Qp, Rp = plane.shape
    local, qb, db = tw._walk_flags(mode, free)
    if strided:
        buf = np.ascontiguousarray(plane.transpose(1, 2, 0), np.int8)
        sb, si, sj = 1, Rp * B, B
    else:
        buf = np.ascontiguousarray(plane, np.int8)
        sb, si, sj = Qp * Rp, Rp, 1
    ops = np.full((B, Qp + Rp), 0xEE, np.uint8)
    beg = np.zeros((2, B), np.int32)
    arrs = [np.ascontiguousarray(a, np.int32)
            for a in (qsym, rsym, end_q, end_r)]
    assert lib.pt_walk_tiled_host(
        buf.ctypes.data, sb, si, sj, *(a.ctypes.data for a in arrs),
        ops.ctypes.data, beg.ctypes.data, B, qsym.shape[0], Qp, Rp,
        int(local), int(qb), int(db)) == 0
    return ops, beg[0], beg[1]


def run_plain(plane, qsym, rsym, end_q, end_r, mode, free):
    got = tw.device_walk(*(torch.from_numpy(np.ascontiguousarray(a)) for a in
                           (plane, qsym, rsym, end_q, end_r)), mode, free)
    return tuple(x.numpy() for x in got)


def assert_same(got, want, what=""):
    for g, w, name in zip(got, want, ("ops", "beg_q", "beg_r")):
        np.testing.assert_array_equal(g, w, err_msg=f"{name} {what}")


def check_all(lib, plane, qsym, rsym, end_q, end_r, mode, free, jax=True):
    """The tiled walk, contiguous and batch-last, against the plain walk,
    the one-thread walk and (``jax``) the JAX walk."""
    want = run_plain(plane, qsym, rsym, end_q, end_r, mode, free)
    for strided in (False, True):
        assert_same(run_tiled(lib, plane, qsym, rsym, end_q, end_r, mode,
                              free, strided), want, f"strided={strided}")
    ops, beg = run_host_walk(lib, plane, qsym, rsym, end_q, end_r, mode,
                             free)
    assert_same((ops, beg[0], beg[1]), want, "walk_pair")
    if jax:
        assert_same(walk_jax(plane, qsym, rsym, (end_q, end_r), mode, free),
                    want, "jax")
    return want


def trace_case(seed, mode, free, B, Qp, Rp, open_=5, ext=2, similar=0.0,
               lens=None):
    """A DNA batch through the plain trace class: (plane, qidx, ridx,
    end_q, end_r), each query a copy of its reference mutated at the rate
    1 - ``similar`` (0: unrelated), lengths ``lens`` or drawn."""
    rng = np.random.default_rng(seed)
    qidx = np.full((B, Qp), -1, np.int32)
    ridx = np.zeros((B, Rp), np.int32)
    if lens is None:
        lens = [(int(rng.integers(1, Qp + 1)), int(rng.integers(1, Rp + 1)))
                for _ in range(B)]
    for b, (ql, rl) in enumerate(lens):
        ridx[b, :rl] = rng.integers(0, 4, size=rl)
        q = rng.integers(0, 4, size=ql)
        n = min(ql, rl)
        keep = rng.random(n) < similar
        q[:n] = np.where(keep, ridx[b, :n], q[:n])
        qidx[b, :ql] = q
    return plain_trace(qidx, ridx, [a for a, _ in lens],
                       [b for _, b in lens], mode, free, open_, ext)


def plain_trace(qidx, ridx, qlen, rlen, mode, free, open_=5, ext=2):
    """(plane, qidx, ridx, end_q, end_r) of the plain trace class."""
    out = tk.score_align(
        torch.from_numpy(ridx), torch.tensor(qlen, dtype=torch.int32),
        torch.tensor(rlen, dtype=torch.int32), open_=open_, ext=ext,
        mode=mode, free=free,
        table=torch.from_numpy(DNA.data.astype(np.int32)),
        qidx=torch.from_numpy(qidx), outputs="trace")
    return (out["trace_table"].numpy(), qidx, ridx,
            out["end_query"].numpy(), out["end_ref"].numpy())


@pytest.mark.parametrize("mode,free", MODES)
@pytest.mark.parametrize("open_,ext", [(5, 2), (1, 3), (2, 2)])
def test_tiled_walk_matches_plain_one_thread_and_jax(host_lib, mode, free,
                                                     open_, ext):
    # ragged pairs up to 70 x 150: several tiles each way, Rp not a
    # multiple of 16
    plane, q, r, eq, er = trace_case([MODES.index((mode, free)), open_, ext],
                                     mode, free, 8, 70, 150, open_, ext,
                                     similar=0.6)
    check_all(host_lib, plane, q, r, eq, er, mode, free)


@pytest.mark.parametrize("n", [96, 111, 112, 127, 160])
def test_tiled_walk_crosses_tile_corners(host_lib, n):
    # identical pairs: the diagonal path leaves a tile through its corner
    # where the end column is 15 modulo 16 (n = 112, 160: j = n - 1), and
    # through its top or its side elsewhere; Rp = n + 16 keeps the rows a
    # multiple of 16 bytes where n is
    lens = [(n, n), (n - 5, n), (n, n - 9), (n - 40, n)]
    plane, q, r, eq, er = trace_case(n, "nw", NW, len(lens), n, n + 16,
                                     similar=1.0, lens=lens)
    ops = check_all(host_lib, plane, q, r, eq, er, "nw", NW, jax=False)[0]
    assert (ops[0][:n] == tw.OP_EQ).all() and not ops[0][n:].any()


def test_tiled_walk_local_stop_in_first_tile(host_lib):
    # a short local match deep inside unrelated letters: the walk stops
    # (hflag 0) within the tile it started in
    rng = np.random.default_rng(5)
    qi = np.full((1, 96), -1, np.int32)
    ri = np.zeros((1, 128), np.int32)
    qi[0, :90] = rng.integers(0, 4, size=90)
    ri[0, :120] = rng.integers(0, 4, size=120)
    ri[0, 70:82] = qi[0, 40:52]
    plane, qi, ri, eq, er = plain_trace(qi, ri, [90], [120], "sw", SW)
    ops, bq, br = check_all(host_lib, plane, qi, ri, eq, er, "sw", SW)
    steps = int(np.count_nonzero(ops[0]))
    assert 0 < steps < 32 and eq[0] - bq[0] < 32 and er[0] - br[0] < 48


@pytest.mark.parametrize("mode,free", [("nw", NW), ("sg", (True, False,
                                                           False, False)),
                                       ("sg", (False, False, True, False))])
def test_tiled_walk_leading_gap_tails(host_lib, mode, free):
    # one side far longer than the other: after the short side is spent
    # the walk emits a run of I (or D) longer than the 128-byte stage,
    # unless that side's begin is free; ends at -1 start in the tail
    lens = [(300, 6), (7, 290), (200, 200), (1, 1)]
    plane, q, r, eq, er = trace_case(17, mode, free, len(lens), 300, 300,
                                     lens=lens)
    check_all(host_lib, plane, q, r, eq, er, mode, free)
    eq2 = np.array([-1, 5, -1, 0], np.int32)
    er2 = np.array([3, -1, -1, -1], np.int32)
    check_all(host_lib, plane, q, r, eq2, er2, mode, free, jax=False)


def test_tiled_walk_shared_query_symbols_and_raw_bytes(host_lib):
    # one (1, Qp) query row for every pair; lowercase query bytes against
    # uppercase reference bytes make every diagonal an 'X'
    n = 80
    qb = np.frombuffer(b"acgt" * (n // 4), np.uint8)
    rb = np.frombuffer(b"ACGT" * (n // 4), np.uint8)
    g = golden.align_seqs(qb.tobytes(), rb.tobytes(), Matrix.default(), 5,
                          2, "nw")
    B = 3
    plane = np.repeat(g.trace_table[None], B, axis=0)
    eq = np.full(B, g.end_query, np.int32)
    er = np.full(B, g.end_ref, np.int32)
    q1 = qb[None].astype(np.int32)
    r1 = np.repeat(rb[None], B, axis=0).astype(np.int32)
    ops = check_all(host_lib, plane, q1, r1, eq, er, "nw", NW)[0]
    assert cigar_runs_string(tw.ops_to_runs(ops[0])) == f"{n}X"
    m = Matrix.default()
    qi = m.encode(qb.tobytes())[None].astype(np.int32)
    ri = np.repeat(m.encode(rb.tobytes())[None], B, axis=0).astype(np.int32)
    ops = check_all(host_lib, plane, qi, ri, eq, er, "nw", NW)[0]
    assert cigar_runs_string(tw.ops_to_runs(ops[1])) == f"{n}="


@pytest.mark.parametrize("seed", range(6))
def test_tiled_walk_random_flags_and_ends(host_lib, seed):
    # any flags, end cells anywhere from -1 to one past the plane (read at
    # its edge, as the plain walk reads it), every mode's begin flags
    rng = np.random.default_rng(seed)
    B, Qp, Rp = 6, int(rng.integers(20, 140)), int(rng.integers(20, 140))
    h = rng.choice([0, 1, 2, 4], size=(B, Qp, Rp), p=[0.02, 0.2, 0.2, 0.58])
    plane = (h | rng.choice([8, 16], size=h.shape) |
             rng.choice([32, 64], size=h.shape)).astype(np.int8)
    q = rng.integers(0, 3, size=(1 if seed % 2 else B, Qp)).astype(np.int32)
    r = rng.integers(0, 3, size=(B, Rp)).astype(np.int32)
    eq = rng.integers(-1, Qp + 1, size=B).astype(np.int32)
    er = rng.integers(-1, Rp + 1, size=B).astype(np.int32)
    eq[0], er[0] = Qp, Rp
    for mode, free in (("nw", NW), ("sw", SW), ("sg", (True, False, False,
                                                       True))):
        check_all(host_lib, plane, q, r, eq, er, mode, free, jax=False)


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Rp", [150, 160])
@pytest.mark.parametrize("strided", [False, True])
def test_tiled_walk_kernel_matches_plain_on_card(Rp, strided, cuda_device):
    # 16-byte copies (contiguous rows of 160) and byte copies (rows of
    # 150, batch-last planes), tile corners, tails and local stops
    for mode, free in MODES:
        plane, q, r, eq, er = trace_case(Rp + len(mode), mode, free, 64,
                                         140, Rp, similar=0.7)
        if strided:
            dev_plane = torch.from_numpy(np.ascontiguousarray(
                plane.transpose(1, 2, 0))).to(cuda_device).permute(2, 0, 1)
        else:
            dev_plane = torch.from_numpy(plane).to(cuda_device)
        args = [dev_plane] + [torch.from_numpy(a).to(cuda_device)
                              for a in (q, r, eq, er)]
        before = tw.LAUNCHES
        got = tw.device_walk(*args, mode, free)
        torch.cuda.synchronize()
        assert tw.LAUNCHES == before + 1
        want = tw.device_walk_plain(*args, mode, free)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (mode, free, Rp, strided)


@pytest.mark.cuda
def test_tiled_walk_kernel_long_global_paths_on_card(cuda_device):
    # 1,024 bp NW pairs, each query a 10%-mutated copy of its reference:
    # paths of about 2,000 steps over some sixty tiles, ends past the
    # plane and at -1
    plane, q, r, eq, er = trace_case(29, "nw", NW, 16, 1024, 1024,
                                     similar=0.9,
                                     lens=[(1024 - k, 1024) for k in
                                           range(16)])
    eq[1], er[2] = -1, -1
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (plane, q, r, eq, er)]
    got = tw.device_walk(*args, "nw", NW)
    want = tw.device_walk_plain(*args, "nw", NW)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
