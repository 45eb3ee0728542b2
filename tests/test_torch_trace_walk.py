"""The port's traceback walk against the JAX package and golden.

``device_walk`` on CPU tensors (its plain PyTorch version,
``device_walk_plain``) is held, on flag planes from golden and from the
port's plain trace kernel, against the JAX ``device_walk`` (jit on the
CPU) and golden ``walk_trace``: opcode rows, begin cells and CIGAR
strings, exactly.  The numpy encoders copied from the JAX module must
stay equal to their originals.  The CUDA walk is compared with the plain
version by the ``cuda`` tests, which skip without a card:
``python -m pytest --noconftest -m cuda tests/test_torch_trace_walk.py``.
"""

import ast
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu.constants import cigar_runs_string  # noqa: E402
from parasail_rs_tpu.golden import model as golden  # noqa: E402
from parasail_rs_tpu.matrices import Matrix  # noqa: E402

from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402
from parasail_rs_tpu_torch.ops import trace_walk as tw  # noqa: E402

SW, NW = (True,) * 4, (False,) * 4
DNA = Matrix.create(b"ACGT", 2, -3)
MODES = [("nw", NW), ("sw", SW), ("sg", SW), ("sg", (False, True, False,
                                                     False)),
         ("sg", (True, False, False, True)), ("sg", (False, False, True,
                                                     True))]


def golden_planes(seed, mode, free, open_, ext, n=12, Qp=24, Rp=26,
                  minlen=0, alphabet=b"ACGT", matrix=DNA):
    """Golden trace planes of a seeded ragged batch, padded into
    (n, Qp, Rp), with byte planes and golden's end cells."""
    rng = np.random.default_rng(seed)
    alpha = list(alphabet)
    qs = [rng.choice(alpha, size=rng.integers(minlen, Qp + 1)).astype(
        np.uint8).tobytes() for _ in range(n)]
    rs = [rng.choice(alpha, size=rng.integers(minlen, Rp + 1)).astype(
        np.uint8).tobytes() for _ in range(n)]
    plane = np.zeros((n, Qp, Rp), np.int8)
    qb = np.zeros((n, Qp), np.uint8)
    rb = np.zeros((n, Rp), np.uint8)
    ends = np.zeros((2, n), np.int32)
    for b, (q, r) in enumerate(zip(qs, rs)):
        qb[b, :len(q)] = np.frombuffer(q, np.uint8)
        rb[b, :len(r)] = np.frombuffer(r, np.uint8)
        if mode == "sw" and not (q and r):
            continue          # empty local alignment at (0, 0)
        g = golden.align_seqs(q, r, matrix, open_, ext, mode, free)
        plane[b, :len(q), :len(r)] = g.trace_table
        ends[:, b] = g.end_query, g.end_ref
    return qs, rs, plane, qb, rb, ends


def walk_plain(plane, qsym, rsym, ends, mode, free):
    ops, bq, br = tw.device_walk(
        torch.from_numpy(plane), torch.from_numpy(qsym),
        torch.from_numpy(rsym), torch.from_numpy(ends[0]),
        torch.from_numpy(ends[1]), mode, free)
    return ops.numpy(), bq.numpy(), br.numpy()


def walk_jax(plane, qsym, rsym, ends, mode, free):
    from parasail_rs_tpu.ops.trace_walk import device_walk

    ops, bq, br = device_walk(plane, qsym.astype(np.int32),
                              rsym.astype(np.int32), ends[0], ends[1],
                              mode, free)
    return np.asarray(ops), np.asarray(bq), np.asarray(br)


def assert_walks_equal(got, want):
    for g, w, name in zip(got, want, ("ops", "beg_q", "beg_r")):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("open_,ext", [(5, 2), (1, 3), (0, 0)])
@pytest.mark.parametrize("mode,free", MODES)
def test_plain_walk_matches_jax_and_golden(mode, free, open_, ext):
    qs, rs, plane, qb, rb, ends = golden_planes(
        hash((mode, free, open_, ext)) % 2 ** 32, mode, free, open_, ext)
    got = walk_plain(plane, qb, rb, ends, mode, free)
    assert_walks_equal(got, walk_jax(plane, qb, rb, ends, mode, free))
    ops, bq, br = got
    for b, (q, r) in enumerate(zip(qs, rs)):
        if mode == "sw" and not (q and r):
            # golden's walk cannot index an empty plane; the empty local
            # alignment at (0, 0) has no op and begins at (1, 1)
            assert not ops[b].any() and (bq[b], br[b]) == (1, 1)
            continue
        w = golden.walk_trace(plane[b, :len(q), :len(r)], q, r,
                              int(ends[0, b]), int(ends[1, b]), mode, free)
        assert cigar_runs_string(tw.ops_to_runs(ops[b])) == \
            w.cigar_string(), b
        assert (bq[b], br[b]) == (w.beg_query, w.beg_ref), b


@pytest.mark.parametrize("mode,free", MODES)
def test_plain_walk_over_plain_kernel_planes(mode, free):
    # the plane the port's own trace kernel gives, read through mapped
    # letters (the walk's symbols when a batch has no bytes)
    rng = np.random.default_rng(len(mode) + sum(free))
    B, Qp, Rp, A = 16, 20, 22, 5
    table = rng.integers(-3, 5, size=(A, A)).astype(np.int32)
    qlen = rng.integers(1, Qp + 1, size=B).astype(np.int32)
    rlen = rng.integers(1, Rp + 1, size=B).astype(np.int32)
    qidx = np.full((B, Qp), -1, np.int32)
    ridx = np.zeros((B, Rp), np.int32)
    for b in range(B):
        qidx[b, :qlen[b]] = rng.integers(0, A, size=qlen[b])
        ridx[b, :rlen[b]] = rng.integers(0, A, size=rlen[b])
    out = tk.score_align(torch.from_numpy(ridx), torch.from_numpy(qlen),
                         torch.from_numpy(rlen), open_=4, ext=1, mode=mode,
                         free=free, table=torch.from_numpy(table),
                         qidx=torch.from_numpy(qidx), outputs="trace")
    plane = out["trace_table"].numpy()
    ends = np.stack([out["end_query"].numpy(), out["end_ref"].numpy()])
    got = walk_plain(plane, qidx, ridx, ends, mode, free)
    assert_walks_equal(got, walk_jax(plane, qidx, ridx, ends, mode, free))
    for b in range(B):
        w = golden.walk_trace(plane[b, :qlen[b], :rlen[b]],
                              bytes(qidx[b, :qlen[b]].astype(np.uint8)),
                              bytes(ridx[b, :rlen[b]].astype(np.uint8)),
                              int(ends[0, b]), int(ends[1, b]), mode, free)
        assert cigar_runs_string(tw.ops_to_runs(got[0][b])) == \
            w.cigar_string(), b


def test_plain_walk_shared_query_symbols_and_strided_plane():
    # a (1, Qp) query row serves every pair, and the plane may come as a
    # permuted view (the trace kernel's layout on the card)
    qs, rs, plane, qb, rb, ends = golden_planes(
        3, "sw", SW, 5, 2, minlen=1)
    q0 = qb[:1]
    strided = torch.from_numpy(
        np.ascontiguousarray(plane.transpose(1, 2, 0))).permute(2, 0, 1)
    ops, bq, br = tw.device_walk(
        strided, torch.from_numpy(q0), torch.from_numpy(rb),
        torch.from_numpy(ends[0]), torch.from_numpy(ends[1]), "sw", SW)
    want = walk_jax(plane, q0, rb, ends, "sw", SW)
    assert_walks_equal((ops.numpy(), bq.numpy(), br.numpy()), want)


def test_walk_raw_bytes_decide_eq_against_x():
    # lowercase query letters fold to the same index as uppercase, but
    # '=' vs 'X' compares raw bytes, as golden does
    q, r = b"acgt", b"ACGT"
    g = golden.align_seqs(q, r, Matrix.default(), 5, 2, "nw")
    plane = g.trace_table[None]
    ends = np.array([[g.end_query], [g.end_ref]], np.int32)
    qb = np.frombuffer(q, np.uint8)[None].copy()
    rb = np.frombuffer(r, np.uint8)[None].copy()
    ops, _, _ = walk_plain(plane, qb, rb, ends, "nw", NW)
    assert cigar_runs_string(tw.ops_to_runs(ops[0])) == "4X"
    m = Matrix.default()
    qi, ri = m.encode(q)[None].astype(np.int32), m.encode(r)[None].astype(
        np.int32)
    ops, _, _ = walk_plain(plane, qi, ri, ends, "nw", NW)
    assert cigar_runs_string(tw.ops_to_runs(ops[0])) == "4="


def test_walk_rejects_bad_inputs():
    plane = torch.zeros((2, 4, 5), dtype=torch.int8)
    q = torch.zeros((2, 4), dtype=torch.int32)
    r = torch.zeros((2, 5), dtype=torch.int32)
    e = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        tw.device_walk(plane.int(), q, r, e, e, "sw", SW)
    with pytest.raises(ValueError):
        tw.device_walk(plane, q[:, :3], r, e, e, "sw", SW)
    with pytest.raises(ValueError):
        tw.device_walk(plane, q, r, e[:1], e, "sw", SW)
    before = tw.LAUNCHES
    tw.device_walk(plane, q, r, e, e, "sw", SW)
    assert tw.LAUNCHES == before


# -- the numpy encoders copied from the JAX module --------------------------


def _body(fn) -> list[str]:
    """A function's source lines with its import statements set aside."""
    src = inspect.getsource(fn)
    drop = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            drop.update(range(node.lineno, node.end_lineno + 1))
    return [ln for n, ln in enumerate(src.splitlines(), 1) if n not in drop]


@pytest.mark.parametrize("name", ["ops_to_runs", "ops_to_runs_flat",
                                  "ops_to_runs_batch"])
def test_copied_encoder_matches_original(name):
    from parasail_rs_tpu.ops import trace_walk as jtw

    assert _body(getattr(tw, name)) == _body(getattr(jtw, name))


def test_copied_opcodes_match_original():
    from parasail_rs_tpu.ops import trace_walk as jtw

    assert (tw.OP_NONE, tw.OP_EQ, tw.OP_X, tw.OP_I, tw.OP_D) == \
        (jtw.OP_NONE, jtw.OP_EQ, jtw.OP_X, jtw.OP_I, jtw.OP_D)
    np.testing.assert_array_equal(tw._OP_TO_CIGAR, jtw._OP_TO_CIGAR)
    assert (tw._ST_H, tw._ST_E, tw._ST_F, tw._ST_DONE) == \
        (jtw._ST_H, jtw._ST_E, jtw._ST_F, jtw._ST_DONE)


@pytest.mark.parametrize("merge_m", [False, True])
def test_copied_encoders_give_the_originals_runs(merge_m):
    from parasail_rs_tpu.ops import trace_walk as jtw

    rng = np.random.default_rng(11)
    rows = []
    for n in (0, 1, 5, 37, 64):
        row = np.zeros(64, np.uint8)
        row[:n] = rng.integers(1, 5, n)
        rows.append(row)
    rows.append(np.tile([1, 3], 32).astype(np.uint8))
    ops = np.stack(rows)
    for got, want in zip(tw.ops_to_runs_batch(ops, merge_m),
                         jtw.ops_to_runs_batch(ops, merge_m)):
        np.testing.assert_array_equal(got, want)
    for row in ops:
        np.testing.assert_array_equal(tw.ops_to_runs(row, merge_m),
                                      jtw.ops_to_runs(row, merge_m))


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("open_,ext", [(5, 2), (1, 3), (0, 0)])
@pytest.mark.parametrize("mode,free", MODES)
def test_walk_kernel_matches_plain_on_card(mode, free, open_, ext,
                                           cuda_device):
    _qs, _rs, plane, qb, rb, ends = golden_planes(
        hash((mode, free, open_, ext)) % 2 ** 32, mode, free, open_, ext)
    args = [torch.from_numpy(x).to(cuda_device)
            for x in (plane, qb, rb, ends[0], ends[1])]
    before = tw.LAUNCHES
    got = tw.device_walk(*args, mode, free)
    torch.cuda.synchronize()
    assert tw.LAUNCHES == before + 1
    want = tw.device_walk_plain(*args, mode, free)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
