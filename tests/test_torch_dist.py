"""The port's ``dist`` layer against the JAX package's and golden.

Sequence parallelism (``seqpar_align_scan`` over the tile kernel's entry,
``seqpar_align`` over its plain version, ``seqpar_cigars``) on virtual
shards of one CPU device, and in two gloo processes with real halo
``send`` / ``recv``; data parallelism (``sharded_align``, ``align_global``)
against the reference's ``sharded_align`` on 8 CPU devices, on the cases
of tests/test_dist_routing.py.  Every comparison is exact.  The tests
marked ``cuda`` run the same entries on a card:
``python -m pytest --noconftest -m cuda tests/test_torch_dist.py``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu.golden import model as golden  # noqa: E402

from parasail_rs_tpu_torch import dist as tdist  # noqa: E402
from parasail_rs_tpu_torch.dist import multihost, seqpar_scan  # noqa: E402
from parasail_rs_tpu_torch.dist.sharded import (  # noqa: E402
    gather_scores,
    plan_sharded_route,
)
from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402

from test_torch_rowseg import (  # noqa: E402
    MODES,
    PROBLEM,
    dna_problem,
    one_shot,
    reference_rows,
    run_reference,
)
from test_torch_segment import CLASSES, check_golden, same  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def scan(case, D, qc, *, device="cpu", form="table", **kw):
    subs = (dict(profile=None, table=case["table"]) if form == "table"
            else dict(profile=reference_rows(case)))
    return host(tdist.seqpar_align_scan(
        subs.pop("profile"), case["ridx"], case["qlen"], case["rlen"],
        case["qidx"], mesh=tdist.make_device_mesh(D), q_chunk=qc,
        width="sat", device=device, **subs, **kw))


# -- sequence parallelism, virtual shards -----------------------------------------


@pytest.mark.parametrize("outputs", CLASSES)
@pytest.mark.parametrize("name", ["sw", "nw", "sg_qb_de", "sg_qe_db"])
def test_seqpar_align_scan_virtual_shards(name, outputs):
    mode, free = MODES[name]
    pen = dict(open_=5, ext=1, mode=mode, free=free)
    want = one_shot(PROBLEM, dict(pen, outputs=outputs, width="sat"))
    for D, qc, form in ((1, 256, "table"), (2, 128, "profile"),
                        (8, 64, "table")):
        got = scan(PROBLEM, D, qc, form=form, outputs=outputs, **pen)
        same(got, want, f"{name} {outputs} D {D}")
    check_golden(PROBLEM, got, pen, outputs)


def test_seqpar_align_scan_matches_the_reference():
    pen = dict(open_=5, ext=1, mode="sg", free=(True, False, False, True))
    for outputs in CLASSES:
        got = scan(PROBLEM, 8, 64, outputs=outputs, **pen)
        same(got, run_reference(PROBLEM, **pen, outputs=outputs, q_chunk=64),
             outputs)


@pytest.mark.parametrize("open_,ext", [(2, 2), (1, 3)])
def test_seqpar_stats_at_open_le_ext(open_, ext):
    # the reference refuses these in both of its forms; golden answers
    case = dna_problem(2, -3, ((100, 90), (128, 128), (31, 128)), 128, 128,
                       seed=ext)
    pen = dict(open_=open_, ext=ext, mode="sw", free=(True,) * 4)
    got = scan(case, 4, 32, outputs="stats", **pen)
    check_golden(case, got, pen, "stats")
    xla = host(tdist.seqpar_align(
        np.transpose(reference_rows(case), (1, 2, 0)), case["ridx"].T,
        case["qlen"], case["rlen"], case["qidx"].T,
        mesh=tdist.make_device_mesh(4), q_chunk=32, outputs="stats",
        width="sat", device="cpu", **pen))
    same(xla, got, "seqpar_align")


@pytest.mark.parametrize("name", ["sw", "nw", "sg_qb_de"])
def test_seqpar_align_and_cigars(name, monkeypatch):
    # tests/test_seqpar.py: the plain pipeline in the reference's
    # transposed layout, q_chunk 32, and the walk of the gathered plane
    from parasail_rs_tpu.matrices import Matrix

    mode, free = MODES[name]
    pen = dict(open_=5, ext=1, mode=mode, free=free)
    calls = []
    monkeypatch.setattr(
        tk, "score_rowseg_plain",
        lambda *a, _f=tk.score_rowseg_plain, **k: calls.append(1) or
        _f(*a, **k))
    out = tdist.seqpar_align(
        np.transpose(reference_rows(PROBLEM), (1, 2, 0)), PROBLEM["ridx"].T,
        PROBLEM["qlen"], PROBLEM["rlen"], mesh=tdist.make_device_mesh(8),
        q_chunk=32, outputs="trace", width="sat", device="cpu", **pen)
    assert len(calls) == 8 * 8            # S x D tiles of the plain version
    got = host(out)
    check_golden(PROBLEM, got, pen, "trace")
    m = Matrix.create(b"ACGT", 2, -3)
    letters = np.frombuffer(b"ACGT", np.uint8)
    pairs = [(letters[PROBLEM["qidx"][b, :ql]].tobytes(),
              letters[PROBLEM["ridx"][b, :rl]].tobytes())
             for b, (ql, rl) in enumerate(zip(PROBLEM["qlen"],
                                              PROBLEM["rlen"]))]
    assert all((m.encode(q) == PROBLEM["qidx"][b, :len(q)]).all()
               for b, (q, _) in enumerate(pairs))
    cigars = tdist.seqpar_cigars(out, [q for q, _ in pairs],
                                 [r for _, r in pairs], mode, free)
    for b, (q, r) in enumerate(pairs):
        g = golden.align_seqs(q, r, m, 5, 1, mode,
                              free if mode == "sg" else None)
        gw = golden.walk_trace(g.trace_table, q, r, g.end_query, g.end_ref,
                               mode, free)
        assert cigars[b] == gw.cigar_string(), (name, b)


def test_seqpar_scan_fits_gates_and_errors():
    fits = tdist.seqpar_scan_fits
    assert fits(256, 2048, 8, "score", 4)
    assert not fits(256, 2044, 8, "score", 4)             # Rp % D
    assert not fits(256, 2048, 8, "table", 4)             # output class
    assert not fits(256, 2048, 8, "score", 4, Qp=1000)    # Qp % q_chunk
    # the gates of the reference that the port drops
    assert fits(256, 2048, 8, "score", 64)                # any alphabet
    assert fits(252, 2048, 8, "score", 4)                 # any q_chunk
    assert fits(256, 2048, 8, "stats", 4, gap_open=2, gap_extend=2)
    assert fits(256, 2048, 8, "stats", 4, gap_open=1, gap_extend=2)
    # a shard's flags beyond 4 GiB decline the trace class
    assert fits(256, 1 << 14, 8, "trace", 4, Qp=1 << 14, batch=128)
    assert not fits(256, 1 << 20, 8, "trace", 4, Qp=1 << 19, batch=128)
    assert seqpar_scan.TRACE_SHARD_BYTES == 4 << 30
    mesh = tdist.make_device_mesh(8)
    args = (reference_rows(PROBLEM), PROBLEM["ridx"], PROBLEM["qlen"],
            PROBLEM["rlen"])
    kw = dict(open_=5, ext=1, mesh=mesh, mode="sw", q_chunk=64, device="cpu")
    with pytest.raises(ValueError, match="needs the mapped query"):
        tdist.seqpar_align_scan(*args, outputs="stats", **kw)
    with pytest.raises(ValueError, match="cannot serve"):
        tdist.seqpar_align_scan(*args, **{**kw, "q_chunk": 100})
    with pytest.raises(ValueError, match="serves"):
        tdist.seqpar_align_scan(*args, outputs="rowcol", **kw)
    if not torch.cuda.is_available():
        # device=None is the card: no card, no quiet move to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdist.seqpar_align_scan(*args, **{**kw, "device": None})
    with pytest.raises(ValueError, match="n_devices"):
        tdist.make_device_mesh(0)


# -- data parallelism ----------------------------------------------------------------------

ALPHA = list(b"ARNDCQEGHILKMFPSTWYV")


def protein_batch(seed, B, Qp=16, Rp=16, shared=False):
    """tests/test_dist_routing.py's batches: BLOSUM62 pairs of 4-13
    residues, as the reference's padded arrays."""
    from parasail_rs_tpu.engine.profile import profile_rows
    from parasail_rs_tpu.matrices import Matrix

    m = Matrix.from_name("blosum62")
    rng = np.random.default_rng(seed)
    nq = 1 if shared else B
    profile = np.zeros((nq, Qp, m.size), np.int32)
    qidx = np.full((nq, Qp), -1, np.int32)
    ridx = np.zeros((B, Rp), np.int32)
    qlen, rlen = np.zeros(B, np.int32), np.zeros(B, np.int32)
    pairs = []
    for b in range(B):
        if b < nq:
            q = rng.choice(ALPHA, size=rng.integers(4, 14)).astype(
                "uint8").tobytes()
            qi = m.encode(q)
            profile[b, :len(qi)] = profile_rows(m, qi)
            qidx[b, :len(qi)] = qi
        r = rng.choice(ALPHA, size=rng.integers(4, 14)).astype(
            "uint8").tobytes()
        ri = m.encode(r)
        ridx[b, :len(ri)] = ri
        qlen[b], rlen[b] = len(q), len(ri)
        pairs.append((q, r))
    return m, pairs, (profile, qidx, ridx, qlen, rlen)


DIST_CASES = {
    "score": dict(B=16, outputs="score", pen=(10, 1, "sw")),
    "stats": dict(B=16, outputs="stats", pen=(10, 1, "sw")),
    "odd_batch": dict(B=19, outputs="score", pen=(10, 1, "nw")),
    "shared_profile": dict(B=16, outputs="score", pen=(10, 1, "sw"),
                           shared=True),
    "stats_1_3": dict(B=16, outputs="stats", pen=(1, 3, "sw")),
    "stats_2_2": dict(B=16, outputs="stats", pen=(2, 2, "nw")),
    "stats_0_1": dict(B=16, outputs="stats", pen=(0, 1, "sg")),
    # beyond tests/test_dist_routing.py: classes with planes, golden only
    "trace": dict(B=16, outputs="trace", pen=(10, 1, "sg"), ref=False),
    "rowcol": dict(B=16, outputs="stats_rowcol", pen=(10, 1, "sw"),
                   ref=False),
    "table": dict(B=16, outputs="table", pen=(10, 1, "nw"), ref=False),
}


@pytest.mark.parametrize("name", sorted(DIST_CASES))
def test_sharded_align_matches_reference_and_golden(name, monkeypatch):
    from parasail_rs_tpu.dist import make_device_mesh as ref_mesh
    from parasail_rs_tpu.dist import sharded as ref_sharded

    cfg = DIST_CASES[name]
    open_, ext, mode = cfg["pen"]
    outputs = cfg["outputs"]
    free = golden.free_flags(mode)
    m, pairs, arrays = protein_batch(11 + cfg["B"], cfg["B"],
                                     shared=cfg.get("shared", False))
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs,
              width="sat")
    route = plan_sharded_route(
        outputs=outputs, gap_open=open_, gap_extend=ext,
        score_values=arrays[0], Qp=16, Rp=16, shard_batch=cfg["B"],
        device="cpu")
    assert route == "torch_plain"
    out = tdist.sharded_align(tdist.make_device_mesh(8), *arrays, **kw,
                              device="cpu")
    assert out.route == "torch_plain"
    got = gather_scores(out)
    assert got["score"].shape[0] == cfg["B"]
    # the reference on its 8 CPU devices: the Pallas route in interpret
    # mode, the walk route for stats at open <= ext
    ref = {}
    if cfg.get("ref", True):
        monkeypatch.setenv("PT_FORCE_PALLAS", "1")
        ref = ref_sharded.gather_scores(ref_sharded.sharded_align(
            ref_mesh(8), *arrays, **kw, route="auto"))
        assert ref["score"].shape[0] == cfg["B"]
    for k in ("score", "end_query", "end_ref", "matches", "similar",
              "length"):
        if k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for b, (q, r) in enumerate(pairs):
        g = golden.align_seqs(q, r, m, open_, ext, mode)
        assert (got["score"][b], got["end_query"][b], got["end_ref"][b]) == \
            (g.score, g.end_query, g.end_ref), b
        if outputs.startswith("stats"):
            assert (got["matches"][b], got["similar"][b],
                    got["length"][b]) == (g.matches, g.similar, g.length), b
        if outputs == "trace":
            np.testing.assert_array_equal(
                got["trace_table"][b, :len(q), :len(r)], g.trace_table)
        if outputs == "table":
            np.testing.assert_array_equal(
                got["score_table"][b, :len(q), :len(r)], g.score_table)


def test_plan_sharded_route_and_forced_routes(monkeypatch):
    from parasail_rs_tpu_torch.engine import dispatch

    vals = np.arange(-4, 12, dtype=np.int32)
    common = dict(score_values=vals, Qp=256, Rp=256, shard_batch=128,
                  device="cpu")
    for open_, ext in ((11, 1), (1, 2), (4, 4)):
        for outputs in ("score", "stats", "trace", "stats_table"):
            assert plan_sharded_route(outputs=outputs, gap_open=open_,
                                      gap_extend=ext, **common) == \
                "torch_plain"
    # scores beyond int8 change nothing; long pairs take the segments
    big = np.array([-300, 300], np.int32)
    assert plan_sharded_route(outputs="score", gap_open=11, gap_extend=1,
                              **{**common, "score_values": big}) == \
        "torch_plain"
    assert plan_sharded_route(outputs="stats", gap_open=2, gap_extend=2,
                              **{**common, "Qp": 1024, "Rp": 1024}) == \
        "torch_segments"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plan_sharded_route(outputs="score", gap_open=11, gap_extend=1,
                               **{**common, "device": None})
    m, pairs, arrays = protein_batch(3, 6)
    kw = dict(open_=10, ext=1, mode="sw", free=(True,) * 4, outputs="stats",
              width="32", device="cpu")
    mesh = tdist.make_device_mesh(2)
    with pytest.raises(ValueError, match="takes 'torch_plain'"):
        tdist.sharded_align(mesh, *arrays, **kw, route="cuda_kernel")
    # a small batch made to take the segment route, asserted
    monkeypatch.setattr(dispatch, "SEGMENT_MIN_CELLS", 64)
    monkeypatch.setattr(dispatch, "SEGMENT_COLS", {"score": 8, "stats": 8,
                                                   "trace": 8})
    out = tdist.sharded_align(mesh, *arrays, **kw, route="torch_segments")
    assert out.route == "torch_segments"
    for b, (q, r) in enumerate(pairs):
        g = golden.align_seqs(q, r, m, 10, 1, "sw")
        assert (out["score"][b], out["matches"][b], out["length"][b]) == \
            (g.score, g.matches, g.length)


# -- two processes over gloo ------------------------------------------------------------------

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as td

coord, pid = sys.argv[1], int(sys.argv[2])
from parasail_rs_tpu_torch import dist as tdist
from parasail_rs_tpu_torch.dist import multihost
from parasail_rs_tpu_torch.golden import model as golden
from parasail_rs_tpu_torch.matrices import Matrix
from parasail_rs_tpu_torch.engine.profile import profile_rows

multihost.initialize(coord, 2, pid, device="cpu")
assert td.get_backend() == "gloo" and td.get_world_size() == 2
mesh = multihost.global_mesh()
assert (mesh.size, mesh.world, mesh.rank) == (2, 2, pid)

m = Matrix.from_name("blosum62")
rng = np.random.default_rng(7)     # the same pairs in both processes
alpha = list(b"ARNDCQEGHILKMFPSTWYV")
B, Qp, Rp = 16, 48, 64
profile = np.zeros((B, Qp, m.size), np.int32)
qidx = np.full((B, Qp), -1, np.int32)
ridx = np.zeros((B, Rp), np.int32)
qlen, rlen = np.zeros(B, np.int32), np.zeros(B, np.int32)
pairs = []
for b in range(B):
    q = rng.choice(alpha, size=rng.integers(20, Qp + 1)).astype("uint8").tobytes()
    r = rng.choice(alpha, size=rng.integers(20, Rp + 1)).astype("uint8").tobytes()
    pairs.append((q, r))
    qi, ri = m.encode(q), m.encode(r)
    profile[b, :len(qi)] = profile_rows(m, qi)
    qidx[b, :len(qi)] = qi
    ridx[b, :len(ri)] = ri
    qlen[b], rlen[b] = len(qi), len(ri)

# sequence parallelism: rank d owns columns [32 d, 32 d + 32); three row
# chunks of 16 rows, the halo sent and received for each
for mode, outputs, pen in (("sw", "stats", (11, 1)), ("nw", "trace", (2, 2)),
                           ("sg", "score", (1, 3))):
    free = golden.free_flags(mode)
    out = tdist.seqpar_align_scan(
        profile, ridx, qlen, rlen, qidx, open_=pen[0], ext=pen[1], mesh=mesh,
        mode=mode, free=free, q_chunk=16, outputs=outputs, device="cpu")
    for b, (q, r) in enumerate(pairs):
        g = golden.align_seqs(q, r, m, pen[0], pen[1], mode)
        got = (int(out["score"][b]), int(out["end_query"][b]),
               int(out["end_ref"][b]))
        assert got == (g.score, g.end_query, g.end_ref), (mode, b, got)
        if outputs == "stats":
            assert (int(out["matches"][b]), int(out["similar"][b]),
                    int(out["length"][b])) == (g.matches, g.similar, g.length)
        if outputs == "trace":
            assert (out["trace_table"][b, :len(q), :len(r)].numpy()
                    == g.trace_table).all(), (mode, b)
    if outputs == "trace":
        cig = tdist.seqpar_cigars(out, [q for q, _ in pairs],
                                  [r for _, r in pairs], mode, free)
        g = golden.align_seqs(*pairs[3], m, pen[0], pen[1], mode)
        assert cig[3] == golden.walk_trace(
            g.trace_table, *pairs[3], g.end_query, g.end_ref, mode,
            free).cigar_string()

# data parallelism: each process feeds its half, both see all 16
half = B // 2
sl = slice(0, half) if pid == 0 else slice(half, B)
out = multihost.align_global(
    mesh, profile[sl], qidx[sl], ridx[sl], qlen[sl], rlen[sl], open_=11,
    ext=1, mode="sw", free=(True,) * 4, outputs="stats", device="cpu")
assert out["score"].shape[0] == B
whole = tdist.sharded.gather_scores(tdist.sharded_align(
    mesh, profile, qidx, ridx, qlen, rlen, open_=11, ext=1, mode="sw",
    free=(True,) * 4, outputs="stats", device="cpu"))
for b, (q, r) in enumerate(pairs):
    g = golden.align_seqs(q, r, m, 11, 1, "sw")
    for res in (out, whole):
        assert (res["score"][b], res["matches"][b], res["similar"][b],
                res["length"][b]) == (g.score, g.matches, g.similar,
                                      g.length), b
td.destroy_process_group()
print(f"proc {pid} OK")
"""


def test_two_gloo_processes_seqpar_and_align_global(tmp_path):
    import torch.distributed as td

    if not td.is_available() or not td.is_gloo_available():
        pytest.skip("needs torch.distributed with the gloo backend")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, str(script), f"localhost:{port}", str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
        text=True) for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out


# -- on the card -----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", CLASSES)
@pytest.mark.parametrize("name", ["sw", "nw", "sg_qb_de"])
def test_seqpar_align_scan_on_the_card(name, outputs, cuda_device):
    mode, free = MODES[name]
    pen = dict(open_=5, ext=1, mode=mode, free=free)
    want = one_shot(PROBLEM, dict(pen, outputs=outputs, width="sat"))
    for D, qc in ((1, 256), (8, 64), (4, 32)):
        before = tk.ROWSEG_LAUNCHES
        got = scan(PROBLEM, D, qc, device=None, outputs=outputs, **pen)
        assert tk.ROWSEG_LAUNCHES == before + D * (256 // qc)
        same(got, want, f"{name} {outputs} D {D}")


@pytest.mark.cuda
def test_sharded_align_on_the_card_in_a_group_of_one(cuda_device):
    import torch.distributed as td

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"localhost:{port}", 1, 0)
    try:
        assert td.get_backend() == "nccl"
        mesh = multihost.global_mesh()
        m, pairs, arrays = protein_batch(5, 19)
        kw = dict(open_=10, ext=1, mode="sw", free=(True,) * 4,
                  outputs="stats", width="sat")
        out = tdist.sharded_align(mesh, *arrays, **kw)
        assert out.route == "cuda_kernel"
        got = gather_scores(out)
        whole = multihost.align_global(mesh, *arrays, **kw)
        for b, (q, r) in enumerate(pairs):
            g = golden.align_seqs(q, r, m, 10, 1, "sw")
            for res in (got, whole):
                assert (res["score"][b], res["matches"][b],
                        res["length"][b]) == (g.score, g.matches, g.length)
    finally:
        td.destroy_process_group()
