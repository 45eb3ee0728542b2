"""The port's segment form (kernel K2) against the JAX package, the port's
one-shot sweep and golden.

``parasail_rs_tpu_torch.ops.scan_kernel.score_segment`` chained left to
right over a pair's reference columns must give what one sweep over the
whole pair gives, for the score, stats and trace classes.  On identical
numpy-seeded inputs it is held, exactly (every output is an integer or a
flag), against

- the JAX ``scan_score_segment`` chained the same way, Pallas in
  interpret mode as the JAX package's own tests run it
  (tests/test_scan_kernel.py: 128 pairs, queries 3-60, references 3-250,
  segments of 64); its stats class only at open > ext, where the
  reference streams it;
- the port's one-shot ``score_align_plain`` (an independent column sweep
  for the score and trace classes), with empty sides, ragged stripes and
  pairs that end in an earlier segment, at open >, = and < ext;
- the scalar golden oracle;

here the plain version (the wavefront with a left boundary); the g++
build of the kernel's own lanes (``pt_segment_host``) is held to the same
in ``test_torch_segment_host.py``.  The CUDA kernel is compared with the
plain version and the one-shot kernel on the card by the tests marked
``cuda``:
``python -m pytest --noconftest -m cuda tests/test_torch_segment.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the port's CPU tests run small tensors in several worker processes: one
# intra-op thread each keeps the workers from oversubscribing the cores
torch.set_num_threads(1)

from parasail_rs_tpu.golden import model as golden  # noqa: E402

from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402

from test_torch_scan_kernel import SG_FREE  # noqa: E402

MODES = {"nw": ("nw", (False,) * 4), "sw": ("sw", (True,) * 4),
         **{name: ("sg", f) for name, f in SG_FREE.items()}}
PENALTIES = [(11, 1), (2, 2), (1, 3)]
CLASSES = ("score", "stats", "trace")


def make_case(seed, B, *, Qp=64, Rp=256, qlo=3, qhi=60, rlo=3, rhi=250, A=25,
              edge=False):
    """A seeded (A, A) table with per-pair letters and ragged lengths;
    ``edge`` adds empty sides, whole stripes of 32 rows and a full pair."""
    rng = np.random.default_rng(seed)
    qlen = rng.integers(qlo, qhi + 1, size=B).astype(np.int32)
    rlen = rng.integers(rlo, rhi + 1, size=B).astype(np.int32)
    if edge:
        qlen[:6] = (0, 5, Qp, 32, 33, 64)
        rlen[:6] = (7, 0, Rp, 64, 65, 128)
    return dict(
        table=rng.integers(-4, 8, size=(A, A)).astype(np.int32),
        qidx=rng.integers(0, A, size=(B, Qp)).astype(np.int32),
        ridx=rng.integers(0, A, size=(B, Rp)).astype(np.int32),
        qlen=qlen, rlen=rlen)


def tensors(case, device="cpu"):
    t = {k: torch.from_numpy(v).to(device) for k, v in case.items()}
    return (t["ridx"], t["qlen"], t["rlen"]), {"table": t["table"],
                                               "qidx": t["qidx"]}


def chain(fn, args, seg, kw):
    """``fn`` over ``seg``-column segments, left to right; the trace
    class's planes concatenated into ``trace_table``."""
    ridx, qlen, rlen = args
    Rp = ridx.shape[1]
    nseg = -(-Rp // seg)
    ridx = torch.nn.functional.pad(ridx, (0, nseg * seg - Rp))
    state = out = None
    planes = []
    for si in range(nseg):
        out, state = fn(ridx[:, si * seg:(si + 1) * seg].contiguous(), qlen,
                        rlen, state, col_offset=si * seg, resume=si > 0, **kw)
        if "trace_table_seg" in out:
            planes.append(out.pop("trace_table_seg"))
    if planes:
        out["trace_table"] = torch.cat(planes, dim=2)[:, :, :Rp]
    return {k: v.cpu().numpy() for k, v in out.items()}, state


def same(got, want, what):
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k in want:
        np.testing.assert_array_equal(
            np.asarray(got[k]).astype(np.int64),
            np.asarray(want[k]).astype(np.int64), err_msg=f"{what}/{k}")


def run_jax_segments(case, seg, *, open_, ext, mode, free, outputs):
    """The JAX segment kernel chained, in interpret mode; the trace
    class's planes cropped to each pair's cells (it leaves what it
    computed in the padded ones)."""
    from parasail_rs_tpu.ops.scan_kernel import scan_score_segment

    table, qidx = case["table"], case["qidx"]
    rows = table[qidx]                                   # (B, Qp, A)
    Rp = case["ridx"].shape[1]
    state = out = None
    planes = []
    for s0 in range(0, Rp, seg):
        out, state = scan_score_segment(
            rows, case["ridx"][:, s0:s0 + seg], case["qlen"], case["rlen"],
            state, qidx if outputs == "stats" else None,
            open_=np.int32(open_), ext=np.int32(ext), mode=mode, free=free,
            width="sat", outputs=outputs, col_offset=np.int32(s0),
            resume=s0 > 0, interpret=True)
        out = dict(out)
        if outputs == "trace":
            planes.append(np.asarray(out.pop("trace_table_seg")))
    out = {k: np.asarray(v) for k, v in out.items()}
    if planes:
        out["trace_table"] = crop(np.concatenate(planes, axis=2), case)
    return out


def crop(plane, case):
    """Zero a (B, Qp, Rp) plane outside each pair's qlen x rlen cells."""
    Qp, Rp = plane.shape[1:]
    inside = ((np.arange(Qp)[None, :, None] < case["qlen"][:, None, None]) &
              (np.arange(Rp)[None, None, :] < case["rlen"][:, None, None]))
    return np.where(inside, plane, 0).astype(plane.dtype)


# -- against the JAX segment kernel ------------------------------------------

JAX_CASES = [(m, "score", 11, 1) for m in ("sw", "nw", "sg_qb_de", "sg_qe_db",
                                           "sg")] + \
    [("sw", "score", 1, 3), ("nw", "score", 2, 2),
     ("sw", "stats", 11, 1), ("sg", "stats", 5, 2), ("nw", "stats", 4, 1),
     ("sw", "trace", 11, 1), ("sg_qb_de", "trace", 2, 2),
     ("nw", "trace", 1, 3)]


@pytest.mark.parametrize("name,outputs,open_,ext", JAX_CASES,
                         ids=[f"{m}-{o}-{a}_{b}" for m, o, a, b in JAX_CASES])
def test_plain_segments_match_jax_segments(name, outputs, open_, ext):
    mode, free = MODES[name]
    case = make_case(51 + len(name) + open_, 128)
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs)
    want = run_jax_segments(case, 64, **kw)
    args, subs = tensors(case)
    got, _ = chain(tk.score_segment, args, 64, {**kw, **subs, "width": "sat"})
    same(got, want, f"{name} {outputs}")


# -- against the one-shot sweep and golden -------------------------------------


@pytest.mark.parametrize("outputs", CLASSES)
@pytest.mark.parametrize("open_,ext", PENALTIES,
                         ids=[f"{a}_{b}" for a, b in PENALTIES])
@pytest.mark.parametrize("name", sorted(MODES))
def test_plain_segments_match_one_shot(name, open_, ext, outputs):
    mode, free = MODES[name]
    case = make_case(7 * open_ + ext + len(name), 24, Rp=160, qhi=64,
                     rhi=160, edge=True, A=5)
    args, subs = tensors(case)
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs,
              width="sat", **subs)
    want = {k: v.numpy()
            for k, v in tk.score_align_plain(*args, **kw).items()}
    # segments of 64 or of 100 (the last one padded)
    seg = (64, 100)[(len(name) + open_ + CLASSES.index(outputs)) % 2]
    got, _ = chain(tk.score_segment_plain, args, seg, kw)
    same(got, want, f"{name} {outputs} seg {seg}")


def golden_expect(case, b, *, open_, ext, mode, free):
    ql, rl = int(case["qlen"][b]), int(case["rlen"][b])
    qi, ri = case["qidx"][b, :ql], case["ridx"][b, :rl]
    sub = case["table"][qi[:, None], ri[None, :]].astype(np.int64)
    return golden.align(sub, qi[:, None] == ri[None, :], open_, ext, mode,
                        free)


def check_golden(case, got, kw, outputs):
    for b in range(len(case["qlen"])):
        g = golden_expect(case, b, **kw)
        ql, rl = int(case["qlen"][b]), int(case["rlen"][b])
        assert (got["score"][b], got["end_query"][b], got["end_ref"][b]) == \
            (g.score, g.end_query, g.end_ref), b
        if outputs == "stats":
            assert (got["matches"][b], got["similar"][b], got["length"][b]) \
                == (g.matches, g.similar, g.length), b
        if outputs == "trace":
            np.testing.assert_array_equal(got["trace_table"][b, :ql, :rl],
                                          g.trace_table, err_msg=str(b))
            assert not got["trace_table"][b, ql:].any()
            assert not got["trace_table"][b, :, rl:].any()


@pytest.mark.parametrize("outputs", CLASSES)
@pytest.mark.parametrize("open_,ext", PENALTIES,
                         ids=[f"{a}_{b}" for a, b in PENALTIES])
@pytest.mark.parametrize("name", ["nw", "sw", "sg", "sg_qb_de", "sg_qe_db"])
def test_plain_segments_match_golden(name, open_, ext, outputs):
    mode, free = MODES[name]
    case = make_case(100 + open_ + len(name), 6, Qp=48, Rp=160, qhi=48,
                     rhi=160, A=5)
    args, subs = tensors(case)
    kw = dict(open_=open_, ext=ext, mode=mode, free=free)
    got, _ = chain(tk.score_segment, args, 64,
                   {**kw, **subs, "outputs": outputs, "width": "sat"})
    check_golden(case, got, kw, outputs)


def test_profile_forms_and_shared_query():
    # (1 or B, Qp, A) profile rows, and one query against every reference
    rng = np.random.default_rng(9)
    case = make_case(9, 16, Qp=40, Rp=130, qhi=40, rhi=130)
    args, subs = tensors(case)
    kw = dict(open_=5, ext=2, mode="sg", free=(True, False, False, True),
              width="sat")
    rows = torch.from_numpy(
        rng.integers(-4, 12, size=(16, 40, 25)).astype(np.int32))
    for profile, qidx, qlen in (
            (rows, subs["qidx"], args[1]),
            (rows[:1], subs["qidx"][:1], args[1][:1].expand(16).contiguous())):
        a = (args[0], qlen, args[2])
        for outputs in CLASSES:
            k = dict(kw, outputs=outputs, profile=profile)
            if outputs == "stats":
                k["qidx"] = qidx
            want = {n: v.numpy()
                    for n, v in tk.score_align_plain(*a, **k).items()}
            got, _ = chain(tk.score_segment, a, 64, k)
            same(got, want, f"profile {tuple(profile.shape)} {outputs}")
    shared = dict(kw, outputs="stats", table=subs["table"],
                  qidx=subs["qidx"][:1])
    a = (args[0], args[1][:1].expand(16).contiguous(), args[2])
    want = {n: v.numpy()
            for n, v in tk.score_align_plain(*a, **shared).items()}
    same(chain(tk.score_segment, a, 50, shared)[0], want, "shared query")


def test_saturation_flags_come_from_all_segments():
    # a run of matches that crosses 127 only in the second segment, and a
    # pair that saturates in the first and ends there
    A = 4
    table = np.full((A, A), -3, np.int32)
    np.fill_diagonal(table, 2)
    letters = np.tile(np.arange(A, dtype=np.int32), 40)[:150]
    case = dict(table=table,
                qidx=np.ascontiguousarray(np.stack([letters, letters])[:, :96]),
                ridx=np.stack([letters, letters]),
                qlen=np.array([96, 80], np.int32),
                rlen=np.array([150, 60], np.int32))
    args, subs = tensors(case)
    for width, keys in (("sat", ("saturated", "promoted")),
                        ("8", ("saturated",)), ("16", ("saturated",))):
        kw = dict(open_=5, ext=1, mode="sw", free=(True,) * 4, width=width,
                  outputs="score", **subs)
        want = tk.score_align_plain(*args, **kw)
        got, _ = chain(tk.score_segment, args, 64, kw)
        for k in keys:
            assert got[k].tolist() == want[k].tolist(), (width, k)
    assert got["saturated"].tolist() == [False, False]
    kw["width"] = "8"
    assert chain(tk.score_segment, args, 64, kw)[0]["saturated"].tolist() == \
        [True, False]


def test_segment_state_contract():
    case = make_case(3, 8, Qp=40, Rp=100, qhi=40, rhi=100, A=5)
    args, subs = tensors(case)
    kw = dict(open_=4, ext=1, mode="nw", free=(False,) * 4, width="32",
              outputs="stats", **subs)
    first = args[0][:, :64].contiguous()
    out, state = tk.score_segment(first, args[1], args[2], **kw)
    assert sorted(state) == ["acc", "f", "h", "stats"]
    assert state["h"].shape == (8, 40) and state["stats"].shape == (6, 8, 40)
    assert state["acc"].shape == (8, 8)
    # a pair that ended in the first segment keeps its state and outputs
    done = (case["rlen"] <= 64).nonzero()[0]
    assert done.size
    rest = torch.nn.functional.pad(args[0][:, 64:], (0, 28))
    out2, state2 = tk.score_segment(rest, args[1], args[2], state,
                                    col_offset=64, resume=True, **kw)
    for k in out:
        assert out2[k][done].tolist() == out[k][done].tolist(), k
    for k in state:
        a, b = state[k], state2[k]
        if k == "stats":
            a, b = a[:, done], b[:, done]
        else:
            a, b = a[done], b[done]
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="resume=True needs the state"):
        tk.score_segment(rest, args[1], args[2], col_offset=64, resume=True,
                         **kw)
    with pytest.raises(ValueError, match="starts at column 0"):
        tk.score_segment(rest, args[1], args[2], col_offset=64, **kw)
    with pytest.raises(ValueError, match="segment form serves"):
        tk.score_segment(first, args[1], args[2], **{**kw,
                                                     "outputs": "table"})
    bad = dict(state2, h=state2["h"][:, :10].contiguous())
    with pytest.raises(ValueError, match="state\\['h'\\]"):
        tk.score_segment(rest, args[1], args[2], bad, col_offset=64,
                         resume=True, **kw)


# -- on the card -----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", CLASSES)
@pytest.mark.parametrize("open_,ext", PENALTIES,
                         ids=[f"{a}_{b}" for a, b in PENALTIES])
@pytest.mark.parametrize("name", sorted(MODES))
def test_kernel_segments_match_plain_and_one_shot(name, open_, ext, outputs,
                                                  cuda_device, monkeypatch):
    mode, free = MODES[name]
    case = make_case(11 * open_ + ext + len(name), 24, Qp=70, Rp=200, qhi=70,
                     rhi=200, qlo=0, rlo=0, edge=True, A=5)
    args, subs = tensors(case, cuda_device)
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs,
              width="sat", **subs)
    want = {k: v.cpu().numpy() for k, v in tk.score_align(*args, **kw).items()}
    for seg, warps in ((48, 0), (128, 2)):
        before = tk.SEGMENT_LAUNCHES
        monkeypatch.setattr(tk, "SEGMENT_WARPS", warps)
        got, _ = chain(tk.score_segment, args, seg, kw)
        assert tk.SEGMENT_LAUNCHES == before + -(-200 // seg)
        same(got, want, f"{name} {outputs} seg {seg}")
        same(got, chain(tk.score_segment_plain, args, seg, kw)[0],
             f"{name} {outputs} seg {seg} against plain")


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", CLASSES)
@pytest.mark.parametrize("warps", [0, 1, 3, 8])
def test_kernel_segments_several_warps(warps, outputs, cuda_device,
                                       monkeypatch):
    monkeypatch.setattr(tk, "SEGMENT_WARPS", warps)
    case = make_case(13 + warps, 12, Qp=300, Rp=200, qlo=0, qhi=300, rlo=0,
                     rhi=200, A=5)
    case["qlen"][:5] = (300, 257, 256, 97, 96)
    case["rlen"][:5] = (200, 129, 128, 200, 1)
    args, subs = tensors(case, cuda_device)
    for name, (open_, ext) in (("sw", (11, 1)), ("sg", (2, 2)),
                               ("nw", (1, 3))):
        mode, free = MODES[name]
        kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs,
                  width="sat", **subs)
        want = {k: v.cpu().numpy()
                for k, v in tk.score_align(*args, **kw).items()}
        for seg in (200, 70):
            got, _ = chain(tk.score_segment, args, seg, kw)
            same(got, want, f"{name} {outputs} seg {seg} warps {warps}")


@pytest.mark.cuda
def test_kernel_segments_profile_forms(cuda_device):
    rng = np.random.default_rng(9)
    case = make_case(9, 16, Qp=40, Rp=130, qhi=40, rhi=130)
    args, subs = tensors(case, cuda_device)
    rows = torch.from_numpy(rng.integers(-4, 12, size=(16, 40, 25))
                            .astype(np.int32)).to(cuda_device)
    for outputs in CLASSES:
        kw = dict(open_=5, ext=2, mode="sw", free=(True,) * 4, width="sat",
                  outputs=outputs, profile=rows)
        if outputs == "stats":
            kw["qidx"] = subs["qidx"]
        same(chain(tk.score_segment, args, 64, kw)[0],
             chain(tk.score_segment_plain, args, 64, kw)[0], outputs)


@pytest.mark.cuda
def test_kernel_raises_on_a_bad_state(cuda_device):
    case = make_case(3, 8, Qp=40, Rp=64, qhi=40, rhi=64, A=5)
    args, subs = tensors(case, cuda_device)
    kw = dict(open_=4, ext=1, mode="nw", free=(False,) * 4, width="32",
              outputs="score", **subs)
    _, state = tk.score_segment(*args, **kw)
    cpu_state = {k: v.cpu() for k, v in state.items()}
    with pytest.raises(ValueError, match="state"):
        tk.score_segment(*args, cpu_state, col_offset=64, resume=True, **kw)
