"""The port's tile form (kernel K3) against the JAX package, the port's
segment form, its one-shot sweep and golden.

``parasail_rs_tpu_torch.ops.scan_kernel.score_rowseg`` runs one (row
chunk x column shard) tile of a sequence-parallel fill.  Chained in
superstep order over S x D tiles (shard d runs chunk t at superstep
t + d) it must give what one sweep over the whole pairs gives, for the
score, stats and trace classes.  On identical numpy-seeded inputs it is
held, exactly (every output is an integer or a flag), against

- the JAX ``seqpar_align_scan`` on 8 CPU devices, its Pallas tile kernel
  in interpret mode as tests/test_seqpar_scan.py runs it, on that file's
  cases; its stats class only at open > ext and its scores within int8,
  where the reference serves them;
- ``score_segment_plain`` chained over the same column shards;
- the one-shot ``score_align_plain``;
- the scalar golden oracle, also where the reference has no answer
  (stats at 2/2 and 1/3, scores beyond int8);

and one tile is seeded with the reference tile's own boundary state
through ``convert.rowseg_state_from_reference``.  Here the plain version
runs (the wavefront with a left and a top boundary);
``test_torch_rowseg_modes.py`` holds it to the one-shot sweep in every
mode at open >, = and < ext, and the g++ build of the kernel's own lanes
is held to the same in ``test_torch_rowseg_host.py``.
The CUDA kernel is compared with the plain version on the card by the
tests marked ``cuda``:
``python -m pytest --noconftest -m cuda tests/test_torch_rowseg.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu_torch import convert  # noqa: E402
from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402

from test_torch_segment import MODES as SEGMENT_MODES  # noqa: E402
from test_torch_segment import (  # noqa: E402
    CLASSES,
    PENALTIES,
    chain,
    check_golden,
    crop,
    make_case,
    same,
    tensors,
)


# tests/test_seqpar_scan.py also runs semi-global with no free end
MODES = {**SEGMENT_MODES, "sg_none": ("sg", (False,) * 4)}


def run_tiles(tile_fn, case, D, qc, kw, *, shared=False, device="cpu",
              profile=None):
    """``tile_fn`` over the S x D tiles of the case in superstep order
    (shard d runs chunk t at superstep t + d), the states handed on as
    ``dist.seqpar_scan`` hands them.  Returns ``(out, records)``: the
    outputs read off the merged accumulator (+ ``trace_table``) as numpy,
    and per tile (d, t) what it returned: state, down-state, trace tile
    and the outputs read off its shard's accumulator so far.
    """
    args, subs = tensors(case, device)
    if shared:
        subs["qidx"] = subs["qidx"][:1].contiguous()
    if profile is not None:
        subs = {"profile": torch.from_numpy(profile).to(device),
                **({"qidx": subs["qidx"]} if kw["outputs"] == "stats"
                   else {})}
    ridx, qlen, rlen = args
    B, Rp = ridx.shape
    Qp = case["qidx"].shape[1]
    assert Rp % D == 0 and Qp % qc == 0
    C, S = Rp // D, Qp // qc
    bkw = dict(open_=kw["open_"], ext=kw["ext"], mode=kw["mode"],
               free=kw["free"], outputs=kw["outputs"], device=ridx.device)
    accs = [tk.acc_init(B, Qp, kw["mode"], ridx.device) for _ in range(D)]
    downs, halos = [None] * D, [None] * (D + 1)
    records = {}
    for s in range(S + D - 1):
        for d in range(min(D - 1, s), -1, -1):
            t = s - d
            if t >= S:
                break
            halo = halos[d] if d else tk.rowseg_left_border(B, t * qc, qc,
                                                            **bkw)
            down = downs[d] if t else tk.rowseg_top_border(B, d * C, C, **bkw)
            tout, new, downs[d], tile = tile_fn(
                ridx[:, d * C:(d + 1) * C].contiguous(), qlen, rlen,
                dict(halo, acc=accs[d]), down, row_offset=t * qc, q_chunk=qc,
                col_offset=d * C, **kw, **subs)
            accs[d] = new.pop("acc")
            halos[d + 1] = new
            records[d, t] = (dict(new, acc=accs[d]), downs[d], tile, tout)
    acc = accs[0]
    for other in accs[1:]:
        acc = tk.merge_acc(acc, other)
    out = tk.acc_outputs(acc, qlen, rlen, Qp, **kw)
    if kw["outputs"] == "trace":
        out["trace_table"] = torch.cat(
            [torch.cat([records[d, t][2] for t in range(S)], dim=1)
             for d in range(D)], dim=2)
    return {k: v.cpu().numpy() for k, v in out.items()}, records


def same_records(got, want, what):
    """Every tile's right-going state, down-state, flags and outputs,
    exactly."""
    assert set(got) == set(want)
    for key in want:
        (gs, gd, gt, go), (ws, wd, wt, wo) = got[key], want[key]
        assert set(go) == set(wo), (what, key)
        for k in wo:
            assert torch.equal(go[k].cpu(), wo[k].cpu()), (what, key, k)
        assert set(gs) == set(ws), (what, key)
        for k in ws:
            assert torch.equal(gs[k].cpu(), ws[k].cpu()), (what, key, k)
        assert torch.equal(gd.cpu(), wd.cpu()), (what, key, "down")
        if wt is not None:
            assert torch.equal(gt.cpu(), wt.cpu()), (what, key, "trace")


def tiles_case(seed):
    """20 pairs padded to 72 x 72 of a 5-letter table: empty sides, queries
    that end above, inside and on the last row of a chunk of 8, 24 or 36
    rows, references that end on the edge of a shard of 24 or 18
    columns, before it and after it."""
    case = make_case(seed, 20, Qp=72, Rp=72, qhi=72, rhi=72, qlo=0, rlo=0,
                     edge=True, A=5)
    case["qlen"][5:10] = (64, 24, 48, 47, 25)
    case["rlen"][5:10] = (66, 72, 25, 24, 18)
    return case


def one_shot(case, kw, **extra):
    args, subs = tensors(case)
    subs.update(extra)
    return {k: v.numpy()
            for k, v in tk.score_align_plain(*args, **kw, **subs).items()}


# -- the reference's cases (tests/test_seqpar_scan.py) -----------------------


def dna_problem(match=2, mismatch=-3, lens=((230, 199), (256, 256)), Qp=256,
                Rp=256, seed=7):
    """tests/test_seqpar_scan.py's ``_problem``: a DNA matrix and ragged
    pairs, as the table form; the letters are the reference Matrix's."""
    from parasail_rs_tpu.matrices import Matrix

    m = Matrix.create(b"ACGT", match, mismatch)
    rng = np.random.default_rng(seed)
    B = len(lens)
    case = dict(table=np.ascontiguousarray(m.data, np.int32),
                qidx=np.full((B, Qp), -1, np.int32),
                ridx=np.zeros((B, Rp), np.int32),
                qlen=np.zeros(B, np.int32), rlen=np.zeros(B, np.int32))
    for b, (ql, rl) in enumerate(lens):
        q = rng.choice(list(b"ACGT"), size=ql).astype("uint8").tobytes()
        r = rng.choice(list(b"ACGT"), size=rl).astype("uint8").tobytes()
        case["qidx"][b, :ql] = m.encode(q)
        case["ridx"][b, :rl] = m.encode(r)
        case["qlen"][b], case["rlen"][b] = ql, rl
    return case


def reference_rows(case):
    """The reference's profile rows (B, Qp, A) of the case: zeros beyond
    each query."""
    q = case["qidx"]
    rows = case["table"][np.clip(q, 0, None)]
    return np.where((q >= 0)[..., None], rows, 0).astype(np.int32)


@functools.lru_cache(maxsize=None)
def reference_mesh():
    from parasail_rs_tpu.dist import make_device_mesh

    return make_device_mesh(8)


def run_reference(case, *, open_, ext, mode, free, outputs, q_chunk):
    """The JAX ``seqpar_align_scan`` on 8 CPU devices (Pallas in interpret
    mode); the trace plane cropped to each pair's cells."""
    from parasail_rs_tpu.dist.seqpar_scan import seqpar_align_scan

    out = seqpar_align_scan(
        reference_rows(case), case["ridx"], case["qlen"], case["rlen"],
        case["qidx"] if outputs == "stats" else None, open_=open_, ext=ext,
        mesh=reference_mesh(), mode=mode, free=free, q_chunk=q_chunk,
        outputs=outputs, width="sat")
    out = {k: np.asarray(v) for k, v in out.items()}
    if "trace_table" in out:
        out["trace_table"] = crop(out["trace_table"], case)
    return out


PROBLEM = dna_problem()
REF_CASES = (
    [(m, "score") for m in ("sw", "nw", "sg", "sg_qb_de", "sg_qe_db",
                            "sg_none")] +
    [(m, c) for c in ("stats", "trace") for m in ("sw", "nw", "sg_qb_de")])


@pytest.mark.parametrize("name,outputs", REF_CASES,
                         ids=[f"{m}-{c}" for m, c in REF_CASES])
def test_plain_tiles_match_reference_segments_one_shot_and_golden(name,
                                                                  outputs):
    mode, free = MODES[name]
    pen = dict(open_=5, ext=1, mode=mode, free=free)
    kw = dict(pen, outputs=outputs, width="sat")
    got, _ = run_tiles(tk.score_rowseg, PROBLEM, 8, 64, kw)
    same(got, run_reference(PROBLEM, **pen, outputs=outputs, q_chunk=64),
         f"{name} {outputs} against the reference")
    args, subs = tensors(PROBLEM)
    same(got, chain(tk.score_segment_plain, args, 64, {**kw, **subs})[0],
         f"{name} {outputs} against segments")
    same(got, one_shot(PROBLEM, kw), f"{name} {outputs} against one sweep")
    check_golden(PROBLEM, got, pen, outputs)


@pytest.mark.parametrize("trial", range(3))
def test_plain_tiles_fuzz_match_reference_and_golden(trial):
    # tests/test_seqpar_scan.py's fuzz: tiles ending at every alignment of
    # chunk and shard boundaries, q_chunk 8, 16 and 32
    rng = np.random.default_rng(23 + trial)
    Qp, Rp = int(rng.choice([64, 128])), int(rng.choice([64, 128]))
    qc = (8, 16, 32)[trial]
    open_, ext = int(rng.integers(1, 8)), 1
    mode = ["nw", "sg", "sw"][trial]
    free = (False, True, True, False) if mode == "sg" else \
        ((True,) * 4 if mode == "sw" else (False,) * 4)
    lens = [(int(rng.integers(1, Qp + 1)), int(rng.integers(1, Rp + 1)))
            for _ in range(3)]
    case = dna_problem(3, -2, lens, Qp, Rp, seed=trial)
    pen = dict(open_=open_, ext=ext, mode=mode, free=free)
    for outputs in CLASSES:
        kw = dict(pen, outputs=outputs, width="sat")
        got, _ = run_tiles(tk.score_rowseg, case, 8, qc, kw)
        same(got, run_reference(case, **pen, outputs=outputs, q_chunk=qc),
             f"trial {trial} {outputs}")
        check_golden(case, got, pen, outputs)


def test_plain_tiles_open_below_ext_match_reference_and_golden():
    pen = dict(open_=1, ext=2, mode="nw", free=(False,) * 4)
    for outputs in ("score", "trace"):
        kw = dict(pen, outputs=outputs, width="sat")
        got, _ = run_tiles(tk.score_rowseg, PROBLEM, 8, 64, kw)
        same(got, run_reference(PROBLEM, **pen, outputs=outputs, q_chunk=64),
             outputs)
        check_golden(PROBLEM, got, pen, outputs)


# -- beyond the reference ----------------------------------------------------


@pytest.mark.parametrize("open_,ext", [(2, 2), (1, 3)])
@pytest.mark.parametrize("name", ["nw", "sw", "sg_qb_de"])
def test_plain_tiles_stats_at_open_le_ext_match_golden(name, open_, ext):
    # the reference refuses these (seqpar_scan_fits); golden is the answer
    mode, free = MODES[name]
    case = dna_problem(2, -3, ((100, 90), (128, 128), (31, 128)), 128, 128,
                       seed=open_)
    pen = dict(open_=open_, ext=ext, mode=mode, free=free)
    kw = dict(pen, outputs="stats", width="sat")
    got, _ = run_tiles(tk.score_rowseg, case, 4, 32, kw)
    same(got, one_shot(case, kw), name)
    check_golden(case, got, pen, "stats")


@pytest.mark.parametrize("outputs", CLASSES)
def test_plain_tiles_protein_wide_scores_and_shared_query(outputs):
    # BLOSUM62 (24 letters), a table beyond int8 (the reference refuses
    # it), and one query against every reference
    from parasail_rs_tpu.matrices import Matrix

    rng = np.random.default_rng(4)
    blosum = np.ascontiguousarray(Matrix.from_name("blosum62").data,
                                  np.int32)
    pen = dict(open_=11, ext=1, mode="sw", free=(True,) * 4)
    kw = dict(pen, outputs=outputs, width="sat")
    for table in (blosum, blosum * 40):
        case = make_case(17, 6, Qp=64, Rp=96, qhi=64, rhi=96,
                         A=table.shape[0])
        case["table"] = table
        got, _ = run_tiles(tk.score_rowseg, case, 3, 16, kw)
        same(got, one_shot(case, kw), f"{outputs} max {table.max()}")
        check_golden(case, got, pen, outputs)
    assert got["promoted"].all()           # 40 x BLOSUM62 leaves int8
    case["qlen"][:] = case["qlen"][0]
    got, _ = run_tiles(tk.score_rowseg, case, 2, 32, kw, shared=True)
    same(got, one_shot(case, kw, qidx=torch.from_numpy(case["qidx"][:1])),
         "shared query")
    rows = rng.integers(-4, 12, size=(6, 64, 24)).astype(np.int32)
    got, _ = run_tiles(tk.score_rowseg, case, 2, 32, kw, profile=rows)
    args, subs = tensors(case)
    want = tk.score_align_plain(
        *args, **kw, profile=torch.from_numpy(rows),
        **({"qidx": subs["qidx"]} if outputs == "stats" else {}))
    same(got, {k: v.numpy() for k, v in want.items()}, "profile rows")


# -- one tile, seeded with the reference's own state --------------------------


def reference_tile(case, state, down, *, r0, j0, C, qc, open_, ext, mode,
                   free, outputs):
    """One ``scan_rowseg_step`` call (Pallas, interpret mode) on rows
    [r0, r0 + qc) x columns [j0, j0 + C) of the case padded to 128
    pairs."""
    import jax.numpy as jnp
    from parasail_rs_tpu.ops.scan_kernel import (_npk, build_gpack,
                                                 scan_rowseg_step)

    B = len(case["qlen"])

    def padb(x):
        return np.pad(x, [(0, 128 - B)] + [(0, 0)] * (x.ndim - 1))

    A = case["table"].shape[0]
    gpack = build_gpack(jnp.asarray(padb(reference_rows(case))))
    gpk = gpack[:, :_npk(A), r0:r0 + qc, :]
    return scan_rowseg_step(
        gpk, jnp.asarray(padb(case["ridx"])[:, j0:j0 + C]),
        jnp.asarray(padb(case["qlen"])), jnp.asarray(padb(case["rlen"])),
        state, down,
        jnp.asarray(padb(case["qidx"])[:, r0:r0 + qc])
        if outputs == "stats" else None,
        open_=jnp.int32(open_), ext=jnp.int32(ext), mode=mode, free=free,
        width="sat", outputs=outputs, row_offset=jnp.int32(r0),
        col_offset=jnp.int32(j0), qp_total=case["qidx"].shape[1],
        interpret=True, alphabet=A)


def reference_borders(case, *, C, qc, j0, open_, ext, mode, free, outputs):
    """The reference's boundary state of the first row chunk
    (dist/seqpar_scan.py:131-180): ``bstate(0)`` with a fresh accumulator,
    and ``bd_down`` at columns [j0, j0 + C)."""
    import jax.numpy as jnp

    local = mode == "sw"
    qb, _, db, _ = (True,) * 4 if local else free
    Qp = case["qidx"].shape[1]
    neg = -(1 << 30)

    def border(c):
        return np.where(c > 0, -(open_ + (c - 1) * ext), 0).astype(np.int32)

    def lanes(v, shape):
        return jnp.asarray(np.broadcast_to(v, shape).astype(np.int32))

    ig = np.arange(qc)
    left = np.zeros(qc, np.int32) if db else border(ig + 1)
    st = {"h": lanes(left[None, None, :, None], (1, 1, qc, 128)),
          "f": lanes(neg, (1, 1, qc, 128))}
    trows = 4 if outputs == "stats" else 1
    st["t"] = lanes(0, (1, 1, trows, 128))
    acc = np.zeros((1, 8, 128), np.int32)
    acc[:, 0], acc[:, 1], acc[:, 2] = neg, Qp, 1 << 30
    st["acc"] = jnp.asarray(acc)
    cols = j0 + np.arange(C)
    topb = np.zeros(C, np.int32) if qb else border(cols + 1)
    top_len = np.zeros(C, np.int32) if qb else cols + 1
    down = {"h": lanes(topb[None, :, None], (1, C, 128)),
            "pm": lanes((topb - open_ - min(ext, open_))[None, :, None],
                        (1, C, 128))}
    if outputs == "trace":
        down["e"] = lanes(neg, (1, C, 128))
    if outputs == "stats":
        z = lanes(0, (1, C, 128))
        hl = lanes((np.zeros(qc, np.int32) if db else ig + 1)
                   [None, None, :, None], (1, 1, qc, 128))
        zq = lanes(0, (1, 1, qc, 128))
        st["stats"] = (zq, zq, hl, zq, zq, zq)
        tl = lanes(top_len[None, :, None], (1, C, 128))
        tl1 = lanes((top_len + 1)[None, :, None], (1, C, 128))
        down["stats"] = (z, z, tl, z, z, tl1)
    return st, down


@pytest.mark.parametrize("name,outputs", [("nw", "score"), ("sw", "stats"),
                                          ("sg_qe_db", "stats"),
                                          ("nw", "trace")])
def test_tile_seeded_with_the_reference_state(name, outputs):
    # tile (shard 1, chunk 0): its left state is what the reference's tile
    # (0, 0) returned, carried across by convert; its returned h, f, t,
    # best cell and H rows of the down-state are the reference's
    mode, free = MODES[name]
    case = dna_problem(2, -3, ((40, 128), (64, 128), (20, 70), (64, 64)), 64,
                       128, seed=11)
    B, C, qc = 4, 64, 32
    pen = dict(open_=5, ext=1, mode=mode, free=free)
    geo = dict(C=C, qc=qc, **pen, outputs=outputs)
    st0, down0 = reference_borders(case, j0=0, **geo)
    ref_left, _, _ = reference_tile(case, st0, down0, r0=0, j0=0, **geo)
    st1, down1 = reference_borders(case, j0=C, **geo)
    halo = {k: v for k, v in ref_left.items() if k != "acc"}
    ref_new, ref_down, ref_tile = reference_tile(
        case, dict(halo, acc=st1["acc"]), down1, r0=0, j0=C, **geo)

    args, subs = tensors(case)
    state = convert.rowseg_state_from_reference(ref_left, B)
    # a shard's accumulator is its own: the port's initial one
    state["acc"] = tk.acc_init(B, 64, mode, "cpu")
    kw = dict(pen, outputs=outputs, width="sat")
    down = tk.rowseg_top_border(B, C, C, **pen, outputs=outputs, device="cpu")
    _, new, new_down, tile = tk.score_rowseg(
        args[0][:, C:].contiguous(), args[1], args[2], state, down,
        row_offset=0, q_chunk=qc, col_offset=C, **kw, **subs)

    want = convert.rowseg_state_from_reference(ref_new, B)
    rows = np.arange(qc)[None, :] < case["qlen"][:, None]      # (B, qc)
    # the reference sweeps its padded columns too, so its state is the
    # port's only for a pair that fills the tile's columns
    live = case["rlen"] >= 2 * C
    for k in ("h", "f"):
        np.testing.assert_array_equal(
            new[k].numpy()[live] * rows[live],
            want[k].numpy()[live] * rows[live], err_msg=k)
    if outputs == "stats":
        np.testing.assert_array_equal(
            new["stats"].numpy()[:, live] * rows[live],
            want["stats"].numpy()[:, live] * rows[live], err_msg="stats")
    nt = 4 if outputs == "stats" else 1
    np.testing.assert_array_equal(new["t"].numpy()[:, :nt],
                                  want["t"].numpy()[:, :nt], err_msg="t")
    if mode != "nw":        # the best cell so far, and its payload
        has = new["acc"].numpy()[:, 0] > (0 if mode == "sw" else -(1 << 30))
        np.testing.assert_array_equal(
            new["acc"].numpy()[has][:, [0, 1, 2, 5, 6, 7]],
            want["acc"].numpy()[has][:, [0, 1, 2, 5, 6, 7]], err_msg="acc")
    # the down-state's H (and its payload) under the tile's last row
    ref_d = convert.rowseg_down_from_reference(ref_down, B)
    cols = ((C + np.arange(C))[None, :] < case["rlen"][:, None]) & \
        (case["qlen"] >= qc)[:, None]
    np.testing.assert_array_equal(new_down.numpy()[:, 0] * cols,
                                  ref_d["h"] * cols, err_msg="down h")
    if outputs == "stats":
        np.testing.assert_array_equal(
            new_down.numpy()[:, 2:5].transpose(1, 0, 2) * cols,
            ref_d["pay"] * cols, err_msg="down payload")
    if outputs == "trace":
        ref_t = np.asarray(ref_tile)           # (nb, C, qc, 128)
        ref_t = ref_t.transpose(0, 3, 2, 1).reshape(128, qc, C)[:B]
        inside = rows[:, :, None] & \
            ((C + np.arange(C))[None, None, :] < case["rlen"][:, None, None])
        np.testing.assert_array_equal(tile.numpy(), ref_t * inside)


def test_tile_contract():
    case = make_case(3, 4, Qp=32, Rp=64, qhi=32, rhi=64, A=5)
    args, subs = tensors(case)
    pen = dict(open_=4, ext=1, mode="nw", free=(False,) * 4)
    kw = dict(pen, width="32", outputs="stats", row_offset=0, q_chunk=16,
              col_offset=0, **subs)
    state = tk.rowseg_left_border(4, 0, 16, **pen, outputs="stats",
                                  device="cpu")
    state["acc"] = tk.acc_init(4, 32, "nw", "cpu")
    down = tk.rowseg_top_border(4, 0, 32, **pen, outputs="stats",
                                device="cpu")
    cols = args[0][:, :32].contiguous()
    out, new, new_down, tile = tk.score_rowseg(cols, args[1], args[2], state,
                                               down, **kw)
    assert sorted(new) == ["acc", "f", "h", "stats", "t"] and tile is None
    assert new["h"].shape == (4, 16) and new["stats"].shape == (6, 4, 16)
    assert new["t"].shape == (4, 4) and new_down.shape == (4, 8, 32)
    assert new_down is not down and new["h"] is not state["h"]
    # what the tile hands right is the down-state it was given at its last
    # column: the top border there, with its length payload
    assert new["t"][:, 0].tolist() == [int(down[0, 0, 31])] * 4
    assert new["t"][:, 3].tolist() == [32] * 4
    with pytest.raises(ValueError, match="tile form serves"):
        tk.score_rowseg(cols, args[1], args[2], state, down,
                        **{**kw, "outputs": "table"})
    with pytest.raises(ValueError, match="outside the padded query"):
        tk.score_rowseg(cols, args[1], args[2], state, down,
                        **{**kw, "row_offset": 24})
    with pytest.raises(ValueError, match="state\\['t'\\]"):
        tk.score_rowseg(cols, args[1], args[2],
                        {k: v for k, v in state.items() if k != "t"}, down,
                        **kw)
    with pytest.raises(ValueError, match="down must be"):
        tk.score_rowseg(cols, args[1], args[2], state,
                        down[:, :2].contiguous(), **kw)


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
def test_kernel_tiles_match_plain_and_one_shot(name, open_, ext, outputs,
                                               cuda_device, monkeypatch):
    mode, free = MODES[name]
    case = make_case(5 * open_ + ext + len(name), 20, Qp=72, Rp=96, qhi=72,
                     rhi=96, qlo=0, rlo=0, edge=True, A=5)
    case["qlen"][5:10] = (64, 24, 48, 47, 25)
    case["rlen"][5:10] = (90, 96, 33, 32, 31)
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs,
              width="sat")
    args, subs = tensors(case, cuda_device)
    want = {k: v.cpu().numpy()
            for k, v in tk.score_align(*args, **kw, **subs).items()}
    pick = (len(name) + open_ + CLASSES.index(outputs)) % 3
    for k, ((D, qc), warps) in enumerate((((3, 24), 0), ((4, 36), 2),
                                          ((1, 8), 1))):
        monkeypatch.setattr(tk, "SEGMENT_WARPS", warps)
        before = tk.ROWSEG_LAUNCHES
        got, recs = run_tiles(tk.score_rowseg, case, D, qc, kw,
                              device=cuda_device)
        assert tk.ROWSEG_LAUNCHES == before + D * (72 // qc)
        same(got, want, f"{name} {outputs} D {D} q_chunk {qc}")
        if k != pick:         # the plain tiles are slow: one shape a case
            continue
        plain, precs = run_tiles(tk.score_rowseg_plain, case, D, qc, kw,
                                 device=cuda_device)
        same(got, plain, f"{name} {outputs} against plain")
        same_records(recs, precs, f"{name} {outputs} D {D} q_chunk {qc}")


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", CLASSES)
@pytest.mark.parametrize("warps", [0, 1, 3, 8])
def test_kernel_tiles_several_warps(warps, outputs, cuda_device, monkeypatch):
    # tiles of 150 rows: groups of 96 and of 256 rows, the tile's last row
    # on a lane that is no warp's last
    monkeypatch.setattr(tk, "SEGMENT_WARPS", warps)
    case = make_case(13 + warps, 12, Qp=300, Rp=200, qlo=0, qhi=300, rlo=0,
                     rhi=200, A=5)
    case["qlen"][:5] = (300, 257, 150, 151, 149)
    case["rlen"][:5] = (200, 129, 128, 200, 1)
    args, subs = tensors(case, cuda_device)
    for n, (name, (open_, ext)) in enumerate((("sw", (11, 1)),
                                              ("sg", (2, 2)),
                                              ("nw", (1, 3)))):
        mode, free = MODES[name]
        kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs,
                  width="sat")
        want = {k: v.cpu().numpy()
                for k, v in tk.score_align(*args, **kw, **subs).items()}
        for D, qc in ((2, 150), (1, 300), (5, 100)):
            got, recs = run_tiles(tk.score_rowseg, case, D, qc, kw,
                                  device=cuda_device)
            same(got, want, f"{name} {outputs} D {D} warps {warps}")
            if D != 2 or n != warps % 3:   # the plain tiles are slow
                continue
            _, precs = run_tiles(tk.score_rowseg_plain, case, D, qc, kw,
                                 device=cuda_device)
            same_records(recs, precs, f"{name} {outputs} D {D}")


@pytest.mark.cuda
def test_kernel_tiles_profile_form_and_bad_state(cuda_device):
    rng = np.random.default_rng(9)
    case = make_case(9, 16, Qp=64, Rp=128, qhi=64, rhi=128)
    rows = rng.integers(-4, 12, size=(16, 64, 25)).astype(np.int32)
    pen = dict(open_=5, ext=2, mode="sw", free=(True,) * 4)
    for outputs in CLASSES:
        kw = dict(pen, outputs=outputs, width="sat")
        got, recs = run_tiles(tk.score_rowseg, case, 2, 32, kw,
                              device=cuda_device, profile=rows)
        plain, precs = run_tiles(tk.score_rowseg_plain, case, 2, 32, kw,
                                 device=cuda_device, profile=rows)
        same(got, plain, outputs)
        same_records(recs, precs, outputs)
    args, subs = tensors(case, cuda_device)
    state = tk.rowseg_left_border(16, 0, 32, **pen, outputs="score",
                                  device="cpu")
    state["acc"] = tk.acc_init(16, 64, "sw", "cpu")
    down = tk.rowseg_top_border(16, 0, 128, **pen, outputs="score",
                                device=cuda_device)
    with pytest.raises(ValueError, match="state"):
        tk.score_rowseg(*args, state, down, **pen, outputs="score",
                        row_offset=0, q_chunk=32, col_offset=0, **subs)
