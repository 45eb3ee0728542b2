"""The port's chunked sweep (kernel K1f) and its route against the JAX
package and golden, at tall shapes.

``parasail_rs_tpu_torch.ops.scan_kernel.score_chunked`` is the port of
``scan_score_align`` with the query in row chunks (``nq > 1``): the
function the JAX package's Pallas kernel computes once the padded query
outgrows one chunk (Qp > 2,048).  On the same numpy-seeded inputs it is
held, exactly (every output is an integer or a flag), against

- the JAX ``wavefront_align`` (jitted XLA on the CPU) in every output
  class, on 8 DNA pairs padded to 3,072 x 96 (queries of 2,049-3,072
  letters beside short ones; the five classes whose plain version is the
  wavefront on 4 pairs at 2,080 x 48) and on 4 pairs of 1,024 x 1,024:
  scalars, and planes, rows and columns in each pair's cells;
- the JAX ``scan_score_align`` itself, Pallas in interpret mode with the
  query in chunks (tests/test_scan_kernel.py:213 runs the same), for the
  trace class at 3,072 x 96, computed once for the module;
- golden, pair by pair.

On the CPU ``score_chunked`` runs the plain version; the g++ build of
the kernel's own lanes is held to it in ``test_torch_chunked_host.py``.
The route (``dispatch.plan_route``) must send long one-launch batches and
the plane classes to ``torch_chunked`` here and ``cuda_chunked`` on the
card, and the public calls of ``chip_smoke.py``'s phase 26
(``align_cigars`` and ``ssw_batch`` on the tall pairs,
``use_last_rowcol()`` and ``use_table()``, with and without stats, on
pairs of up to 1,024 x 1,024) must take it and equal the reference
``Aligner`` and golden.  The ``cuda`` test runs the kernel
against the plain version on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_chunked.py``.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parasail_rs_tpu as ref  # noqa: E402
from parasail_rs_tpu.golden import model as golden  # noqa: E402
from parasail_rs_tpu.matrices import Matrix  # noqa: E402

import parasail_rs_tpu_torch as port  # noqa: E402
from parasail_rs_tpu_torch.engine import dispatch  # noqa: E402
from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402

from test_torch_engine import _configure, port_matrix  # noqa: E402
from test_torch_engine_stats import _views  # noqa: E402
from test_torch_wavefront import (  # noqa: E402
    CLASSES,
    SG_SETS,
    assert_same_in_sequence,
    pack,
    run_jax,
)

DNA = Matrix.create(b"ACGT", 2, -3)
PENALTIES = [(11, 1), (2, 2), (1, 3)]
# tall pairs: queries of 2,049-3,072 letters against references of up to
# 96, beside short pairs, padded to 3,072 x 96 (where the reference holds
# the query in chunks); the classes whose plain version is the wavefront,
# the slowest, on four pairs at 2,080 x 48
TALL = [(3000, 90), (2500, 60), (3072, 96), (2080, 40), (2049, 96), (1, 1),
        (33, 95), (100, 3)]
NARROW = [(2080, 48), (2050, 30), (33, 47), (2079, 1)]
# long by their cells (1,024 x 1,024 padded), for the plane classes
# through the public API
SQUARE = [(1000, 1024), (1024, 990), (100, 120), (33, 7)]
ROUTE = ("torch_chunked", "long pairs, one launch")


def dna_pairs(seed, lens):
    rng = np.random.default_rng(seed)
    return [tuple(rng.choice(list(b"ACGT"), size=n).astype(np.uint8)
                  .tobytes() for n in ql_rl) for ql_rl in lens]


def run_port(case, cls, **kw):
    """score_chunked on the case's profile form (with letters, which the
    stats classes compare), as numpy."""
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    out = tk.score_chunked(t["ridx"], t["qlen"], t["rlen"],
                           profile=t["profile"], qidx=t["qidx"],
                           outputs=cls, width="sat", **kw)
    return {k: v.numpy() for k, v in out.items()}


def check_golden_pair(got, pairs, b, cls, *, open_, ext, mode, free):
    """Pair b of a numpy result against golden: scalars and the class's
    outputs over the pair's cells."""
    q, r = pairs[b]
    g = golden.align_seqs(q, r, DNA, open_, ext, mode,
                          free if mode == "sg" else None)
    assert (got["score"][b], got["end_query"][b], got["end_ref"][b]) == \
        (g.score, g.end_query, g.end_ref), (cls, b)
    for k, v in got.items():
        if k in ("matches", "similar", "length"):
            assert v[b] == getattr(g, k), (cls, b, k)
        elif k.endswith("_table"):
            np.testing.assert_array_equal(v[b, :len(q), :len(r)],
                                          getattr(g, k), err_msg=f"{k} {b}")
        elif k.endswith("_row"):
            np.testing.assert_array_equal(v[b, :len(r)], getattr(g, k))
        elif k.endswith("_col"):
            np.testing.assert_array_equal(v[b, :len(q)], getattr(g, k))


# -- against the JAX wavefront and golden ------------------------------------


@pytest.mark.parametrize("cls", CLASSES)
def test_chunked_matches_jax_wavefront_and_golden(cls):
    # each class in one mode, the modes, SG free-end sets and penalty
    # pairs (open <= ext included) rotating over the classes
    n = CLASSES.index(cls)
    mode = ("nw", "sg", "sw")[n % 3]
    free = SG_SETS[n % 5] if mode == "sg" else golden.free_flags(mode)
    open_, ext = PENALTIES[(n + n // 3) % 3]
    wide = cls in ("score", "trace")
    pairs = dna_pairs(70 + n, TALL if wide else NARROW)
    case = pack(pairs, DNA, Qp=3072 if wide else 2080, Rp=96 if wide else 48)
    kw = dict(open_=open_, ext=ext, mode=mode, free=free)
    got = run_port(case, cls, **kw)
    want = run_jax(case, **kw, outputs=cls, width="sat")
    assert_same_in_sequence(got, want, case, f"{cls} {mode} {open_}/{ext}")
    check_golden_pair(got, pairs, 3 if wide else 0, cls, **kw)


def test_chunked_square_matches_jax_wavefront():
    pairs = dna_pairs(80, [(1000, 1024), (1024, 900), (512, 1024),
                           (1024, 1024)])
    case = pack(pairs, DNA, Qp=1024, Rp=1024)
    kw = dict(open_=11, ext=1, mode="sg", free=(True, False, False, True))
    got = run_port(case, "stats_rowcol", **kw)
    want = run_jax(case, **kw, outputs="stats_rowcol", width="sat")
    assert_same_in_sequence(got, want, case, "1024 x 1024 stats_rowcol")


# -- against the JAX kernel in interpret mode ------------------------------------


@pytest.fixture(scope="module")
def jax_chunked_trace():
    """The JAX scan_score_align on 128 pairs padded to 3,072 x 96 (the
    query in chunks), SW 5/1, trace class, Pallas in interpret mode: the
    eight tall pairs first, then short ones.  Computed once."""
    from parasail_rs_tpu.ops.scan_kernel import _plan, scan_score_align

    assert _plan(3072, 96, "trace")[1] > 1           # really chunked
    pairs = dna_pairs(90, TALL + [(64, 64)] * 120)
    case = pack(pairs, DNA, Qp=3072, Rp=96)
    out = scan_score_align(
        case["profile"], case["ridx"], case["qlen"], case["rlen"],
        open_=np.int32(5), ext=np.int32(1), mode="sw", free=(True,) * 4,
        width="sat", outputs="trace", interpret=True)
    return pairs, case, {k: np.asarray(v) for k, v in out.items()}


def test_chunked_trace_matches_jax_kernel_in_interpret_mode(jax_chunked_trace):
    pairs, case, want = jax_chunked_trace
    n = len(TALL)
    mine = {k: v[:n] for k, v in case.items()}
    got = run_port(mine, "trace", open_=5, ext=1, mode="sw",
                   free=(True,) * 4)
    assert_same_in_sequence(got, {k: v[:n] for k, v in want.items()}, mine,
                            "trace, the query in chunks")
    for b in range(n):
        ql, rl = len(pairs[b][0]), len(pairs[b][1])
        assert not got["trace_table"][b, ql:].any()
        assert not got["trace_table"][b, :, rl:].any()
    check_golden_pair(got, pairs, 1, "trace", open_=5, ext=1, mode="sw",
                      free=(True,) * 4)


# -- the route ------------------------------------------------------------------


def _shape(B, Qp, Rp, device="cpu"):
    """What plan_route reads of a batch."""
    return types.SimpleNamespace(size=B, qp=Qp, rp=Rp,
                                 device=torch.device(device))


def test_chunked_route_rule():
    plain = ("torch_plain", "batch on the cpu")
    for cls in tk.OUTPUTS:
        # tall: long whatever the cells; one-shot callers too
        assert dispatch.plan_route(_shape(8, 3072, 96), cls, 5, 1) == ROUTE
        assert dispatch.plan_route(_shape(8, 3072, 96), cls, 5, 1,
                                   one_shot=True) == ROUTE
        assert dispatch.plan_route(_shape(8, 3072, 96, "cuda"), cls, 5, 1,
                                   one_shot=True) == ("cuda_chunked",
                                                      ROUTE[1])
        # short pairs stay on K1; so does every banded batch (K1e), whose
        # kernels take any length
        assert dispatch.plan_route(_shape(8, 2048, 256), cls, 5, 1) == plain
        assert dispatch.plan_route(_shape(8, 3072, 96), cls, 5, 1,
                                   banded=True) == plain
        assert dispatch.plan_route(_shape(8, 3072, 96, "cuda"), cls, 5, 1,
                                   one_shot=True, banded=True) == \
            ("cuda_kernel", "")
    # at 2^20 cells: the segment route keeps score and stats, and trace
    # beyond the one-launch plane; one-launch callers and the plane
    # classes take the chunked sweep
    for cls in ("score", "stats"):
        assert dispatch.plan_route(_shape(128, 1024, 1024, "cuda"), cls, 5,
                                   1) == ("cuda_segments", "long pairs")
    assert dispatch.plan_route(_shape(128, 1024, 1024), "trace", 5, 1) == \
        ROUTE
    assert dispatch.plan_route(_shape(1025, 1024, 1024), "trace", 5, 1) == \
        ("torch_segments", "trace plane beyond one launch")
    assert dispatch.plan_route(_shape(1025, 1024, 1024), "trace", 5, 1,
                               one_shot=True) == ROUTE
    for cls in ("table", "stats_table", "rowcol", "stats_rowcol"):
        assert dispatch.plan_route(_shape(2, 1024, 1024, "cuda"), cls, 5,
                                   1) == ("cuda_chunked", ROUTE[1])


def test_launch_takes_the_chunked_route_and_counts_it():
    pairs = dna_pairs(91, TALL[:4])
    p = (port.Aligner.new().matrix(port_matrix(DNA)).gap_open(5)
         .gap_extend(1).local().use_trace().device("cpu").build())
    batch, _, _ = p._pack([q for q, _ in pairs], [r for _, r in pairs])
    assert (batch.qp, batch.rp) == (3072, 96)
    before = dispatch.ROUTE_COUNTS[ROUTE]
    kw = dict(gap_open=5, gap_extend=1, mode="sw", free=(True,) * 4,
              width="sat")
    got = dispatch.launch(batch, outputs="trace", **kw)
    assert dispatch.ROUTE_COUNTS[ROUTE] == before + 1
    want = tk.score_align(batch.ridx, batch.qlen_t, batch.rlen_t,
                          outputs="trace", open_=5, ext=1, mode="sw",
                          free=(True,) * 4, width="sat", table=batch.table,
                          qidx=batch.qidx)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# -- the public calls of the long one-shot path ----------------------------------


@pytest.fixture(scope="module")
def tall_pairs():
    pairs = dna_pairs(92, TALL)
    return [q for q, _ in pairs], [r for _, r in pairs]


@pytest.fixture(scope="module")
def square_pairs():
    pairs = dna_pairs(94, SQUARE)
    return [q for q, _ in pairs], [r for _, r in pairs]


SW51 = [("matrix", (DNA,)), ("gap_open", (5,)), ("gap_extend", (1,)),
        ("local", ())]
SG111 = [("matrix", (DNA,)), ("gap_open", (11,)), ("gap_extend", (1,)),
         ("semi_global", ())]


def _both(cfg):
    return (_configure(ref.Aligner.new(), cfg).build(),
            _configure(port.Aligner.new(), cfg).device("cpu").build())


# SG on four of the tall pairs: the plain walk's time grows with each
# tall bin's Qp + Rp
@pytest.mark.parametrize("cfg, lens", [
    (SW51, TALL), (SG111, [(3072, 96), (2080, 40), (33, 95), (2049, 96)])],
    ids=["sw_5_1", "sg_11_1"])
def test_align_cigars_on_the_chunked_route(cfg, lens):
    pairs = dna_pairs(92, lens)
    qs, rs = [q for q, _ in pairs], [r for _, r in pairs]
    r, p = _both(cfg)
    p_alns, got = p.align_cigars(qs, rs)
    r_alns, want = r.align_cigars(qs, rs)
    assert got == want
    assert [(a.get_score(), a.get_end_query(), a.get_end_ref())
            for a in p_alns] == [(a.get_score(), a.get_end_query(),
                                  a.get_end_ref()) for a in r_alns]
    # align_cigars bins the pairs by shape: the tall bins take the
    # chunked sweep, the short ones K1
    assert set(p.route_counter) == {ROUTE, ("torch_plain",
                                            "batch on the cpu")}
    # use_trace() + cigars() under the plane bound: the same route
    tr = _configure(port.Aligner.new(), cfg + [("use_trace", ())]) \
        .device("cpu").build()
    alns = tr.align_batch(qs, rs)
    assert tr.cigars(alns, qs, rs) == got
    assert set(tr.route_counter) == {ROUTE}
    m = "sw" if cfg is SW51 else "sg"
    for b in (1, 3):
        g = golden.align_seqs(qs[b], rs[b], DNA, *(5, 1) if m == "sw"
                              else (11, 1), m)
        w = golden.walk_trace(g.trace_table, qs[b], rs[b], g.end_query,
                              g.end_ref, m)
        assert got[b] == w.cigar_string()
        np.testing.assert_array_equal(alns[b].fields["trace_table"],
                                      g.trace_table)


def test_ssw_batch_on_the_chunked_route(tall_pairs):
    qs, rs = tall_pairs
    r, p = _both(SW51)

    def view(results):
        return [(s.score1, s.read_begin1, s.read_end1, s.ref_begin1,
                 s.ref_end1, s.cigar_string()) for s in results]

    got = view(p.ssw_batch(qs, rs))
    assert got == view(r.ssw_batch(qs, rs))
    assert set(p.route_counter) == {ROUTE}
    # the windowed pipeline (the reference's takes 24 s here): the same
    # alignments, but a pair with no positive cell reports begins of 0
    win = view(p.ssw_batch(qs, rs, windowed=True))
    assert [s for s in win if s[0] > 0] == [s for s in got if s[0] > 0]
    assert [(s[0], s[2], s[4], s[5]) for s in win] == \
        [(s[0], s[2], s[4], s[5]) for s in got]


@pytest.mark.parametrize("setters", [
    [("use_last_rowcol", ())],
    [("use_stats", ()), ("use_last_rowcol", ())],
    [("use_table", ())],
    [("use_stats", ()), ("use_table", ())]],
    ids=["rowcol", "stats_rowcol", "table", "stats_table"])
def test_planes_on_the_chunked_route(square_pairs, setters):
    # pairs of up to 1,024 x 1,024, long by their cells: the score-valued
    # classes against the reference Aligner on every pair, the stats
    # classes (held to the JAX wavefront above) against golden
    qs, rs = square_pairs
    r, p = _both(SW51 + setters)
    got = p.align_batch(qs, rs)
    stats = setters[0][0] == "use_stats"
    if not stats:
        assert _views(got) == _views(r.align_batch(qs, rs))
    assert set(p.route_counter) == {ROUTE}
    for b in (2, 3):
        g = golden.align_seqs(qs[b], rs[b], DNA, 5, 1, "sw")
        a = got[b]
        names = ("score", "matches", "similar", "length") if stats \
            else ("score",)
        if stats:
            assert (a.get_matches(), a.get_similar(), a.get_length()) == \
                (g.matches, g.similar, g.length)
        for name in names:
            if a.is_rowcol() or a.is_stats_rowcol():
                for side in ("row", "col"):
                    np.testing.assert_array_equal(
                        getattr(a, f"get_{name}_{side}")(),
                        getattr(g, f"{name}_{side}"))
            else:
                np.testing.assert_array_equal(
                    getattr(a, f"get_{name}_table")().as_array(),
                    getattr(g, f"{name}_table"))


# -- on the card -----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("cls", CLASSES)
def test_kernel_matches_plain_and_one_shot(cls, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    pairs = dna_pairs(93, TALL)
    case = pack(pairs, DNA, Qp=3072, Rp=96)
    t = {k: torch.from_numpy(v).to(dev) for k, v in case.items()}
    args = (t["ridx"], t["qlen"], t["rlen"])
    kw = dict(open_=5, ext=1, mode="sw", free=(True,) * 4, width="sat",
              outputs=cls, profile=t["profile"], qidx=t["qidx"])
    want = tk.score_align_plain(*args, **kw)
    for warps in (0, 1, 3, 8):
        monkeypatch.setattr(tk, "SEGMENT_WARPS", warps)
        before = tk.CHUNKED_LAUNCHES
        got = tk.score_chunked(*args, **kw)
        assert tk.CHUNKED_LAUNCHES == before + 1
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (cls, warps, k)
    one = tk.score_align(*args, **kw)
    for k in one:
        assert torch.equal(got[k], one[k]), (cls, k)
