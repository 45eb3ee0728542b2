"""The port's stats, table and rowcol classes on the CPU against the
reference ``Aligner``.

``use_stats()``, ``use_table()`` and ``use_last_rowcol()`` results, alone
and combined, go through ``parasail_rs_tpu_torch`` (``device="cpu"``: the
wavefront, the plain version of the kernel's stats and plane forms) and
through ``parasail_rs_tpu`` on its default route (the XLA wavefront here)
and with ``PT_FORCE_PALLAS=1`` (the Pallas kernel in interpret mode at
open > ext; at open <= ext its ``trace_walk`` route, the trace kernel
plus the device walk's stats mode).  Every accessor must agree exactly,
golden's expectations from the reference's own tests must hold, and
every case asserts the route each package took.  The configurations and
helpers are those of ``test_torch_engine.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parasail_rs_tpu as ref  # noqa: E402
from parasail_rs_tpu.golden import model as golden  # noqa: E402

import parasail_rs_tpu_torch as port  # noqa: E402
from parasail_rs_tpu_torch.engine import dispatch  # noqa: E402

from test_torch_engine import (  # noqa: E402
    BLOSUM62,
    CASES,
    IDENT,
    PROTEIN,
    _configure,
    port_matrix,
    _seqs,
    _summary,
)

CPU_ROUTE = {("torch_plain", "batch on the cpu")}
SETTERS = {"stats": [("use_stats", ())], "table": [("use_table", ())],
           "stats_table": [("use_stats", ()), ("use_table", ())],
           "rowcol": [("use_last_rowcol", ())],
           "stats_rowcol": [("use_last_rowcol", ()), ("use_stats", ())]}


def _views(alignments):
    """Everything a stats / table / rowcol result shows: the score-class
    summary, then each accessor its class allows."""
    out = []
    for s, a in zip(_summary(alignments), alignments):
        v = [s]
        if a.is_stats():
            v.append((a.get_matches(), a.get_similar(), a.get_length()))
        if a.is_table() or a.is_stats_table():
            v.append(a.get_score_table().as_array().tolist())
        if a.is_stats_table():
            v += [t.as_array().tolist() for t in (
                a.get_matches_table(), a.get_similar_table(),
                a.get_length_table())]
        if a.is_rowcol() or a.is_stats_rowcol():
            v += [np.asarray(a.get_score_row()).tolist(),
                  np.asarray(a.get_score_col()).tolist()]
        if a.is_stats_rowcol():
            v += [np.asarray(f()).tolist() for f in (
                a.get_matches_row, a.get_matches_col, a.get_similar_row,
                a.get_similar_col, a.get_length_row, a.get_length_col)]
        out.append(v)
    return out


def _ref_routes(fn):
    """(fn's result, the reference's routes it took)."""
    # imported here: the reference's engine loads jax, which the card's
    # machine lacks, and the tests marked cuda run there without it
    from parasail_rs_tpu.engine import dispatch as ref_dispatch

    before = dict(ref_dispatch.ROUTE_COUNTS)
    res = fn()
    after = ref_dispatch.ROUTE_COUNTS
    return res, {k for k in after if after[k] != before.get(k, 0)}


def _ref_route_expected(forced, outputs, gap_open, gap_extend):
    if not forced:
        return "wavefront"
    stats = outputs in ("stats", "stats_table", "stats_rowcol")
    if stats and gap_open <= gap_extend:
        return "trace_walk" if outputs == "stats" else "wavefront"
    return "pallas"


def _check(cfg, qs, rs, forced, monkeypatch, outputs):
    if forced:
        monkeypatch.setenv("PT_FORCE_PALLAS", "1")
    r = _configure(ref.Aligner.new(), cfg).build()
    p = _configure(port.Aligner.new(), cfg).device("cpu").build()
    assert p.key.outputs == r.key.outputs == outputs
    want, routes = _ref_routes(lambda: _views(r.align_batch(qs, rs)))
    route = _ref_route_expected(forced, outputs, r.gap_open, r.gap_extend)
    assert {k[0] for k in routes} == {route}, routes
    assert _views(p.align_batch(qs, rs)) == want
    assert set(p.route_counter) == CPU_ROUTE
    return p


# every output class on every configuration of test_torch_engine.py would
# be 40 reference compiles per route; the configurations take the classes
# in turn instead, so every class meets one or two of them
ROTATION = [(name, list(SETTERS)[n % 5])
            for n, name in enumerate(sorted(CASES))]


@pytest.mark.parametrize("forced", [False, True],
                         ids=["reference_default", "reference_pallas"])
@pytest.mark.parametrize("name,outputs", ROTATION)
def test_classes_match_reference(name, outputs, forced, monkeypatch):
    cfg, qs, rs = CASES[name]
    _check(cfg + SETTERS[outputs], qs, rs, forced, monkeypatch, outputs)


@pytest.mark.parametrize("open_,ext", [(1, 3), (0, 0), (2, 2)])
@pytest.mark.parametrize("mode", ["global_", "local", "semi_global"])
def test_stats_open_le_ext_match_reference_walk_route(mode, open_, ext,
                                                      monkeypatch):
    # tests/test_trace_walk.py:171-196: the reference's walk route, and
    # golden, at open <= ext
    qs, rs = _seqs(31, b"ACGT", 6, 4, 28), _seqs(32, b"ACGT", 6, 4, 28)
    cfg = [(mode, ()), ("gap_open", (open_,)), ("gap_extend", (ext,)),
           ("use_stats", ())]
    p = _check(cfg, qs, rs, True, monkeypatch, "stats")
    g_mode = {"global_": "nw", "local": "sw", "semi_global": "sg"}[mode]
    for a, q, r in zip(p.align_batch(qs, rs), qs, rs):
        g = golden.align_seqs(q, r, p.matrix, open_, ext, g_mode)
        assert (a.get_score(), a.get_end_query(), a.get_end_ref(),
                a.get_matches(), a.get_similar(), a.get_length()) == \
            (g.score, g.end_query, g.end_ref, g.matches, g.similar, g.length)


@pytest.mark.parametrize("qg,dg", [(["prefix"], []), ([], ["suffix"]),
                                   (["suffix"], ["prefix"])])
def test_stats_open_le_ext_sg_free_variants(qg, dg, monkeypatch):
    # tests/test_trace_walk.py:199-216
    qs, rs = _seqs(33, b"ACGT", 4, 4, 20), _seqs(34, b"ACGT", 4, 4, 20)
    cfg = [("semi_global", ()), ("allow_query_gaps", (qg,)),
           ("allow_ref_gaps", (dg,)), ("gap_open", (1,)),
           ("gap_extend", (4,)), ("use_stats", ())]
    _check(cfg, qs, rs, True, monkeypatch, "stats")


@pytest.mark.parametrize("forced", [False, True],
                         ids=["reference_default", "reference_pallas"])
def test_stats_blosum_profile_matches_reference(forced, monkeypatch):
    # tests/test_trace_walk.py:219-234: Profile.use_stats selects stats
    q = _seqs(35, PROTEIN, 1, 15, 25)[0]
    rs = _seqs(36, PROTEIN, 5, 10, 30)
    if forced:
        monkeypatch.setenv("PT_FORCE_PALLAS", "1")
    r = (ref.Aligner.new().profile(ref.Profile.new(q, True, BLOSUM62))
         .gap_open(1).gap_extend(2).local().build())
    p = (port.Aligner.new().profile(port.Profile.new(
        q, True, port_matrix(BLOSUM62)))
         .gap_open(1).gap_extend(2).local().device("cpu").build())
    assert p.key.outputs == "stats"
    want, routes = _ref_routes(lambda: _views(r.align_batch(None, rs)))
    assert {k[0] for k in routes} == {
        "trace_walk" if forced else "wavefront"}
    assert _views(p.align_batch(None, rs)) == want
    assert set(p.route_counter) == CPU_ROUTE
    for a, ref_seq in zip(p.align_batch(None, rs), rs):
        g = golden.align_seqs(q, ref_seq, BLOSUM62, 1, 2, "sw")
        assert (a.get_matches(), a.get_similar(), a.get_length()) == \
            (g.matches, g.similar, g.length)


def test_profile_use_stats_table_matches_reference(monkeypatch):
    # tests/test_engine.py:110-125: a profile with and without stats
    m = ref.Matrix.create(b"ACGT", 3, -2)
    q, refs = b"ACGT", [b"ACGT", b"ACGTT", b"TTACG"]
    for use_stats, outputs in ((False, "table"), (True, "stats_table")):
        r = (ref.Aligner.new().profile(ref.Profile.new(q, use_stats, m))
             .use_stats().use_table().build())
        p = (port.Aligner.new().profile(port.Profile.new(
            q, use_stats, port_matrix(m)))
             .use_stats().use_table().device("cpu").build())
        assert p.key.outputs == r.key.outputs == outputs
        want, routes = _ref_routes(lambda: _views(r.align_batch(None, refs)))
        assert {k[0] for k in routes} == {"wavefront"}
        assert _views(p.align_batch(None, refs)) == want
        assert p.align(None, b"ACGT").get_score_table().last() == 12
        assert set(p.route_counter) == CPU_ROUTE


def test_mixed_case_pair_counts_matches(monkeypatch):
    # tests/test_trace_walk.py:259-264: stats compare mapped letters, so
    # acgt against ACGT is 4 matches, where the CIGAR says 4X
    q, r = b"acgt", b"ACGT"
    monkeypatch.setenv("PT_FORCE_PALLAS", "1")
    ref_al = ref.Aligner.new().gap_open(1).gap_extend(2).use_stats().build()
    (want,), routes = _ref_routes(lambda: _views([ref_al.align(q, r)]))
    assert {k[0] for k in routes} == {"trace_walk"}
    p = port.Aligner.new().gap_open(1).gap_extend(2).use_stats() \
        .device("cpu").build()
    a = p.align(q, r)
    assert a.get_matches() == 4 and _views([a]) == [want]
    assert set(p.route_counter) == CPU_ROUTE


# -- golden's expectations (tests/test_engine.py:65-180, test_golden.py) ----

def _cpu(*cfg):
    return _configure(port.Aligner.new(), list(cfg)).device("cpu").build()


@pytest.mark.parametrize("mode", ["global_", "semi_global", "local"])
def test_with_stats(mode):
    res = _cpu(("use_stats", ()), ("striped", ()), (mode, ())).align(
        b"ACGT", b"ACGT")
    assert (res.get_matches(), res.get_length(), res.is_stats()) == \
        (4, 4, True)


def test_tables_and_rowcol_expectations():
    t = _cpu(("use_table", ())).align(b"ACGT", b"ACGT")
    assert t.is_table() and not t.is_stats() and not t.is_stats_table()
    table = t.get_score_table()
    assert (table.rows(), table.cols(), table.last()) == (4, 4, 4)
    assert table.get(0, 0) is not None and table.get(99, 0) is None
    m3 = ref.Matrix.create(b"ACGT", 3, -2)
    assert _cpu(("matrix", (m3,)), ("use_table", ())).align(
        b"ACGT", b"ACGT").get_score_table().last() == 12
    st = _cpu(("use_table", ()), ("use_stats", ())).align(b"ACGT", b"ACGTT")
    assert st.is_stats_table() and st.get_matches_table().last() == 4
    assert st.get_matches_table().rows() == 4
    assert st.get_matches_table().cols() == 5
    lt = _cpu(("use_table", ()), ("use_stats", ())).align(b"ACGT", b"ACGTTT")
    assert lt.get_length_table().as_array().shape == (4, 6)
    rc = _cpu(("use_last_rowcol", ()), ("use_stats", ())).align(
        b"ACGT", b"ACG")
    assert rc.is_stats_rowcol() and not rc.is_stats_table()
    for f, want in ((rc.get_score_row, [1, 2, 3]),
                    (rc.get_matches_row, [1, 2, 3]),
                    (rc.get_similar_row, [1, 2, 3]),
                    (rc.get_length_row, [4, 4, 4])):
        assert np.asarray(f()).tolist() == want
    cc = _cpu(("use_last_rowcol", ()), ("use_stats", ())).align(
        b"ACG", b"ACGT")
    for f, want in ((cc.get_score_col, [1, 2, 3]),
                    (cc.get_matches_col, [1, 2, 3]),
                    (cc.get_similar_col, [1, 2, 3]),
                    (cc.get_length_col, [4, 4, 4])):
        assert np.asarray(f()).tolist() == want
    plain_rc = _cpu(("use_last_rowcol", ())).align(b"ACGT", b"ACG")
    assert plain_rc.is_rowcol() and not plain_rc.is_stats()
    with pytest.raises(port.errors.NoRowCol):
        plain_rc.get_matches_row()
    with pytest.raises(port.errors.NoStats):
        plain_rc.get_matches()


def test_local_tables_clamped_and_similar_counts():
    motif = ref.Matrix.create(b"ACGT", 2, -3)
    t = _cpu(("matrix", (motif,)), ("gap_open", (5,)), ("gap_extend", (2,)),
             ("local", ()), ("use_table", ()), ("use_stats", ())).align(
        b"AC", b"GT")
    assert t.get_score() == 0 and (t.get_score_table().as_array() >= 0).all()
    assert (t.get_matches(), t.get_similar(), t.get_length()) == (0, 0, 0)
    s = _cpu(("use_stats", ())).align(b"AN", b"AN")
    assert (s.get_score(), s.get_matches(), s.get_similar()) == (1, 2, 1)


@pytest.mark.parametrize("mk", ["global_", "semi_global", "local"])
def test_empty_side_pairs_follow_golden_through_the_api(mk):
    qs = [b"", b"ACGT", b"ACGTACGTACGTACGTACGTACGTACGTAC", b""]
    rs = [b"ACGT", b"", b"ACGTAC", b""]
    mode = {"global_": "nw", "semi_global": "sg", "local": "sw"}[mk]
    p = _cpu((mk, ()), ("gap_open", (5,)), ("gap_extend", (2,)),
             ("use_stats", ()), ("use_last_rowcol", ()))
    for a, q, r in zip(p.align_batch(qs, rs), qs, rs):
        got = (a.get_score(), a.get_end_query(), a.get_end_ref(),
               a.get_matches(), a.get_similar(), a.get_length())
        if mode == "sw" and not (q and r):
            assert got == (0,) * 6      # golden's empty local alignment
            continue
        g = golden.align_seqs(q, r, IDENT, 5, 2, mode)
        assert got == (g.score, g.end_query, g.end_ref, g.matches,
                       g.similar, g.length)
    if mode == "nw":
        assert [a.get_length() for a in p.align_batch(qs[:2], rs[:2])] \
            == [4, 4]


def test_width64_rowcol_and_stats_merge(monkeypatch):
    # tests/test_engine.py:727-745: the int64 merge covers rowcol, and the
    # stats classes, on a pair whose scores pass the int32 bound
    m = ref.Matrix.create(b"ACGT", 8_000_000, -8_000_000)
    q, r = b"ACGTACGTACGTACGTACGTACGTACGTACGTACGT" * 6, b"ACGTTT" * 36
    p = _cpu(("matrix", (m,)), ("gap_open", (5,)), ("gap_extend", (1,)),
             ("global_", ()), ("solution_width", (64,)),
             ("use_last_rowcol", ()))
    res = p.align(q, r)
    g = golden.align_seqs(q, r, m, 5, 1, "nw")
    assert res.get_score() == g.score
    np.testing.assert_array_equal(np.asarray(res.get_score_row()),
                                  g.score_table[-1, :])
    np.testing.assert_array_equal(np.asarray(res.get_score_col()),
                                  g.score_table[:, -1])
    cfg = [("matrix", (m,)), ("gap_open", (5,)), ("gap_extend", (1,)),
           ("local", ()), ("solution_width", (64,)), ("use_stats", ()),
           ("use_table", ())]
    pairs = ([q, b"ACGT"], [r, b"ACGA"])
    got = _views(_cpu(*cfg).align_batch(*pairs))
    want = _views(_configure(ref.Aligner.new(), cfg).build().align_batch(
        *pairs))
    assert got == want
    gs = golden.align_seqs(q, r, m, 5, 1, "sw")
    assert got[0][1] == (gs.matches, gs.similar, gs.length)
    # with the bound forced down every pair takes the merge
    monkeypatch.setattr(dispatch, "INT32_SAFE", 10)
    assert _views(_cpu(*cfg[:-1], ("use_last_rowcol", ())).align_batch(
        *pairs)) == _views(_configure(
            ref.Aligner.new(), cfg[:-1] + [("use_last_rowcol", ())]).build()
            .align_batch(*pairs))


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", list(SETTERS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_card_route_matches_cpu(name, outputs, cuda_device):
    from parasail_rs_tpu_torch.ops import scan_kernel as tk

    cfg, qs, rs = CASES[name]
    cfg = cfg + SETTERS[outputs]
    cpu = _configure(port.Aligner.new(), cfg).device("cpu").build()
    card = _configure(port.Aligner.new(), cfg).device(cuda_device).build()
    # every class is the short form's
    before = tk.SHORT_LAUNCHES[outputs]
    got = _views(card.align_batch(qs, rs))
    assert tk.SHORT_LAUNCHES[outputs] == before + 1
    assert got == _views(cpu.align_batch(qs, rs))
    assert set(card.route_counter) == {("cuda_kernel", "")}
