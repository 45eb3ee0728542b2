"""The port's trace + CIGAR path on the CPU against the reference ``Aligner``.

``use_trace()`` results (trace table, CIGAR, traceback strings,
``print_traceback``), ``Aligner.cigars`` and ``Aligner.align_cigars``
go through ``parasail_rs_tpu_torch`` (``device="cpu"``: the plain
PyTorch versions of the trace kernel and the walk) and through
``parasail_rs_tpu`` on its default route (the XLA wavefront and walk
here) and with ``PT_FORCE_PALLAS=1`` (the Pallas trace kernel in
interpret mode).  Everything is compared exactly, against golden where
the reference's own tests do, and the port must report the route it
took.  The configurations and helpers are those of
``test_torch_engine.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import parasail_rs_tpu as ref  # noqa: E402
from parasail_rs_tpu.golden import model as golden  # noqa: E402

import parasail_rs_tpu_torch as port  # noqa: E402
from parasail_rs_tpu_torch.engine import dispatch  # noqa: E402

from test_torch_engine import (  # noqa: E402
    BLOSUM62,
    CASES,
    MOTIF,
    PROTEIN,
    PSSM,
    _both,
    _configure,
    port_matrix,
    _seqs,
    _summary,
)

# -- trace + CIGAR -----------------------------------------------------------

CPU_ROUTE = {("torch_plain", "batch on the cpu")}


def _trace_views(alignments, qs, rs):
    """Everything a trace result shows: scalars, flags, the plane, the
    CIGAR and the traceback strings."""
    out = []
    for a, q, r in zip(alignments, qs, rs):
        tb = a.get_traceback_strings(q, r)
        out.append((a.get_score(), a.get_end_query(), a.get_end_ref(),
                    a.is_trace(), a.is_saturated(),
                    a.get_trace_table().as_array().tolist(),
                    a.get_cigar(q, r), tb.query, tb.comparison,
                    tb.reference))
    return out


@pytest.mark.parametrize("forced", [False, True],
                         ids=["reference_default", "reference_pallas"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_use_trace_matches_reference(name, forced, monkeypatch):
    cfg, qs, rs = CASES[name]
    if forced:
        monkeypatch.setenv("PT_FORCE_PALLAS", "1")
    r, p = _both(cfg + [("use_trace", ())])
    r_alns, p_alns = r.align_batch(qs, rs), p.align_batch(qs, rs)
    assert _trace_views(p_alns, qs, rs) == _trace_views(r_alns, qs, rs)
    assert p.cigars(p_alns, qs, rs) == r.cigars(r_alns, qs, rs)
    assert set(p.route_counter) == CPU_ROUTE


def test_print_traceback_matches_reference(capsys):
    cfg = [("matrix", (BLOSUM62,)), ("gap_open", (11,)),
           ("gap_extend", (1,)), ("local", ()), ("use_trace", ())]
    q, r_ = b"HEAGAWGHEEMKVLATPAWHEAE", b"PAWHEAEHEAGAWGHEKVLAT"
    r, p = _both(cfg)
    r.align(q, r_).print_traceback(q, r_)
    want = capsys.readouterr().out
    p.align(q, r_).print_traceback(q, r_)
    assert capsys.readouterr().out == want
    assert "Score:" in want


# name -> (builder config, queries, references, profile query or None);
# the cases of the reference's tests/test_trace_walk.py
CIGAR_CASES = {
    "nw_dna": ([("gap_open", (5,)), ("gap_extend", (2,))],
               _seqs(31, b"ACGT", 16, 5, 40), _seqs(32, b"ACGT", 16, 5, 40)),
    "sw_blosum": ([("matrix", (BLOSUM62,)), ("gap_open", (11,)),
                   ("gap_extend", (1,)), ("local", ())],
                  _seqs(33, PROTEIN, 16, 10, 60),
                  _seqs(34, PROTEIN, 16, 10, 60)),
    "sw_zero_score": ([("gap_open", (5,)), ("gap_extend", (2,)),
                       ("local", ())], [b"AAAA"], [b"CCCC"]),
    **{f"sg_free_{k}": ([("semi_global", ()), ("allow_query_gaps", (qg,)),
                         ("allow_ref_gaps", (dg,)), ("gap_open", (4,)),
                         ("gap_extend", (1,))],
                        _seqs(40 + k, b"ACGT", 8, 4, 30),
                        _seqs(50 + k, b"ACGT", 8, 4, 30))
       for k, (qg, dg) in enumerate([
           ([], []), (["prefix"], []), ([], ["suffix"]),
           (["prefix", "suffix"], ["prefix", "suffix"]),
           (["suffix"], ["prefix"])])},
    "nw_open_below_extend": ([("gap_open", (1,)), ("gap_extend", (5,))],
                             _seqs(35, b"ACGT", 8, 6, 30),
                             _seqs(36, b"ACGT", 8, 6, 30)),
    "sw_open_below_extend": ([("gap_open", (2,)), ("gap_extend", (3,)),
                              ("local", ())],
                             _seqs(35, b"ACGT", 8, 6, 30),
                             _seqs(36, b"ACGT", 8, 6, 30)),
    "mixed_case": ([("gap_open", (5,)), ("gap_extend", (2,))],
                   [b"acgt", b"ACgtAC"], [b"ACGT", b"acGTac"]),
    "pssm_sg": ([("matrix", (PSSM,)), ("gap_open", (5,)),
                 ("gap_extend", (2,)), ("semi_global", ())],
                _seqs(37, b"ACGT", 8, 1, 30), _seqs(38, b"ACGT", 8, 1, 30)),
}


def _check_cigars(cfg, qs, rs, forced, monkeypatch):
    """The port's align_cigars == the reference's == the port's own
    use_trace get_cigar, with the same scalars."""
    if forced:
        monkeypatch.setenv("PT_FORCE_PALLAS", "1")
    r, p = _both(cfg)
    r_alns, want = r.align_cigars(qs, rs)
    p_alns, got = p.align_cigars(qs, rs)
    assert got == want
    assert _summary(p_alns) == _summary(r_alns)
    assert not any(a.is_trace() for a in p_alns)
    tr = _configure(port.Aligner.new(), cfg + [("use_trace", ())]) \
        .device("cpu").build()
    assert got == [a.get_cigar(q, r_)
                   for a, q, r_ in zip(tr.align_batch(qs, rs), qs, rs)]
    assert set(p.route_counter) == CPU_ROUTE
    return got


@pytest.mark.parametrize("forced", [False, True],
                         ids=["reference_default", "reference_pallas"])
@pytest.mark.parametrize("name", sorted(CIGAR_CASES))
def test_align_cigars_matches_reference(name, forced, monkeypatch):
    _check_cigars(*CIGAR_CASES[name], forced, monkeypatch)


def test_align_cigars_mixed_case_is_raw_bytes(monkeypatch):
    got = _check_cigars([("gap_open", (5,)), ("gap_extend", (2,))],
                        [b"acgt"], [b"ACGT"], False, monkeypatch)
    assert got == ["4X"]


@pytest.mark.parametrize("forced", [False, True],
                         ids=["reference_default", "reference_pallas"])
def test_align_cigars_shared_profile(forced, monkeypatch):
    if forced:
        monkeypatch.setenv("PT_FORCE_PALLAS", "1")
    q = _seqs(61, PROTEIN, 1, 20, 30)[0]
    rs = _seqs(62, PROTEIN, 6, 15, 40)
    r_prof = ref.Profile.new(q, False, BLOSUM62)
    p_prof = port.Profile.new(q, False, port_matrix(BLOSUM62))
    r = (ref.Aligner.new().profile(r_prof).gap_open(11).gap_extend(1)
         .local().build())
    p = (port.Aligner.new().profile(p_prof).gap_open(11).gap_extend(1)
         .local().device("cpu").build())
    r_alns, want = r.align_cigars(None, rs)
    p_alns, got = p.align_cigars(None, rs)
    assert got == want
    assert _summary(p_alns) == _summary(r_alns)
    # a profile aligner ignores the queries passed in
    assert p.align_cigars([b"WWWW"] * len(rs), rs)[1] == want
    tr = (port.Aligner.new().profile(p_prof).gap_open(11).gap_extend(1)
          .local().use_trace().device("cpu").build())
    assert got == [a.get_cigar(q, r_)
                   for a, r_ in zip(tr.align_batch(None, rs), rs)]
    assert set(p.route_counter) == CPU_ROUTE


def test_align_cigars_empty_batch():
    p = port.Aligner.new().device("cpu").build()
    assert p.align_cigars([], []) == ([], [])
    assert p.cigars([], [], []) == []


def test_align_cigars_mixed_lengths_binned(monkeypatch):
    qs = (_seqs(71, b"ACGT", 4, 4, 10) + _seqs(72, b"ACGT", 4, 200, 400) +
          _seqs(73, b"ACGT", 4, 30, 60))
    rs = (_seqs(74, b"ACGT", 4, 4, 10) + _seqs(75, b"ACGT", 4, 200, 400) +
          _seqs(76, b"ACGT", 4, 30, 60))
    _check_cigars([("gap_open", (4,)), ("gap_extend", (1,)), ("local", ())],
                  qs, rs, False, monkeypatch)


def test_align_cigars_submits_every_bin_before_the_first_fetch(monkeypatch):
    # three lengths, three bins: every walk is enqueued before the host
    # waits for the first one's opcodes
    qs = (_seqs(91, b"ACGT", 3, 4, 10) + _seqs(92, b"ACGT", 3, 200, 400) +
          _seqs(93, b"ACGT", 3, 30, 60))
    rs = (_seqs(94, b"ACGT", 3, 4, 10) + _seqs(95, b"ACGT", 3, 200, 400) +
          _seqs(96, b"ACGT", 3, 30, 60))
    p = (port.Aligner.new().gap_open(5).gap_extend(2).local().device("cpu")
         .build())
    want = p.align_cigars(qs, rs)
    events = []
    real_submit, real_fetch = dispatch.submit, dispatch.PendingResult.fetch

    def submit(batch, **kw):
        events.append("submit")
        return real_submit(batch, **kw)

    def fetch(self):
        events.append("fetch")
        return real_fetch(self)

    monkeypatch.setattr(dispatch, "submit", submit)
    monkeypatch.setattr(dispatch.PendingResult, "fetch", fetch)
    alns, cigs = p.align_cigars(qs, rs)
    n = events.count("submit")
    assert n >= 2 and events == ["submit"] * n + ["fetch"] * n
    assert cigs == want[1] and _summary(alns) == _summary(want[0])


def test_align_cigars_chunked_matches_unchunked(monkeypatch):
    qs = _seqs(81, PROTEIN, 70, 20, 60)
    rs = _seqs(82, PROTEIN, 70, 20, 60)
    p = (port.Aligner.new().matrix(port_matrix(BLOSUM62)).gap_open(11)
         .gap_extend(1).semi_global().device("cpu").build())
    monkeypatch.setattr(port.Aligner, "_CIGAR_CHUNK", 1 << 30)
    alns1, cigs1 = p.align_cigars(qs, rs)
    monkeypatch.setattr(port.Aligner, "_CIGAR_CHUNK", 32)   # 3 chunks
    alns2, cigs2 = p.align_cigars(qs, rs)
    assert cigs1 == cigs2
    assert _summary(alns1) == _summary(alns2)
    r = (ref.Aligner.new().matrix(BLOSUM62).gap_open(11).gap_extend(1)
         .semi_global().build())
    assert cigs1 == r.align_cigars(qs, rs)[1]


def test_align_cigars_more_than_one_chunk_matches_reference(monkeypatch):
    # 600 pairs: two chunks of the default 512
    qs = _seqs(83, b"ACGT", 600, 8, 16)
    rs = _seqs(84, b"ACGT", 600, 8, 16)
    calls = []
    real = dispatch.submit

    def counted(batch, **kw):
        if kw.get("walk"):
            calls.append(batch.size)
        return real(batch, **kw)

    monkeypatch.setattr(dispatch, "submit", counted)
    _check_cigars([("gap_open", (5,)), ("gap_extend", (2,)), ("local", ())],
                  qs, rs, False, monkeypatch)
    assert calls == [512, 88]


@pytest.mark.parametrize("use_trace", [False, True],
                         ids=["align_cigars", "use_trace"])
def test_width64_trace_refills_pairs_beyond_int32(use_trace, monkeypatch):
    # force the int32 risk bound down so the int64 golden merge runs
    monkeypatch.setattr(dispatch, "INT32_SAFE", 10)
    cfg, qs, rs = CASES["sw_blosum62"]
    cfg = cfg + [("solution_width", (64,))]
    if use_trace:
        r, p = _both(cfg + [("use_trace", ())])
        assert _trace_views(p.align_batch(qs, rs), qs, rs) == \
            _trace_views(r.align_batch(qs, rs), qs, rs)
    else:
        _check_cigars(cfg, qs, rs, False, monkeypatch)


# The CIGAR expectations of the reference's tests/test_golden.py:
# builder config, query, reference, CIGAR, begin cell, traceback strings
CIGAR_EXPECTATIONS = {
    "perfect_nw": ([], b"ACGT", b"ACGT", "4=", (0, 0),
                   ("ACGT", "||||", "ACGT")),
    "gap_cigar": ([("gap_open", (1,)), ("gap_extend", (1,))], b"ACGT",
                  b"ACT", "2=1I1=", (0, 0), ("ACGT", None, "AC-T")),
    "deletion_cigar": ([("gap_open", (1,)), ("gap_extend", (1,))], b"ACT",
                       b"ACGT", "2=1D1=", (0, 0), None),
    "local_motif": ([("matrix", (MOTIF,)), ("gap_open", (5,)),
                     ("gap_extend", (2,)), ("local", ())],
                    b"TTTACGTTT", b"GGGACGGGG", "3=", (3, 3), None),
    "sg_excludes_free_overhang": ([("gap_open", (2,)), ("gap_extend", (1,)),
                                   ("semi_global", ())],
                                  b"ACGT", b"TTACGTTT", "4=", (0, 2), None),
}


@pytest.mark.parametrize("name", sorted(CIGAR_EXPECTATIONS))
def test_reference_cigar_expectations(name):
    cfg, q, r, cigar, beg, strings = CIGAR_EXPECTATIONS[name]
    a = _configure(port.Aligner.new(), cfg + [("use_trace", ())]) \
        .device("cpu").build()
    res = a.align(q, r)
    assert res.get_cigar(q, r) == cigar
    w = res._walk(q, r)
    assert (w.beg_query, w.beg_ref) == beg
    if strings is not None:
        tb = res.get_traceback_strings(q, r)
        got = (tb.query, tb.comparison, tb.reference)
        assert all(w is None or g == w for g, w in zip(got, strings))
    p = _configure(port.Aligner.new(), cfg).device("cpu").build()
    assert p.align_cigars([q], [r])[1] == [cigar]


@pytest.mark.parametrize("mk", ["global_", "semi_global"])
def test_empty_side_pairs_follow_golden_through_the_api(mk):
    qs = [b"", b"ACGT", b"ACGTACGTACGTACGTACGTACGTACGTAC", b""]
    rs = [b"ACGT", b"", b"ACGTAC", b""]
    mode = {"global_": "nw", "semi_global": "sg"}[mk]
    b = getattr(port.Aligner.new(), mk)().gap_open(5).gap_extend(2) \
        .device("cpu")
    want, want_cigs = [], []
    for q, r in zip(qs, rs):
        g = golden.align_seqs(q, r, port.Matrix.default(), 5, 2, mode)
        want.append((g.score, g.end_query, g.end_ref))
        want_cigs.append(golden.walk_trace(g.trace_table, q, r, g.end_query,
                                           g.end_ref, mode).cigar_string())
    alns = b.build().align_batch(qs, rs)
    assert [(a.get_score(), a.get_end_query(), a.get_end_ref())
            for a in alns] == want
    assert b.build().align_cigars(qs, rs)[1] == want_cigs
    traced = b.use_trace().build()
    assert [a.get_cigar(q, r) for a, q, r in
            zip(traced.align_batch(qs, rs), qs, rs)] == want_cigs
    if mode == "nw":
        assert want_cigs[:2] == ["4D", "4I"] and want[0][0] == -11


def test_cigars_needs_trace_results():
    p = port.Aligner.new().device("cpu").build()
    alns = p.align_batch([b"AC"], [b"AC"])
    with pytest.raises(port.errors.NoTrace):
        p.cigars(alns, [b"AC"], [b"AC"])
    with pytest.raises(port.errors.NoTrace):
        alns[0].get_cigar(b"AC", b"AC")


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CIGAR_CASES))
def test_card_cigars_match_cpu(name, cuda_device):
    from parasail_rs_tpu_torch.ops import scan_kernel as tk
    from parasail_rs_tpu_torch.ops import trace_walk as tw

    cfg, qs, rs = CIGAR_CASES[name]
    cpu = _configure(port.Aligner.new(), cfg).device("cpu").build()
    card = _configure(port.Aligner.new(), cfg).device(cuda_device).build()
    before = (tk.SHORT_LAUNCHES["trace"], tw.LAUNCHES)
    alns, cigs = card.align_cigars(qs, rs)
    assert tk.SHORT_LAUNCHES["trace"] > before[0] and \
        tw.LAUNCHES > before[1]
    c_alns, c_cigs = cpu.align_cigars(qs, rs)
    assert cigs == c_cigs and _summary(alns) == _summary(c_alns)
    traced = _configure(port.Aligner.new(), cfg + [("use_trace", ())]) \
        .device(cuda_device).build()
    t_alns = traced.align_batch(qs, rs)
    assert traced.cigars(t_alns, qs, rs) == cigs
    assert set(card.route_counter) == {("cuda_kernel", "")}
    assert set(traced.route_counter) == {("cuda_kernel", "")}
