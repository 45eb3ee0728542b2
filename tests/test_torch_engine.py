"""The port's public API on the CPU against the reference ``Aligner``.

The same builder calls and byte sequences go through
``parasail_rs_tpu_torch`` (``device="cpu"``: the plain PyTorch versions
of the kernels) and through ``parasail_rs_tpu`` on its default route
(the XLA wavefront here) and with ``PT_FORCE_PALLAS=1`` (the Pallas scan
kernel in interpret mode).  Every accessor of the score class must agree
exactly, and the port must report the route it took.  The trace class,
``cigars`` and ``align_cigars`` are held to the reference the same way
in ``test_torch_engine_trace.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parasail_rs_tpu as ref  # noqa: E402
from parasail_rs_tpu.golden import model as golden  # noqa: E402

import parasail_rs_tpu_torch as port  # noqa: E402
from parasail_rs_tpu_torch import convert  # noqa: E402
from parasail_rs_tpu_torch.engine import dispatch  # noqa: E402

PROTEIN = b"ARNDCQEGHILKMFPSTWYV"
PREDICATES = ("is_global", "is_semi_global", "is_local", "is_saturated",
              "is_banded", "is_scan", "is_striped", "is_diag", "is_blocked",
              "is_stats", "is_stats_table", "is_table", "is_rowcol",
              "is_stats_rowcol", "is_trace")


def _seqs(seed, alphabet, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.choice(list(alphabet), size=rng.integers(lo, hi))
            .astype(np.uint8).tobytes() for _ in range(n)]


def port_matrix(m):
    """A reference Matrix carried across to the port's own class."""
    return convert.matrix_from_reference(
        data=m.data, mapper=m.mapper, alphabet=m.alphabet, kind=m.kind,
        name=m.name, builtin=m.builtin, approximate=m.approximate,
        query=m.query)


def matrix_for(builder, m):
    """``m``, built once with the reference, as the class of the package
    ``builder`` belongs to."""
    return port_matrix(m) if isinstance(builder, port.AlignerBuilder) else m


def _configure(builder, cfg):
    """Apply one configuration (a list of (method, args)) to a builder;
    a matrix among the arguments goes to the port as the port's class."""
    for name, args in cfg:
        args = tuple(matrix_for(builder, a) if isinstance(a, ref.Matrix)
                     else a for a in args)
        builder = getattr(builder, name)(*args)
    return builder


def _summary(alignments):
    return [(a.get_score(), a.get_end_query(), a.get_end_ref(),
             *(getattr(a, p)() for p in PREDICATES)) for a in alignments]


BLOSUM62 = ref.Matrix.from_name("blosum62")
DNA = ref.Matrix.create(b"ACGT", 2, -3)
PSSM = ref.Matrix.create_pssm(
    b"ACGT", np.random.default_rng(3).integers(-3, 6, size=30 * 4), 30)

# name -> (builder config, queries, references)
CASES = {
    "sw_blosum62": ([("matrix", (BLOSUM62,)), ("gap_open", (11,)),
                     ("gap_extend", (1,)), ("local", ())],
                    _seqs(1, PROTEIN, 24, 1, 30), _seqs(2, PROTEIN, 24, 1, 30)),
    "nw_default_dna": ([], _seqs(3, b"ACGT", 16, 1, 30),
                       _seqs(4, b"ACGT", 16, 1, 30)),
    "nw_dna_gaps_width16": ([("gap_open", (5,)), ("gap_extend", (2,)),
                             ("solution_width", (16,))],
                            _seqs(5, b"ACGT", 16, 1, 30),
                            _seqs(6, b"ACGT", 16, 1, 30)),
    "sg_query_gaps": ([("matrix", (DNA,)), ("gap_open", (5,)),
                       ("gap_extend", (2,)), ("semi_global", ()),
                       ("allow_query_gaps", (["prefix", "suffix"],))],
                      _seqs(7, b"ACGT", 16, 1, 30),
                      _seqs(8, b"ACGT", 16, 1, 30)),
    "sg_ref_gaps": ([("matrix", (DNA,)), ("gap_open", (5,)),
                     ("gap_extend", (2,)), ("semi_global", ()),
                     ("allow_ref_gaps", (["suffix"],)),
                     ("allow_query_gaps", (["prefix"],))],
                    _seqs(9, b"ACGT", 16, 1, 30),
                    _seqs(10, b"ACGT", 16, 1, 30)),
    "sg_plain_scan": ([("matrix", (BLOSUM62,)), ("gap_open", (10,)),
                       ("gap_extend", (1,)), ("semi_global", ()),
                       ("scan", ())],
                      _seqs(11, PROTEIN, 16, 1, 30),
                      _seqs(12, PROTEIN, 16, 1, 30)),
    "sw_pssm": ([("matrix", (PSSM,)), ("gap_open", (5,)),
                 ("gap_extend", (2,)), ("local", ())],
                _seqs(13, b"ACGT", 16, 1, 30), _seqs(14, b"ACGT", 16, 1, 30)),
    "sw_saturating_width8": ([("matrix", (ref.Matrix.create(b"ACGT", 10, -1),)),
                              ("gap_open", (5,)), ("gap_extend", (1,)),
                              ("local", ()), ("solution_width", (8,))],
                             [b"ACGT" * 7, b"AC"], [b"ACGT" * 7, b"AC"]),
}


def _both(cfg, device="cpu"):
    r = _configure(ref.Aligner.new(), cfg).build()
    p = _configure(port.Aligner.new(), cfg).device(device).build()
    return r, p


@pytest.mark.parametrize("forced", [False, True],
                         ids=["reference_default", "reference_pallas"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_align_batch_matches_reference(name, forced, monkeypatch):
    cfg, qs, rs = CASES[name]
    if forced:
        monkeypatch.setenv("PT_FORCE_PALLAS", "1")
    r, p = _both(cfg)
    want = _summary(r.align_batch(qs, rs))
    got = _summary(p.align_batch(qs, rs))
    assert got == want
    assert set(p.route_counter) == {("torch_plain", "batch on the cpu")}


IDENT = ref.Matrix.default()
MOTIF = ref.Matrix.create(b"ACGT", 2, -3)

# The score-class expectations of the reference's own tests
# (tests/test_engine.py, test_golden.py, test_doc_parity.py; from the
# parasail-rs integration tests): builder config, query, reference,
# expected (score, end_query, end_ref), or the score alone.
EXPECTATIONS = {
    **{f"perfect_{m}": ([(s, ())], b"ACGT", b"ACGT", (4, 3, 3))
       for m, s in (("nw", "global_"), ("sg", "semi_global"),
                    ("sw", "local"))},
    **{f"one_mismatch_width{w}": ([("solution_width", (w,))],
                                  b"ACTGACTGACTG", b"ACTGTCTGACTG",
                                  (11, 11, 11))
       for w in (8, 16, 32, 64, "sat")},
    "affine_gap_cost": ([("gap_open", (3,)), ("gap_extend", (1,))],
                        b"AATTTTAA", b"AAAA", -2),
    "local_motif": ([("matrix", (MOTIF,)), ("gap_open", (5,)),
                     ("gap_extend", (2,)), ("local", ())],
                    b"TTTACGTTT", b"GGGACGGGG", (6, 5, 5)),
    "local_clamped_empty": ([("matrix", (MOTIF,)), ("gap_open", (5,)),
                             ("gap_extend", (2,)), ("local", ())],
                            b"AC", b"GT", (0, 0, 0)),
    "sg_contained_query": ([("gap_open", (2,)), ("gap_extend", (1,)),
                            ("semi_global", ())],
                           b"ACGT", b"TTACGTTT", (4, 3, 5)),
    "sg_de_free_overhang": ([("gap_open", (2,)), ("gap_extend", (1,)),
                             ("semi_global", ()),
                             ("allow_ref_gaps", (["suffix"],))],
                            b"ACGTAA", b"ACGT", 4),
    "sg_qe_does_not_help": ([("gap_open", (2,)), ("gap_extend", (1,)),
                             ("semi_global", ()),
                             ("allow_query_gaps", (["suffix"],))],
                            b"ACGTAA", b"ACGT", 1),
    "sg_db_prefix": ([("gap_open", (2,)), ("gap_extend", (1,)),
                      ("semi_global", ()), ("allow_ref_gaps", (["prefix"],))],
                     b"AACGT", b"CGT", 3),
    "wildcard_scores_zero": ([], b"AN", b"AN", 1),
    "pssm": ([("matrix", (ref.Matrix.create(b"ACGT", 2, -1)
                          .to_pssm(b"ACGT"),))], b"ACGT", b"ACGT", 8),
}


@pytest.mark.parametrize("name", sorted(EXPECTATIONS))
def test_reference_expectations_score_class(name):
    cfg, q, r, want = EXPECTATIONS[name]
    res = _configure(port.Aligner.new(), cfg).device("cpu").build().align(q, r)
    got = (res.get_score(), res.get_end_query(), res.get_end_ref())
    assert (got if isinstance(want, tuple) else got[0]) == want
    assert not res.is_saturated()


def test_readme_profile_reuse_score_class():
    # README.md:37-63 of parasail-rs, on the score class
    query, refs = b"ACGT", [b"ACGTAACGTACA", b"TGGCAAGGTAGA"]
    aligner = (port.Aligner.new().profile(port.Profile.new(
        query, False, port_matrix(IDENT))).device("cpu").build())
    for r in refs:
        g = golden.align_seqs(query, r, IDENT, 0, 0, "nw")
        assert aligner.align(None, r).get_score() == g.score


def test_align_single_pair_matches_golden():
    q, r = b"ACTGACTGACTG", b"ACTGTCTGACTG"
    aligner = port.Aligner.new().gap_open(5).gap_extend(2).device("cpu").build()
    res = aligner.align(q, r)
    g = golden.align_seqs(q, r, port.Matrix.default(), 5, 2, "nw")
    assert (res.get_score(), res.get_end_query(), res.get_end_ref()) == \
        (g.score, g.end_query, g.end_ref)
    assert res.is_global() and res.is_striped() and not res.is_saturated()


def test_profile_reuse_matches_reference():
    query = b"HEAGAWGHEEMKVLAT"
    refs = _seqs(21, PROTEIN, 20, 1, 30)
    r_prof = ref.Profile.new(query, False, BLOSUM62)
    p_prof = convert.profile_from_reference(
        query=r_prof.query, matrix=port_matrix(r_prof.matrix),
        rows=r_prof.rows, qidx=r_prof.qidx, use_stats=r_prof.use_stats)
    r = (ref.Aligner.new().profile(r_prof).gap_open(11).gap_extend(1)
         .local().scan().build())
    p = (port.Aligner.new().profile(p_prof).gap_open(11).gap_extend(1)
         .local().scan().device("cpu").build())
    want = _summary(r.align_batch(None, refs))
    got = _summary(p.align_batch(None, refs))
    assert got == want
    # a profile aligner ignores any query passed in, like the reference
    assert _summary(p.align_batch([b"XXXX"] * len(refs), refs)) == want
    assert _summary([p.align(None, refs[0])]) == want[:1]


def test_profile_builder_matches_reference():
    query = b"ACGTTGCA"
    p_prof = port.ProfileBuilder(query, port_matrix(DNA)).build()
    r_prof = ref.ProfileBuilder(query, DNA).build()
    np.testing.assert_array_equal(p_prof.rows, r_prof.rows)
    np.testing.assert_array_equal(p_prof.qidx, r_prof.qidx)


def test_width64_refills_pairs_beyond_int32(monkeypatch):
    # force the int32 risk bound down so the int64 golden merge runs
    monkeypatch.setattr(dispatch, "INT32_SAFE", 10)
    cfg, qs, rs = CASES["sw_blosum62"]
    r, p = _both(cfg + [("solution_width", (64,))])
    assert _summary(p.align_batch(qs, rs)) == _summary(r.align_batch(qs, rs))


@pytest.mark.parametrize("setter", ["use_stats", "use_table",
                                    "use_last_rowcol"])
def test_non_score_builds_raise(setter, monkeypatch):
    # every output class builds and align_many runs it (the name is
    # older than the port of align_many); what raises is a card that is
    # not there
    aligner = getattr(port.Aligner.new().device("cpu"), setter)().build()
    assert aligner.key.outputs == {"use_stats": "stats", "use_table": "table",
                                   "use_last_rowcol": "rowcol"}[setter]
    r = getattr(ref.Aligner.new(), setter)().build()
    got = aligner.align_many([b"AC", b"ACGTT"], [b"AC", b"AGT"])
    want = r.align_many([b"AC", b"ACGTT"], [b"AC", b"AGT"])
    assert _outcome(got) == _outcome(want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(port.Aligner.new(), setter)().build()


def _outcome(results):
    """What the public methods give, comparable across the packages:
    every field of each Alignment (planes as lists), or each SSW result's
    numbers and CIGAR."""
    if not isinstance(results, list):
        results = [results]
    if hasattr(results[0], "score1"):
        return [(s.score1, s.read_begin1, s.read_end1, s.ref_begin1,
                 s.ref_end1, s.cigar_string()) for s in results]
    return [(_summary([a]), {k: np.asarray(a.fields[k]).tolist()
                             for k in a.fields.keys()})
            for a in results]


@pytest.mark.parametrize("method,args", [
    ("align_many", ([b"AC"], [b"AC"])),
    ("banded_nw", (b"AC", b"AC")),
    ("banded_nw_batch", ([b"AC", b"ACGTA"], [b"AC", b"ACT"])),
    ("ssw", (b"AC", b"AC")),
    ("ssw_batch", ([b"AC", b"ACGTA"], [b"AC", b"CGT"])),
])
def test_unported_methods_raise(method, args):
    # every public method is ported now (the name is older than that):
    # none raises, and each equals the reference on the CPU
    aligner = port.Aligner.new().gap_open(3).gap_extend(1).bandwidth(1) \
        .device("cpu").build()
    r = ref.Aligner.new().gap_open(3).gap_extend(1).bandwidth(1).build()
    got = getattr(aligner, method)(*args)
    assert _outcome(got) == _outcome(getattr(r, method)(*args))
    assert set(aligner.route_counter) == {("torch_plain", "batch on the cpu")}


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.Aligner.new().build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.Aligner.new().device("cuda").build()


def test_query_required_without_profile():
    aligner = port.Aligner.new().device("cpu").build()
    with pytest.raises(port.errors.QueryRequired):
        aligner.align(None, b"ACGT")
    assert aligner.align_batch([], []) == []


def test_route_counts_tally_every_batch():
    before = dispatch.ROUTE_COUNTS[("torch_plain", "batch on the cpu")]
    aligner = port.Aligner.new().device("cpu").build()
    aligner.align_batch([b"ACGT"], [b"ACGA"])
    aligner.align(b"AC", b"AC")
    assert dispatch.ROUTE_COUNTS[("torch_plain", "batch on the cpu")] == \
        before + 2
    assert aligner.route_counter == {("torch_plain", "batch on the cpu"): 2}


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_card_route_matches_cpu(name, cuda_device):
    from parasail_rs_tpu_torch.ops import scan_kernel as tk

    cfg, qs, rs = CASES[name]
    cpu = _configure(port.Aligner.new(), cfg).device("cpu").build()
    card = _configure(port.Aligner.new(), cfg).device(cuda_device).build()
    before = tk.SHORT_LAUNCHES["score"]
    got = _summary(card.align_batch(qs, rs))
    assert tk.SHORT_LAUNCHES["score"] == before + 1
    assert got == _summary(cpu.align_batch(qs, rs))
    assert set(card.route_counter) == {("cuda_kernel", "")}
