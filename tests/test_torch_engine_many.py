"""The port's ``align_many`` on the CPU against its ``align_batch`` and
the reference's ``align_many``.

Mixed-length pairs go through ``parasail_rs_tpu_torch`` (``device="cpu"``)
and ``parasail_rs_tpu`` (its default route, the XLA wavefront here), for
every output class, width 64 with its int64 re-fill, profile mode and a
small ``max_cells`` that splits the work into many bins.  Every result
must equal the port's unbinned ``align_batch`` and the reference's
``align_many`` in input order, every bin's pending result must be fetched
exactly once, and the route must be the plain one.  The cases are those
of tests/test_scheduler.py:45-63 and :101-124.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parasail_rs_tpu as ref  # noqa: E402
from parasail_rs_tpu.batch import merge_bins, plan_bins  # noqa: E402

import parasail_rs_tpu_torch as port  # noqa: E402
from parasail_rs_tpu_torch import convert  # noqa: E402
from parasail_rs_tpu_torch.engine import dispatch  # noqa: E402

from test_torch_engine import (  # noqa: E402
    BLOSUM62,
    PROTEIN,
    _configure,
    _seqs,
    port_matrix,
)
from test_torch_engine_stats import CPU_ROUTE, SETTERS, _views  # noqa: E402

DNA = ref.Matrix.create(b"ACGT", 2, -3)
CLASSES = {"score": [], **SETTERS, "trace": [("use_trace", ())]}


def _all_views(alignments):
    """_views plus the trace plane of the trace class."""
    return [v + ([a.fields["trace_table"].tolist()] if a.is_trace() else [])
            for v, a in zip(_views(alignments), alignments)]


def _mixed(seed, n=24):
    """Pairs whose lengths fall into several shape buckets."""
    qs = _seqs(seed, PROTEIN, n, 1, 70)
    rs = _seqs(seed + 1, PROTEIN, n, 1, 120)
    return qs, rs


def _bins(qs, rs, outputs, max_cells):
    cell_sized = outputs in ("trace", "table", "stats_table")
    return merge_bins(plan_bins([len(q) for q in qs], [len(r) for r in rs],
                                max_cells=max_cells,
                                lane_quantum=1 if cell_sized else 128),
                      max_launches=16 if cell_sized else 8,
                      max_cells=max_cells)


@pytest.mark.parametrize("outputs", sorted(CLASSES))
def test_align_many_matches_align_batch_and_reference(outputs):
    qs, rs = _mixed(len(outputs))
    cfg = ([("matrix", (BLOSUM62,)), ("gap_open", (11,)), ("gap_extend", (1,)),
            ("local" if len(outputs) % 2 else "semi_global", ())]
           + CLASSES[outputs])
    p = _configure(port.Aligner.new(), cfg).device("cpu").build()
    r = _configure(ref.Aligner.new(), cfg).build()
    assert p.key.outputs == outputs
    max_cells = 1 << 16
    assert len(_bins(qs, rs, outputs, max_cells)) > 2
    got = _all_views(p.align_many(qs, rs, max_cells=max_cells))
    assert got == _all_views(p.align_batch(qs, rs))
    assert got == _all_views(r.align_many(qs, rs, max_cells=max_cells))
    assert set(p.route_counter) == CPU_ROUTE


def test_align_many_matches_align():
    # tests/test_scheduler.py:45-63
    rng = np.random.default_rng(9)
    qs, rs = [], []
    for _ in range(17):
        qs.append(rng.choice(list(b"ACGT"), size=rng.integers(3, 120))
                  .astype("uint8").tobytes())
        rs.append(rng.choice(list(b"ACGT"), size=rng.integers(3, 120))
                  .astype("uint8").tobytes())
    cfg = [("matrix", (DNA,)), ("gap_open", (4,)), ("gap_extend", (1,)),
           ("local", ()), ("use_stats", ())]
    p = _configure(port.Aligner.new(), cfg).device("cpu").build()
    many = p.align_many(qs, rs)
    assert _views(many) == _views([p.align(q, r) for q, r in zip(qs, rs)])
    r = _configure(ref.Aligner.new(), cfg).build()
    assert _views(many) == _views(r.align_many(qs, rs))


@pytest.mark.parametrize("max_cells", [None, 1 << 14])
def test_align_many_profile_mode(max_cells):
    # tests/test_scheduler.py:101-124: one profile against many references
    rng = np.random.default_rng(23)
    aa = list(PROTEIN)
    q = rng.choice(aa, size=48).astype("uint8").tobytes()
    refs = [rng.choice(aa, size=rng.integers(20, 400)).astype("uint8")
            .tobytes() for _ in range(40)]
    r_prof = ref.Profile.new(q, False, BLOSUM62)
    p_prof = convert.profile_from_reference(
        query=r_prof.query, matrix=port_matrix(r_prof.matrix),
        rows=r_prof.rows, qidx=r_prof.qidx, use_stats=r_prof.use_stats)
    r = (ref.Aligner.new().profile(r_prof).gap_open(11).gap_extend(1)
         .local().scan().build())
    p = (port.Aligner.new().profile(p_prof).gap_open(11).gap_extend(1)
         .local().scan().device("cpu").build())
    many = p.align_many(None, refs, max_cells=max_cells)
    assert _views(many) == _views(r.align_many(None, refs,
                                               max_cells=max_cells))
    assert _views(many) == _views(p.align_batch(None, refs))
    # a profile aligner ignores any query passed in, like the reference
    assert _views(p.align_many([b"XX"] * len(refs), refs,
                               max_cells=max_cells)) == _views(many)


@pytest.mark.parametrize("outputs", ["score", "stats_rowcol"])
def test_align_many_width64_refills_pairs_beyond_int32(outputs,
                                                       monkeypatch):
    # force the int32 risk bound down so bins take the int64 golden merge
    from parasail_rs_tpu.engine import dispatch as ref_dispatch

    monkeypatch.setattr(dispatch, "INT32_SAFE", 10)
    monkeypatch.setattr(ref_dispatch, "INT32_SAFE", 10)
    qs, rs = _mixed(5, 12)
    cfg = ([("matrix", (BLOSUM62,)), ("gap_open", (11,)), ("gap_extend", (1,)),
            ("local", ()), ("solution_width", (64,))] + CLASSES[outputs])
    p = _configure(port.Aligner.new(), cfg).device("cpu").build()
    r = _configure(ref.Aligner.new(), cfg).build()
    got = p.align_many(qs, rs, max_cells=1 << 16)
    assert all(np.asarray(a.fields["score"]).dtype == np.int64 for a in got)
    assert _views(got) == _views(r.align_many(qs, rs, max_cells=1 << 16))


def test_align_many_fetches_every_bin_once(monkeypatch):
    fetched: list = []
    made: list = []

    class Counted(dispatch.PendingResult):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

        def fetch(self):
            fetched.append(self)
            return super().fetch()

    monkeypatch.setattr(dispatch, "PendingResult", Counted)
    qs, rs = _mixed(17, 40)
    p = (port.Aligner.new().matrix(port_matrix(BLOSUM62)).gap_open(11)
         .gap_extend(1).local().device("cpu").build())
    got = p.align_many(qs, rs, max_cells=1 << 14)
    nbins = len(_bins(qs, rs, "score", 1 << 14))
    assert nbins > 2 and len(made) == nbins
    assert sorted(map(id, fetched)) == sorted(map(id, made))
    assert [a.get_score() for a in got] == \
        [a.get_score() for a in p.align_batch(qs, rs)]
    # a pending result gives its block once
    pend = dispatch.PendingResult({"score": torch.arange(3)})
    assert pend.fetch()[0]["score"].tolist() == [0, 1, 2]
    with pytest.raises(RuntimeError, match="fetched already"):
        pend.fetch()


@pytest.mark.parametrize("outputs,width", [
    ("score", "sat"), ("stats_table", "sat"), ("stats", "64")],
    ids=["scalar", "plane", "width64_merge"])
def test_execute_is_submit_fetched(outputs, width, monkeypatch):
    if width == "64":
        monkeypatch.setattr(dispatch, "INT32_SAFE", 10)   # every pair
    qs, rs = _mixed(19, 12)
    p = port.Aligner.new().matrix(port_matrix(BLOSUM62)).device("cpu").build()
    batch, _, _ = p._pack(qs, rs)
    kw = dict(gap_open=11, gap_extend=1, mode="sw", free=(True,) * 4,
              outputs=outputs, width=width)
    want = dispatch.execute(batch, **kw)
    pend = dispatch.submit(batch, **kw)
    got, rows = pend.fetch()
    assert rows is None and sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    if width == "64":
        assert want["score"].dtype == np.int64
    with pytest.raises(RuntimeError, match="fetched already"):
        pend.fetch()


def test_align_many_edge_cases():
    p = port.Aligner.new().device("cpu").build()
    assert p.align_many([], []) == []
    with pytest.raises(port.errors.QueryRequired):
        p.align_many(None, [b"ACGT"])
    got = p.align_many([b"ACGT", b"A"], [b"ACGA", b"AAAA"])
    assert [a.get_score() for a in got] == \
        [a.get_score() for a in p.align_batch([b"ACGT", b"A"],
                                              [b"ACGA", b"AAAA"])]


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", sorted(CLASSES))
def test_align_many_on_card_matches_cpu(outputs, cuda_device):
    qs, rs = _mixed(len(outputs), 60)
    cfg = ([("matrix", (BLOSUM62,)), ("gap_open", (11,)), ("gap_extend", (1,)),
            ("local", ())] + CLASSES[outputs])
    card = _configure(port.Aligner.new(), cfg).device(cuda_device).build()
    cpu = _configure(port.Aligner.new(), cfg).device("cpu").build()
    got = _all_views(card.align_many(qs, rs, max_cells=1 << 16))
    assert got == _all_views(cpu.align_many(qs, rs, max_cells=1 << 16))
    assert set(card.route_counter) == {("cuda_kernel", "")}
