"""The port's long-pair path on the CPU against the reference.

``dispatch.execute_segments`` (the port of the reference's
``_execute_pallas_streamed``) and the routes that reach it through
``align_batch`` / ``align_many`` are held, on the same byte sequences, to

- the reference's ``_execute_pallas_streamed`` as its own tests call it
  (tests/test_scan_kernel.py: ``PT_STREAM_SEG=128``, ``PT_FORCE_PALLAS=1``,
  Pallas in interpret mode), for score, stats and trace;
- the reference ``Aligner`` on its default route (the wavefront);
- golden, above all the stats class at open <= ext (2/2 and 1/3), which
  the reference refuses to stream and the port's segments serve.

Small sizes: queries 3-60, references 3-500, segments of 64 / 128 (the
port's segment sizes and route thresholds are module constants, patched
here).  Everything is an integer or a string, so every comparison is
exact.  The ``cuda`` tests run the same batches on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_engine_segments.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parasail_rs_tpu as ref  # noqa: E402
from parasail_rs_tpu.golden import model as golden  # noqa: E402

import parasail_rs_tpu_torch as port  # noqa: E402
from parasail_rs_tpu_torch import convert  # noqa: E402
from parasail_rs_tpu_torch.engine import dispatch  # noqa: E402
from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402

from test_torch_engine import (  # noqa: E402
    BLOSUM62,
    PROTEIN,
    PSSM,
    _configure,
    _seqs,
    _summary,
    port_matrix,
)
from test_torch_engine_stats import _views  # noqa: E402

DNA = ref.Matrix.create(b"ACGT", 2, -3)
SETTERS = {"score": [], "stats": [("use_stats", ())],
           "trace": [("use_trace", ())]}
SEG_ROUTE = {"score": ("torch_segments", "long pairs"),
             "stats": ("torch_segments", "long pairs"),
             "trace": ("torch_segments", "trace plane beyond one launch")}


@pytest.fixture
def short_segments(monkeypatch):
    """Segments of 128 columns (trace: 64), and every batch of 64 x 64
    padded cells or more on the segment route."""
    monkeypatch.setattr(dispatch, "SEGMENT_COLS",
                        {"score": 128, "stats": 128, "trace": 64})
    monkeypatch.setattr(dispatch, "SEGMENT_MIN_CELLS", 64 * 64)
    monkeypatch.setattr(dispatch, "TRACE_ONE_SHOT_BYTES", 64 * 64)


def _long_pairs(seed, n=3, qlo=30, qhi=40, rlo=300, rhi=500, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    alpha = list(alphabet)

    def draw(lo, hi):
        return [rng.choice(alpha, size=rng.integers(lo, hi + 1))
                .astype("uint8").tobytes() for _ in range(n)]
    return draw(qlo, qhi), draw(rlo, rhi)


def _port_batch(batch, device="cpu"):
    """The reference's packed batch carried across to the port."""
    return convert.batch_from_reference(
        qlen=batch.qlen, rlen=batch.rlen, profile=batch.profile,
        table=batch.table, qbytes=batch.qbytes, rbytes=batch.rbytes,
        mapper=batch.mapper, device=device,
        qidx=None if batch.qbytes is not None else batch.qidx)


# -- execute_segments against the reference's streamed route ----------------------


@pytest.mark.parametrize("mode,free", [("sw", (True,) * 4),
                                       ("nw", (False,) * 4),
                                       ("sg", (True, False, False, True))],
                         ids=["sw", "nw", "sg_qb_de"])
@pytest.mark.parametrize("outputs", ["score", "stats", "trace"])
def test_execute_segments_matches_reference_stream(outputs, mode, free,
                                                   monkeypatch,
                                                   short_segments):
    from parasail_rs_tpu.engine import dispatch as ref_dispatch

    qs, rs = _long_pairs(61 + len(outputs))
    cfg = [("matrix", (DNA,)), ("gap_open", (4,)), ("gap_extend", (1,)),
           *SETTERS[outputs]]
    r = _configure(ref.Aligner.new(), cfg).build()
    batch, qlens, rlens = r._pack(qs, rs)
    monkeypatch.setenv("PT_STREAM_SEG", "128")
    monkeypatch.setenv("PT_FORCE_PALLAS", "1")
    kw = dict(gap_open=4, gap_extend=1, mode=mode, free=free, width="sat",
              outputs=outputs)
    want = ref_dispatch._execute_pallas_streamed(batch, **kw)
    got = dispatch.execute_segments(_port_batch(batch), **kw)
    assert set(got) == set(want)
    for k in want:
        g = got[k] if isinstance(got[k], np.ndarray) else got[k].numpy()
        w = np.asarray(want[k])
        if k == "trace_table":
            # the reference leaves what it computed in the padded cells
            for b, (ql, rl) in enumerate(zip(qlens, rlens)):
                np.testing.assert_array_equal(g[b, :ql, :rl], w[b, :ql, :rl])
                assert not g[b, ql:].any() and not g[b, :, rl:].any()
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=k)
    for b, (q, s) in enumerate(zip(qs, rs)):
        g = golden.align_seqs(q, s, DNA, 4, 1, mode, free)
        assert int(got["score"][b]) == g.score


@pytest.mark.parametrize("outputs", ["score", "stats", "trace"])
def test_execute_segments_pads_the_last_segment(outputs, monkeypatch):
    # a padded reference length (192) that the segments (128) do not
    # divide: the last segment's padded columns lie beyond every rlen
    monkeypatch.setattr(dispatch, "SEGMENT_COLS",
                        dict.fromkeys(dispatch.SEGMENT_COLS, 128))
    qs, rs = _long_pairs(5, n=4, rlo=130, rhi=190)
    p = _configure(port.Aligner.new(), [
        ("matrix", (DNA,)), ("gap_open", (5,)), ("gap_extend", (2,)),
        ("semi_global", ()), *SETTERS[outputs]]).device("cpu").build()
    batch, _, _ = p._pack(qs, rs)
    assert batch.rp == 192
    kw = dict(gap_open=5, gap_extend=2, mode="sg", free=(True,) * 4,
              width="sat", outputs=outputs)
    got = dispatch.execute_segments(batch, **kw)
    want = dispatch.launch(batch, **kw)
    for k in want:
        g = got[k] if isinstance(got[k], np.ndarray) else got[k].numpy()
        np.testing.assert_array_equal(g, want[k].numpy(), err_msg=k)


# -- the routes, through the public API -----------------------------------------------


@pytest.mark.parametrize("open_,ext", [(4, 1), (2, 2), (1, 3)],
                         ids=["4_1", "2_2", "1_3"])
@pytest.mark.parametrize("outputs", ["score", "stats", "trace"])
@pytest.mark.parametrize("mode", ["global_", "semi_global", "local"])
def test_align_batch_on_segments_matches_reference(mode, outputs, open_, ext,
                                                   short_segments):
    qs, rs = _long_pairs(70 + open_, n=4, qlo=3, qhi=60, rlo=3, rhi=500)
    cfg = [("matrix", (DNA,)), ("gap_open", (open_,)), ("gap_extend", (ext,)),
           (mode, ()), *SETTERS[outputs]]
    r = _configure(ref.Aligner.new(), cfg).build()
    p = _configure(port.Aligner.new(), cfg).device("cpu").build()
    got = p.align_batch(qs, rs)
    assert _views(got) == _views(r.align_batch(qs, rs))
    assert set(p.route_counter) == {SEG_ROUTE[outputs]}
    m = {"global_": "nw", "semi_global": "sg", "local": "sw"}[mode]
    for a, q, s in zip(got, qs, rs):
        g = golden.align_seqs(q, s, DNA, open_, ext, m)
        assert (a.get_score(), a.get_end_query(), a.get_end_ref()) == \
            (g.score, g.end_query, g.end_ref)
        if outputs == "stats":
            assert (a.get_matches(), a.get_similar(), a.get_length()) == \
                (g.matches, g.similar, g.length)
        if outputs == "trace":
            np.testing.assert_array_equal(a.fields["trace_table"],
                                          g.trace_table)
            w = golden.walk_trace(g.trace_table, q, s, g.end_query,
                                  g.end_ref, m)
            assert a.get_cigar(q, s) == w.cigar_string()


@pytest.mark.parametrize("name", ["blosum62_sw", "sg_free_ends", "pssm",
                                  "profile", "profile_stats", "width16",
                                  "width8"])
def test_segment_route_inputs_and_widths(name, short_segments):
    # table, PSSM and profile inputs, the free-end sets and the widths
    q = _seqs(31, PROTEIN, 1, 40, 60)[0]
    qs, rs = _long_pairs(32, n=5, qlo=20, qhi=60, rlo=100, rhi=400,
                         alphabet=PROTEIN)
    cfg = {
        "blosum62_sw": [("matrix", (BLOSUM62,)), ("gap_open", (11,)),
                        ("gap_extend", (1,)), ("local", ())],
        "sg_free_ends": [("matrix", (BLOSUM62,)), ("gap_open", (10,)),
                         ("gap_extend", (1,)), ("semi_global", ()),
                         ("allow_query_gaps", (["prefix"],)),
                         ("allow_ref_gaps", (["suffix"],)),
                         ("use_stats", ())],
        "pssm": [("matrix", (PSSM,)), ("gap_open", (5,)),
                 ("gap_extend", (2,)), ("local", ())],
        "width16": [("matrix", (BLOSUM62,)), ("gap_open", (11,)),
                    ("gap_extend", (1,)), ("local", ()),
                    ("solution_width", (16,))],
        "width8": [("matrix", (ref.Matrix.create(PROTEIN, 10, -1),)),
                   ("gap_open", (5,)), ("gap_extend", (1,)), ("local", ()),
                   ("solution_width", (8,))],
    }.get(name)
    if name == "pssm":
        qs, rs = _long_pairs(33, n=5, qlo=20, qhi=30, rlo=100, rhi=400)
    if name == "width8":
        rs = [s + s for s in qs]               # long matches: saturates
    if cfg is not None:
        r = _configure(ref.Aligner.new(), cfg).build()
        p = _configure(port.Aligner.new(), cfg).device("cpu").build()
    else:
        stats = name == "profile_stats"
        r = (ref.Aligner.new().profile(ref.Profile.new(q, stats, BLOSUM62))
             .gap_open(11).gap_extend(1).local().build())
        p = (port.Aligner.new().profile(port.Profile.new(
            q, stats, port_matrix(BLOSUM62))).gap_open(11).gap_extend(1)
            .local().device("cpu").build())
        qs = None
    got = p.align_batch(qs, rs)
    assert _views(got) == _views(r.align_batch(qs, rs))
    assert {k[0] for k in p.route_counter} == {"torch_segments"}
    if name == "width8":
        assert all(a.is_saturated() for a in got)


def test_width64_merges_over_the_segment_route(monkeypatch, short_segments):
    # pairs over the (lowered) int32 bound are re-filled by golden in int64
    monkeypatch.setattr(dispatch, "INT32_SAFE", 10)
    qs, rs = _long_pairs(41, n=3, qlo=20, qhi=30, rlo=100, rhi=200)
    for setter in SETTERS.values():
        cfg = [("matrix", (DNA,)), ("gap_open", (4,)), ("gap_extend", (1,)),
               ("local", ()), ("solution_width", (64,)), *setter]
        r = _configure(ref.Aligner.new(), cfg).build()
        p = _configure(port.Aligner.new(), cfg).device("cpu").build()
        assert _views(p.align_batch(qs, rs)) == _views(r.align_batch(qs, rs))
        assert {k[0] for k in p.route_counter} == {"torch_segments"}


@pytest.mark.parametrize("outputs", ["score", "stats", "trace"])
def test_align_many_picks_the_route_per_bin(outputs, short_segments,
                                            monkeypatch):
    # short pairs stay on one launch, the bins of long pairs take segments
    monkeypatch.setattr(dispatch, "SEGMENT_MIN_CELLS", 128 * 128)
    monkeypatch.setattr(dispatch, "TRACE_ONE_SHOT_BYTES", 8 * 128 * 128)
    sq, sr = _long_pairs(51, n=8, qlo=5, qhi=30, rlo=5, rhi=30)
    lq, lr = _long_pairs(52, n=8, qlo=100, qhi=128, rlo=300, rhi=500)
    qs, rs = sq + lq, sr + lr
    cfg = [("matrix", (DNA,)), ("gap_open", (5,)), ("gap_extend", (2,)),
           ("semi_global", ()), *SETTERS[outputs]]
    r = _configure(ref.Aligner.new(), cfg).build()
    p = _configure(port.Aligner.new(), cfg).device("cpu").build()
    got = p.align_many(qs, rs)
    assert _views(got) == _views(r.align_many(qs, rs))
    assert _views(got) == _views(p.align_batch(qs, rs))
    routes = {k[0] for k in p.route_counter}
    assert routes == {"torch_plain", "torch_segments"}


def test_align_many_defers_the_fetch_of_segment_bins(short_segments,
                                                     monkeypatch):
    # score bins on the segment route come back as PendingResults: every
    # bin is enqueued before the first fetch
    qs, rs = _long_pairs(53, n=6, qlo=10, qhi=128, rlo=100, rhi=500)
    p = (port.Aligner.new().matrix(port_matrix(DNA)).gap_open(5)
         .gap_extend(2).local().device("cpu").build())
    events = []
    real_submit, real_fetch = dispatch.submit, dispatch.PendingResult.fetch

    def submit(batch, **kw):
        events.append("submit")
        res = real_submit(batch, **kw)
        assert isinstance(res, dispatch.PendingResult)
        return res

    def fetch(self):
        events.append("fetch")
        return real_fetch(self)

    monkeypatch.setattr(dispatch, "submit", submit)
    monkeypatch.setattr(dispatch.PendingResult, "fetch", fetch)
    got = p.align_many(qs, rs)
    n = events.count("submit")
    assert n >= 2 and events == ["submit"] * n + ["fetch"] * n
    assert _summary(got) == _summary(p.align_batch(qs, rs))


# -- plan_route ------------------------------------------------------------------


def _batch_of(B, Qp, Rp):
    z = np.zeros
    return convert.batch_from_reference(
        qlen=z(B, np.int32), rlen=z(B, np.int32), ridx=z((B, Rp), np.int32),
        qidx=z((B, Qp), np.int32), table=z((5, 5), np.int32), device="cpu")


def test_plan_route_rule():
    plain = ("torch_plain", "batch on the cpu")
    chunked = ("torch_chunked", "long pairs, one launch")
    assert dispatch.SEGMENT_MIN_CELLS == 1 << 20
    assert dispatch.CHUNK_ROWS == 2048
    assert dispatch.SEGMENT_COLS == {"score": 8192, "stats": 4096,
                                     "trace": 1024}
    for outputs in ("score", "stats"):
        assert dispatch.plan_route(_batch_of(2, 1024, 1024), outputs, 5, 1) \
            == ("torch_segments", "long pairs")
        assert dispatch.plan_route(_batch_of(2, 768, 1024), outputs, 5, 1) \
            == plain
        # open <= ext changes nothing: the segments carry literal payloads
        assert dispatch.plan_route(_batch_of(2, 1024, 1024), outputs, 1, 3) \
            == ("torch_segments", "long pairs")
        # a caller that needs one launch takes the chunked sweep
        assert dispatch.plan_route(_batch_of(2, 1024, 1024), outputs, 5, 1,
                                   one_shot=True) == chunked
        assert dispatch.plan_route(_batch_of(2, 768, 1024), outputs, 5, 1,
                                   one_shot=True) == plain
    # the trace class streams when its plane's bytes exceed one launch's,
    # and takes the chunked sweep below that when its pairs are long
    assert dispatch.plan_route(_batch_of(2, 1024, 1024), "trace", 5, 1) \
        == chunked
    assert dispatch.plan_route(_batch_of(257, 2048, 2048), "trace", 5, 1) \
        == ("torch_segments", "trace plane beyond one launch")
    assert dispatch.plan_route(_batch_of(256, 2048, 2048), "trace", 5, 1) \
        == chunked
    assert dispatch.plan_route(_batch_of(256, 512, 512), "trace", 5, 1) \
        == plain
    # the classes without a segment form take one launch at any size: of
    # the chunked sweep for long pairs
    for outputs in ("table", "stats_table", "rowcol", "stats_rowcol"):
        assert dispatch.plan_route(_batch_of(2, 2048, 2048), outputs, 5, 1) \
            == chunked
        assert dispatch.plan_route(_batch_of(2, 512, 1024), outputs, 5, 1) \
            == plain
    with pytest.raises(ValueError, match="outputs"):
        dispatch.plan_route(_batch_of(2, 16, 16), "nope", 5, 1)


def test_banded_and_device_planes_stay_on_one_launch(short_segments):
    # 64 x 64 padded cells are long here: the walk's plane comes from one
    # launch of the chunked sweep, the banded batch from K1's route
    qs, rs = _long_pairs(81, n=3, qlo=60, qhi=64, rlo=60, rhi=64)
    m = port_matrix(DNA)
    p = (port.Aligner.new().matrix(m).gap_open(4).gap_extend(1).bandwidth(8)
         .device("cpu").build())
    p.banded_nw_batch(qs, rs)
    p.align_cigars(qs, rs)
    p.ssw_batch(qs, rs)
    assert p.route_counter == {("torch_plain", "batch on the cpu"): 1,
                               ("torch_chunked", "long pairs, one launch"): 2}


def test_trace_plane_beyond_the_host_bound_raises(monkeypatch,
                                                  short_segments):
    monkeypatch.setattr(dispatch, "TRACE_HOST_BYTES", 1000)
    p = (port.Aligner.new().matrix(port_matrix(DNA)).use_trace()
         .device("cpu").build())
    with pytest.raises(ValueError, match="exceeds the 1000 byte bound"):
        p.align_batch(*_long_pairs(82))
    monkeypatch.setattr(dispatch, "TRACE_HOST_BYTES", 4 << 30)
    assert len(p.align_batch(*_long_pairs(82))) == 3
    with pytest.raises(ValueError, match="no segment form"):
        dispatch.execute_segments(
            _batch_of(2, 16, 16), gap_open=1, gap_extend=1, mode="nw",
            free=(False,) * 4, outputs="table", width="32")


def test_segment_route_is_tallied(short_segments):
    key = ("torch_segments", "long pairs")
    before = dispatch.ROUTE_COUNTS[key]
    p = (port.Aligner.new().matrix(port_matrix(DNA)).gap_open(4)
         .gap_extend(1).device("cpu").build())
    p.align_batch(*_long_pairs(83))
    p.align(*[x[0] for x in _long_pairs(84)])
    assert dispatch.ROUTE_COUNTS[key] == before + 2
    assert p.route_counter == {key: 2}


# -- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("open_,ext", [(4, 1), (2, 2), (1, 3)],
                         ids=["4_1", "2_2", "1_3"])
@pytest.mark.parametrize("outputs", ["score", "stats", "trace"])
@pytest.mark.parametrize("mode", ["global_", "semi_global", "local"])
def test_card_segment_route_matches_cpu(mode, outputs, open_, ext,
                                        short_segments, cuda_device):
    qs, rs = _long_pairs(70 + open_, n=40, qlo=3, qhi=100, rlo=3, rhi=500)
    cfg = [("matrix", (DNA,)), ("gap_open", (open_,)), ("gap_extend", (ext,)),
           (mode, ()), *SETTERS[outputs]]
    cpu = _configure(port.Aligner.new(), cfg).device("cpu").build()
    card = _configure(port.Aligner.new(), cfg).device(cuda_device).build()
    # the score class runs on the packed form, the others on the int32 one
    count = "SEGMENT16_LAUNCHES" if outputs == "score" else "SEGMENT_LAUNCHES"
    before = getattr(tk, count)
    got = card.align_batch(qs, rs)
    assert getattr(tk, count) > before
    assert _views(got) == _views(cpu.align_batch(qs, rs))
    assert {k[0] for k in card.route_counter} == {"cuda_segments"}
    assert _views(card.align_many(qs, rs)) == _views(got)


@pytest.mark.cuda
def test_card_segment_route_profile_and_widths(short_segments, cuda_device):
    q = _seqs(31, PROTEIN, 1, 40, 60)[0]
    _, rs = _long_pairs(32, n=40, rlo=100, rhi=400, alphabet=PROTEIN)
    m = port_matrix(BLOSUM62)
    for stats in (False, True):
        for width in ("sat", 8, 64):
            got = [port.Aligner.new().profile(port.Profile.new(q, stats, m))
                   .gap_open(11).gap_extend(1).local().solution_width(width)
                   .device(d).build().align_batch(None, rs)
                   for d in (cuda_device, "cpu")]
            assert _views(got[0]) == _views(got[1])
