"""The cell cap of trace bins whose plane stays on the card.

``align_cigars`` and ``ssw_batch``'s windowed pass walk their trace
planes on the device and fetch only opcodes, so on a card a launch holds
up to a quarter of the card's total memory of plane, a byte a cell
(``engine.binning._plane_cells``); everything else plans as the
reference does (``parasail_rs_tpu.batch``: 2^28 cells a launch for the
cell-sized classes, 2^33 in groups of 128 for the rest).  The CPU tests
stub the card's total memory and stop each call at its plan; the card
test aligns 16 pairs of 10 kbp in one bin whose plane passes 2^31 bytes.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parasail_rs_tpu_torch as port  # noqa: E402
from parasail_rs_tpu_torch.batch import Bin  # noqa: E402
from parasail_rs_tpu_torch.engine import binning, dispatch  # noqa: E402
from parasail_rs_tpu_torch.utils.shapes import length_bucket  # noqa: E402

CARD = torch.device("cuda")
GIB = 1 << 30
L10K = 10_000


def _stub_card(monkeypatch, total_memory):
    """A card of ``total_memory`` bytes, seen only by its properties."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: SimpleNamespace(
                            total_memory=total_memory))


def _sizes(bins):
    return sorted(len(b.indices) for b in bins)


def _covers(bins, n):
    return sorted(i for b in bins for i in b.indices) == list(range(n))


# -- the rule ----------------------------------------------------------------


def test_80gb_card_plans_64_pairs_of_10kbp_in_one_bin(monkeypatch):
    _stub_card(monkeypatch, 80 * GIB)
    bins = binning._shape_bins([L10K] * 64, [L10K] * 64, True,
                               plane_on=CARD)
    assert len(bins) == 1 and _covers(bins, 64)
    assert (bins[0].qp, bins[0].rp) == (length_bucket(L10K),) * 2
    assert binning._plane_cells(CARD) == 20 * GIB


def test_4gb_card_plans_bins_of_at_most_7_pairs(monkeypatch):
    _stub_card(monkeypatch, 4 * GIB)
    bins = binning._shape_bins([L10K] * 64, [L10K] * 64, True,
                               plane_on=CARD)
    assert _covers(bins, 64)
    assert max(_sizes(bins)) == 7 and len(bins) == 10


def test_small_card_keeps_the_reference_floor(monkeypatch):
    _stub_card(monkeypatch, GIB)                # a quarter is 2^28 / 1
    assert binning._plane_cells(CARD) == 1 << 28
    _stub_card(monkeypatch, 256 << 20)
    assert binning._plane_cells(CARD) == 1 << 28


@pytest.mark.parametrize("plane_on", [torch.device("cpu"), None],
                         ids=["cpu", "host_plane"])
def test_cpu_and_host_planes_plan_the_reference_bins(plane_on, monkeypatch):
    from parasail_rs_tpu.batch import merge_bins, plan_bins

    _stub_card(monkeypatch, 80 * GIB)           # present, and not asked
    bins = binning._shape_bins([L10K] * 64, [L10K] * 64, True,
                               plane_on=plane_on)
    assert _sizes(bins) == [1] * 64 and _covers(bins, 64)
    want = merge_bins(plan_bins([L10K] * 64, [L10K] * 64, max_cells=1 << 28),
                      max_launches=16, max_cells=1 << 28)
    assert [(b.qp, b.rp, b.indices) for b in bins] == \
        [(b.qp, b.rp, b.indices) for b in want]


# -- the callers -------------------------------------------------------------


class _Planned(Exception):
    pass


def _plan_of(monkeypatch, call):
    """The bins ``call`` plans (the real ``_shape_bins`` on the arguments
    it was given), stopping it before anything is packed."""
    seen = []
    real = binning._shape_bins

    def record(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        raise _Planned

    monkeypatch.setattr(binning, "_shape_bins", record)
    with pytest.raises(_Planned):
        call()
    return seen[0]


def _on_card(cfg):
    """An aligner built for the CPU, then pointed at the card: its plan
    is made before anything reaches a device."""
    b = port.Aligner.new().gap_open(8).gap_extend(2)
    for name, args in cfg:
        b = getattr(b, name)(*args)
    al = b.device("cpu").build()
    al.device = CARD
    return al


def _mixed_10k(n=64):
    """Pairs around 10 kbp and eight short ones: two shape buckets."""
    rng = np.random.default_rng(5)
    lens = [L10K + int(d) for d in rng.integers(-500, 500, n - 8)] + \
        [int(x) for x in rng.integers(300, 380, 8)]
    return [b"A" * n_ for n_ in lens], [b"C" * n_ for n_ in lens]


def _reference_plan(qs, rs, cell_sized):
    from parasail_rs_tpu.batch import merge_bins, plan_bins

    cap = (1 << 28) if cell_sized else (1 << 33)
    return merge_bins(plan_bins([len(q) for q in qs], [len(r) for r in rs],
                                max_cells=cap,
                                lane_quantum=1 if cell_sized else 128),
                      max_launches=16 if cell_sized else 8, max_cells=cap)


REFERENCE_CAP = {
    "align_many.trace": ([("use_trace", ())], "align_many", True),
    "align_many.table": ([("use_table", ())], "align_many", True),
    "align_many.stats_table": ([("use_stats", ()), ("use_table", ())],
                               "align_many", True),
    "align_many.score": ([], "align_many", False),
    "align_many.stats": ([("use_stats", ())], "align_many", False),
    "align_many.rowcol": ([("use_last_rowcol", ())], "align_many", False),
    "align_many.stats_rowcol": ([("use_last_rowcol", ()), ("use_stats", ())],
                                "align_many", False),
    "align_cigars.width64": ([("solution_width", (64,))], "align_cigars",
                             True),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CAP))
def test_classes_and_widths_off_the_card_walk_plan_as_the_reference(
        case, monkeypatch):
    cfg, method, cell_sized = REFERENCE_CAP[case]
    _stub_card(monkeypatch, 80 * GIB)
    qs, rs = _mixed_10k()
    al = _on_card(cfg)
    got = _plan_of(monkeypatch, lambda: getattr(al, method)(qs, rs))
    want = _reference_plan(qs, rs, cell_sized)
    assert [(b.qp, b.rp, b.indices) for b in got] == \
        [(b.qp, b.rp, b.indices) for b in want]
    assert len(got) > 1


@pytest.mark.parametrize("width", [None, 8, 16, 32])
def test_align_cigars_on_a_card_plans_by_its_memory(width, monkeypatch):
    _stub_card(monkeypatch, 80 * GIB)
    qs, rs = _mixed_10k()
    al = _on_card([] if width is None else [("solution_width", (width,))])
    got = _plan_of(monkeypatch, lambda: al.align_cigars(qs, rs))
    assert _covers(got, len(qs))
    # every 10 kbp pair in one bin, the short ones in their own
    assert _sizes(got) == [8, 56]
    assert len(_reference_plan(qs, rs, True)) > len(got)


def test_ssw_windows_plan_where_their_walk_runs(monkeypatch):
    seen = []
    real = binning._shape_bins

    def record(*args, **kwargs):
        if args[2]:
            seen.append(kwargs.get("plane_on"))
        return real(*args, **kwargs)

    monkeypatch.setattr(binning, "_shape_bins", record)
    al = (port.Aligner.new().gap_open(5).gap_extend(2).device("cpu")
          .build())
    qs = [b"ACGTTGCAACGT", b"TTTTACGTAC"]
    rs = [b"GGACGTTGCAACGTGG", b"ACGTACAAAA"]
    want = al.ssw_batch(qs, rs, windowed=False)
    got = al.ssw_batch(qs, rs, windowed=True)
    assert seen == [torch.device("cpu")]
    assert [(g.score1, g.ref_end1, g.read_end1) for g in got] == \
        [(w.score1, w.ref_end1, w.read_end1) for w in want]


# -- exactness over plans ----------------------------------------------------


def _one_bin(qlens, rlens, *args, **kwargs):
    qp = max(length_bucket(int(x)) for x in qlens)
    rp = max(length_bucket(int(x)) for x in rlens)
    return [Bin(qp=qp, rp=rp, indices=list(range(len(qlens))))]


PLANS = {
    "reference": None,
    "one_bin": lambda mp: mp.setattr(binning, "_shape_bins", _one_bin),
    "one_pair_a_bin": lambda mp: mp.setattr(binning, "_plane_cells",
                                            lambda device: 1),
}


@pytest.mark.parametrize("mode", ["nw", "semi_global", "local"])
def test_align_cigars_is_identical_under_every_plan(mode, monkeypatch):
    rng = np.random.default_rng(11)
    lens = [int(x) for x in rng.integers(1, 300, 20)]
    qs = [bytes(rng.choice(list(b"ACGT"), n_).tolist()) for n_ in lens]
    rs = [bytes(rng.choice(list(b"ACGT"), n_).tolist())
          for n_ in rng.integers(1, 300, 20)]
    b = port.Aligner.new().gap_open(8).gap_extend(2).device("cpu")
    if mode != "nw":
        b = getattr(b, mode)()
    al = b.build()
    seen = []
    real_submit = dispatch.submit

    def submit(batch, **kw):
        seen.append(batch.size)
        return real_submit(batch, **kw)

    monkeypatch.setattr(dispatch, "submit", submit)
    out = {}
    for name, setup in PLANS.items():
        with monkeypatch.context() as mp:
            if setup is not None:
                setup(mp)
            seen.clear()
            alns, cigs = al.align_cigars(qs, rs)
            out[name] = ([(a.get_score(), a.get_end_query(), a.get_end_ref())
                          for a in alns], cigs, len(seen))
    assert out["one_bin"][2] == 1 and out["one_pair_a_bin"][2] == len(qs)
    assert 1 < out["reference"][2] < len(qs)
    for name in ("one_bin", "one_pair_a_bin"):
        assert out[name][:2] == out["reference"][:2]


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _wfa_pairs(n, length, rate, seed):
    """WFA's pair sets: random ACGT and a partner with exactly
    ``rate * length`` errors (mismatch, insertion or deletion alike) at
    distinct positions."""
    bases = b"ACGT"
    rng = np.random.default_rng(seed)
    qs, rs = [], []
    for _ in range(n):
        q = bytes(rng.choice(list(bases), length).tolist())
        at = set(rng.choice(length, int(rate * length), replace=False)
                 .tolist())
        r = bytearray()
        for i, c in enumerate(q):
            if i not in at:
                r.append(c)
                continue
            kind = int(rng.integers(3))
            if kind == 0:       # a mismatch: another base
                r.append(bases[(bases.index(c) + int(rng.integers(1, 4))) % 4])
            elif kind == 1:     # an insertion before the base
                r += bytes([bases[int(rng.integers(4))], c])
            # kind 2: a deletion
        qs.append(q)
        rs.append(bytes(r))
    return qs, rs


@pytest.mark.cuda
def test_card_one_bin_past_2_31_bytes_matches_one_pair_bins(
        cuda_device, monkeypatch):
    qs, rs = _wfa_pairs(16, L10K, 0.05, 19)
    Qp = length_bucket(max(len(q) for q in qs))
    Rp = length_bucket(max(len(r) for r in rs))
    assert 16 * Qp * Rp > 1 << 31           # the plane's far pairs
    al = (port.Aligner.new().matrix(port.Matrix.create(b"ACGT", 0, -4))
          .gap_open(8).gap_extend(2).device(cuda_device).build())
    real = binning._shape_bins
    plans = []

    def record(*args, **kwargs):
        plans.append(real(*args, **kwargs))
        return plans[-1]

    monkeypatch.setattr(binning, "_shape_bins", record)
    al.align_cigars(qs[:1], rs[:1])             # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alns, cigs = al.align_cigars(qs, rs)
    one_bin_s = time.perf_counter() - t0
    assert _sizes(plans[-1]) == [16]
    with monkeypatch.context() as mp:
        mp.setattr(binning, "_plane_cells", lambda device: 1 << 28)
        t0 = time.perf_counter()
        ref_alns, ref_cigs = al.align_cigars(qs, rs)
        ref_s = time.perf_counter() - t0
    assert _sizes(plans[-1]) == [1] * 16
    print(f"16 x 10 kbp align_cigars: one bin {one_bin_s * 1e3:.1f} ms, "
          f"16 one-pair bins {ref_s * 1e3:.1f} ms")

    def view(a):
        return (a.get_score(), a.get_end_query(), a.get_end_ref())

    assert [view(a) for a in alns] == [view(a) for a in ref_alns]
    assert cigs == ref_cigs
    tr = (port.Aligner.new().matrix(port.Matrix.create(b"ACGT", 0, -4))
          .gap_open(8).gap_extend(2).use_trace().device(cuda_device).build())
    last = tr.align(qs[-1], rs[-1])
    assert view(last) == view(alns[-1])
    assert last.get_cigar(qs[-1], rs[-1]) == cigs[-1]
