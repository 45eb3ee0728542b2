"""The plain reference against the port's golden model (imported here,
never by the reference): nw and sw, the nine semi-global free-end sets
and the band; its gap convention against the sources'; its 8-bit
control; and the work counts the roofline takes from a scoring."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest

from benchmark import harness, roofline
from benchmark.reference import matrices, sweep
from benchmark.traffic.request import Request

from .conftest import SMALL

golden = pytest.importorskip("parasail_rs_tpu_torch.golden.model")
pt = pytest.importorskip("parasail_rs_tpu_torch")

DNA04 = {"alphabet": "ACGT", "match": 0, "mismatch": -4}
CASES = [  # mode, matrix, letters drawn, open, extend
    ("sw", "blosum62", b"ARNDCQEGHILKMFPSTWYV", 12, 1),
    ("nw", "blosum62", b"ARNDCQEGHILKMFPSTWYV", 12, 1),
    ("nw", DNA04, b"ACGT", 8, 2),
    ("sw", DNA04, b"AC", 8, 2),          # ties everywhere
    ("nw", "blosum62", b"AR", 12, 1),
    ("sw", {"alphabet": "ACGT", "match": 2, "mismatch": -3}, b"ACGT", 3, 3),
    ("nw", {"alphabet": "ACGT", "match": 1, "mismatch": -1}, b"AG", 2, 1),
]


def _port_matrix(spec):
    if spec == "blosum62":
        return pt.Matrix.from_name("blosum62")
    return pt.Matrix.create(spec["alphabet"], spec["match"], spec["mismatch"])


def _draw(rng, letters, n):
    return rng.choice(np.frombuffer(letters, np.uint8), n).tobytes()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[2][:4]}")
@pytest.mark.parametrize("seed", [1, 2])
def test_reference_equals_golden_with_cigars(case, seed):
    mode, spec, letters, o, e = case
    rng = np.random.default_rng(seed)
    pairs = [(_draw(rng, letters, int(rng.integers(1, 36))),
              _draw(rng, letters, int(rng.integers(1, 36))))
             for _ in range(40)]
    got = sweep.align(pairs, {"mode": mode, "matrix": spec, "gap_open": o,
                              "gap_extend": e}, cigar=True)
    m = _port_matrix(spec)
    for (q, r), g in zip(pairs, got):
        want = golden.align_seqs(q, r, m, o, e, mode)
        cig = golden.walk_trace(want.trace_table, q, r, want.end_query,
                                want.end_ref, mode).cigar_string()
        assert g == (want.score, want.end_query, want.end_ref, cig), (q, r)


def test_score_only_batches_equal_cigar_batches():
    rng = np.random.default_rng(3)
    pairs = [(_draw(rng, b"ACGT", int(rng.integers(5, 80))),
              _draw(rng, b"ACGT", int(rng.integers(5, 80))))
             for _ in range(30)]
    scoring = {"mode": "nw", "matrix": DNA04, "gap_open": 8, "gap_extend": 2}
    a = sweep.align(pairs, scoring, cigar=False)
    b = sweep.align(pairs, scoring, cigar=True)
    assert [x[:3] for x in a] == [x[:3] for x in b]
    assert all(x[3] is None for x in a)


def _source_convention(q, r, sub, G, E, local):
    """Gotoh in the sources' convention: a gap of k costs G + k * E."""
    n, m = len(q), len(r)
    NEG = -10**9
    H = np.full((n + 1, m + 1), NEG, np.int64)
    D = np.full((n + 1, m + 1), NEG, np.int64)
    I = np.full((n + 1, m + 1), NEG, np.int64)
    H[0, 0] = 0
    for j in range(1, m + 1):
        H[0, j] = 0 if local else -(G + j * E)
    for i in range(1, n + 1):
        H[i, 0] = 0 if local else -(G + i * E)
    best = 0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            D[i, j] = max(D[i - 1, j] - E, H[i - 1, j] - G - E)
            I[i, j] = max(I[i, j - 1] - E, H[i, j - 1] - G - E)
            H[i, j] = max(H[i - 1, j - 1] + sub[q[i - 1], r[j - 1]],
                          D[i, j], I[i, j])
            if local:
                H[i, j] = max(H[i, j], 0)
                best = max(best, H[i, j])
    return best if local else int(H[n, m])


@pytest.mark.parametrize("cell", ["swissprot.search", "wfa.10k_e5.cigar"])
def test_gap_mapping_to_the_sources_convention(cell):
    config = harness.cell_spec(cell)[2]
    scoring = config["scoring"]
    G = scoring["gap_open"] - scoring["gap_extend"]
    E = scoring["gap_extend"]
    assert (G, E) == ((11, 1) if cell.startswith("swiss") else (6, 2))
    alphabet, sub = matrices.table(scoring["matrix"])
    lut = matrices.encoder(alphabet)
    letters = (b"ARNDCQEGHILKMFPSTWYV" if cell.startswith("swiss")
               else b"ACGT")
    rng = np.random.default_rng(4)
    pairs = [(_draw(rng, letters, int(rng.integers(2, 30))),
              _draw(rng, letters, int(rng.integers(2, 30))))
             for _ in range(25)]
    got = sweep.align(pairs, scoring, cigar=False)
    for (q, r), g in zip(pairs, got):
        want = _source_convention(lut[np.frombuffer(q, np.uint8)],
                                  lut[np.frombuffer(r, np.uint8)], sub, G, E,
                                  scoring["mode"] == "sw")
        assert g[0] == want


def test_blosum62_is_the_ports_table():
    m = pt.Matrix.from_name("blosum62")
    assert bytes(m.alphabet) == matrices.BLOSUM62_ALPHABET
    assert np.array_equal(np.asarray(m.data), matrices.BLOSUM62)
    assert not m.approximate


def test_the_8bit_control_differs_past_8_bits_and_agrees_below():
    rng = np.random.default_rng(5)
    q = _draw(rng, b"ARNDCQEGHILKMFPSTWYV", 120)
    far = (q, q)                                   # score far past 127
    near = (q[:20], _draw(rng, b"ARNDCQEGHILKMFPSTWYV", 30))
    scoring = {"mode": "sw", "matrix": "blosum62", "gap_open": 12,
               "gap_extend": 1}
    exact = sweep.align([far, near], scoring, cigar=True)
    ctrl = sweep.align([far, near], scoring, cigar=True, saturate8=True)
    assert exact[0][0] > 127 and ctrl[0][0] == 127
    assert ctrl[0] != exact[0]
    assert exact[1][0] < 100 and ctrl[1] == exact[1]


def test_reference_imports_nothing_of_the_port():
    ref_dir = os.path.join(harness.HERE, "reference")
    for f in os.listdir(ref_dir):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, f)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] in ("numpy", "torch", "__future__"), n


# -- semi-global free ends and the band --------------------------------------

SG_NAMES = {"sg": [], "sg_qb": ["qb"], "sg_qe": ["qe"], "sg_qx": ["qb", "qe"],
            "sg_db": ["db"], "sg_de": ["de"], "sg_dx": ["db", "de"],
            "sg_qb_de": ["qb", "de"], "sg_qe_db": ["qe", "db"]}


def _mixed_pairs(seed, letters):
    rng = np.random.default_rng(seed)
    return [(_draw(rng, letters, int(rng.integers(1, 36))),
             _draw(rng, letters, int(rng.integers(1, 36))))
            for _ in range(40)]


@pytest.mark.parametrize("letters", [b"ACGT", b"AC"], ids=["ACGT", "AC"])
@pytest.mark.parametrize("name", list(SG_NAMES))
@pytest.mark.parametrize("seed", [1, 2])
def test_semi_global_reference_equals_golden(name, letters, seed):
    scoring = {"mode": "sg", "matrix": DNA04, "gap_open": 8, "gap_extend": 2,
               "free": SG_NAMES[name]}
    free = sweep.free_ends(scoring)
    assert free == golden.free_flags(
        "sg", [n for f, n in ((free[0], "prefix"), (free[1], "suffix")) if f],
        [n for f, n in ((free[2], "prefix"), (free[3], "suffix")) if f])
    pairs = _mixed_pairs(seed, letters)          # mixed lengths, one batch
    got = sweep.align(pairs, scoring, cigar=True)
    scores = sweep.align(pairs, scoring, cigar=False)
    m = _port_matrix(DNA04)
    for (q, r), g, s in zip(pairs, got, scores):
        want = golden.align_seqs(q, r, m, 8, 2, "sg", free)
        cig = golden.walk_trace(want.trace_table, q, r, want.end_query,
                                want.end_ref, "sg", free).cigar_string()
        assert g == (want.score, want.end_query, want.end_ref, cig), (q, r)
        assert s == g[:3] + (None,)


@pytest.mark.parametrize("free", [["qb", "db"], ["qe", "de"],
                                  ["qb", "qe", "db"], ["qb", "qb"], ["xb"]])
def test_only_parasails_nine_free_sets_are_accepted(free):
    with pytest.raises(ValueError):
        sweep.free_ends({"mode": "sg", "free": free})


def test_free_ends_and_band_belong_to_their_modes():
    assert sweep.free_ends({"mode": "sg"}) == (True,) * 4
    assert sweep.free_ends({"mode": "sg", "free": ["qb", "qe", "db", "de"]}
                           ) == (True,) * 4
    assert sweep.free_ends({"mode": "nw"}) == (False,) * 4
    assert sweep.bandwidth({"mode": "nw", "bandwidth": 0}) == 0
    assert sweep.bandwidth({"mode": "sw"}) is None
    with pytest.raises(ValueError):
        sweep.free_ends({"mode": "nw", "free": []})
    for bad in ({"mode": "sw", "bandwidth": 3}, {"mode": "sg", "bandwidth": 3},
                {"mode": "nw", "bandwidth": -1},
                {"mode": "nw", "bandwidth": 2.5}):
        with pytest.raises(ValueError):
            sweep.bandwidth(bad)


@pytest.mark.parametrize("bw", [0, 1, 3, 40])
@pytest.mark.parametrize("seed", [1, 2])
def test_banded_reference_equals_golden(bw, seed):
    rng = np.random.default_rng(seed + 10)
    near = [(_draw(rng, b"ACGT", n), _draw(rng, b"ACGT", max(1, n + d)))
            for n, d in zip(rng.integers(1, 36, 20), rng.integers(-2, 3, 20))]
    pairs = _mixed_pairs(seed, b"ACGT") + near
    got = sweep.align(pairs, {"mode": "nw", "matrix": DNA04, "gap_open": 8,
                              "gap_extend": 2, "bandwidth": bw}, cigar=False)
    m = _port_matrix(DNA04)
    inside = 0
    for (q, r), g in zip(pairs, got):
        want = golden.banded_nw_fill(
            m.scores_for(m.encode(q), m.encode(r)).astype(np.int64), 8, 2,
            bw)
        assert g[1:] == (len(q) - 1, len(r) - 1, None)
        if abs(len(q) - len(r)) <= bw:             # the corner in the band
            inside += 1
            assert g[0] == want, (q, r)
        else:
            assert g[0] == sweep.NEG == -2**30 and want <= -10**9 // 2
    assert inside > 0


def test_a_band_is_score_only():
    with pytest.raises(ValueError):
        sweep.align([(b"ACGT", b"ACG")], {"mode": "nw", "matrix": DNA04,
                                          "gap_open": 8, "gap_extend": 2,
                                          "bandwidth": 2}, cigar=True)


def _in_band(m, n, bw):
    i, j = np.indices((m, n))
    return int((np.abs(i - j) <= bw).sum())


def test_band_cells_equal_a_brute_force_count():
    rng = np.random.default_rng(6)
    m = rng.integers(1, 60, 300)
    n = rng.integers(1, 60, 300)
    for bw in (0, 1, 2, 7, 30, 59, 200):
        got = roofline.band_cells(m, n, bw)
        assert got.tolist() == [_in_band(a, b, bw) for a, b in zip(m, n)]


def _req(cell):
    _, _, config, mix = harness.cell_spec(cell)
    config = harness.merged(config, SMALL[cell].get("config"))
    mix = harness.merged(mix, SMALL[cell].get("traffic"))
    traffic = harness.load_module("traffic", mix["generator"]).make(
        config, mix, 3)
    return traffic.request(1), config["scoring"], mix


def _plain(cell):
    """Whether the cell's configuration states neither free ends nor a
    band."""
    config = harness.merged(harness.cell_spec(cell)[2],
                            SMALL[cell].get("config"))
    return not {"free", "bandwidth"} & set(config["scoring"])


@pytest.mark.parametrize("cell", [c for c in SMALL if _plain(c)])
def test_nw_and_sw_counts_are_pinned(cell):
    """Plain nw and sw cells' work, counted as before sg and the band."""
    req, scoring, mix = _req(cell)
    cigar = harness.load_module("entries", mix["entry"]).CIGAR
    qlens = np.broadcast_to(np.asarray(req.qlens, np.int64), req.rlens.shape)
    rlens = np.asarray(req.rlens, np.int64)
    ops = float(np.sum(qlens * rlens)) * {"nw": 5, "sw": 6}[scoring["mode"]]
    nbytes = float(rlens.sum()) + (float(req.qlens) if req.queries is None
                                   else float(qlens.sum())) + 12 * len(rlens)
    if cigar and scoring["mode"] == "nw":
        steps = float(np.maximum(qlens, rlens).sum())
        ops, nbytes = ops + steps, nbytes + steps
    assert roofline.cells(req, scoring) == req.cells()
    assert roofline.count(req, scoring, cigar) == (ops, nbytes)


@pytest.mark.parametrize("name", list(SG_NAMES))
def test_semi_global_counts_its_end_search(name):
    req = Request(refs=[b"A" * 10, b"A" * 30], rlens=np.array([10, 30]),
                  qlens=np.array([20, 5]), queries=[b"A" * 20, b"A" * 5])
    scoring = {"mode": "sg", "free": SG_NAMES[name]}
    _, qe, _, de = sweep.free_ends(scoring)
    for cigar in (False, True):           # no traceback steps counted
        ops, nbytes = roofline.count(req, scoring, cigar)
        assert ops == 5 * (200 + 150) + qe * 40 + de * 25
        assert nbytes == 40 + 25 + 24


def test_banded_counts_only_the_band():
    req = Request(refs=[b"A" * 10, b"A" * 30], rlens=np.array([10, 30]),
                  qlens=np.array([20, 5]), queries=[b"A" * 20, b"A" * 5])
    scoring = {"mode": "nw", "bandwidth": 3}
    cells = _in_band(20, 10, 3) + _in_band(5, 30, 3)
    assert roofline.cells(req, scoring) == cells < req.cells()
    assert roofline.count(req, scoring, False)[0] == 5 * cells
