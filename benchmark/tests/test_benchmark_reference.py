"""The plain reference against the port's golden model (imported here,
never by the reference), its gap convention against the sources', and
its 8-bit control."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference import matrices, sweep

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
