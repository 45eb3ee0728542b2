"""The traffic generators: reproducible by seed, and matching the
statistics their configurations declare."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness
from benchmark.traffic import pairs, search, sequences

from .conftest import SMALL


def _cfg(cell):
    _, _, config, mix = harness.cell_spec(cell)
    ov = SMALL[cell]
    return (harness.merged(config, ov.get("config")),
            harness.merged(mix, ov.get("traffic")))


SWISS = harness.cell_spec("swissprot.search")[2]


def test_composition_drawn_in_proportion():
    comp = SWISS["sequences"]["composition"]
    letters = sequences.Letters.of(comp)
    idx = letters.draw(np.random.default_rng(1), 2_000_000)
    got = np.bincount(idx, minlength=letters.size) / len(idx)
    want = np.array(list(comp.values())) / sum(comp.values())
    np.testing.assert_allclose(got, want, atol=0.0015)
    assert bytes(letters.alphabet) == "".join(comp).encode()


def test_lengths_mean_and_clip_and_same_multiset_for_every_seed():
    spec = SWISS["sequences"]["length"]
    a = sequences.lengths(spec, 200_000, np.random.default_rng(1))
    b = sequences.lengths(spec, 200_000, np.random.default_rng(2))
    assert abs(a.mean() / spec["mean"] - 1) < 0.02
    assert a.min() >= spec["min"] and a.max() <= spec["max"]
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))


def test_exact_error_count_and_kinds():
    rng = np.random.default_rng(3)
    op = sequences.ops_by_count(rng, 200, 1000, 50).reshape(200, 1000)
    assert ((op != sequences.KEEP).sum(1) == 50).all()
    kinds = np.bincount(op[op != 0], minlength=4)[1:] / op[op != 0].size
    np.testing.assert_allclose(kinds, [1 / 3] * 3, atol=0.02)


def test_apply_ops_lengths_and_substitutions_differ():
    rng = np.random.default_rng(4)
    letters = sequences.Letters.of({"A": 1, "C": 1, "G": 1, "T": 1})
    lens = np.full(50, 400)
    off = sequences.offsets_of(lens)
    src = letters.draw(rng, int(off[-1]))
    op = sequences.ops_by_count(rng, 50, 400, 20)
    out, out_off = sequences.apply_ops(rng, letters, src, off, op)
    o = op.reshape(50, 400)
    want = 400 + (o == sequences.INS).sum(1) - (o == sequences.DEL).sum(1)
    assert np.array_equal(np.diff(out_off), want)
    # with substitutions only, every substituted position changed
    op2 = np.where(op == sequences.SUB, sequences.SUB, sequences.KEEP)
    out2, _ = sequences.apply_ops(rng, letters, src, off, op2.astype(np.uint8))
    sub = op2 == sequences.SUB
    assert (out2[sub] != src[sub]).all() and (out2[~sub] == src[~sub]).all()


def test_homolog_rates_follow_identity_model():
    rng = np.random.default_rng(5)
    p_sub, p_ins, p_del = search.homolog_rates(rng, 100_000,
                                               SWISS["homologs"])
    assert 0.05 - 1e-6 <= p_sub.min() and p_sub.max() <= 0.70 + 1e-6
    assert abs(p_sub.mean() - 0.375) < 0.005
    np.testing.assert_allclose(p_ins + p_del, p_sub * 0.05, rtol=1e-6)


@pytest.mark.parametrize("cell", ["swissprot.search", "wfa.10k_e5.cigar",
                                  "swissprot.hits.cigar", "wfa.1k_e5.single"])
def test_reproducible_by_seed(cell):
    config, mix = _cfg(cell)
    gen = harness.load_module("traffic", mix["generator"])
    a, b, c = (gen.make(config, mix, s) for s in (7, 7, 2**33 + 1))
    for k in range(3):
        ra, rb, rc = a.request(k), b.request(k), c.request(k)
        assert ra.refs == rb.refs and ra.pair(0) == rb.pair(0)
        assert ra.refs != rc.refs
        assert ra.cells() == int(np.sum(np.asarray(
            [len(q) * len(r) for q, r in map(ra.pair, range(ra.n))])))


def test_search_database_plants_its_share_of_homologs():
    config, mix = _cfg("swissprot.search")
    t = search.make(config, mix, 9)
    n = config["database"]["entries"]
    assert (t.homolog_of >= 0).sum() == round(n * config["homologs"]["share"])
    assert [len(q) for q in t.queries] == config["queries"]["lengths"]
    assert len(t.db) == n and all(len(s) == L for s, L in zip(t.db, t.lens))
    seen = set()
    for c in range(len(t.queries) * 3):
        r = t.request(c)
        assert r.n == mix["refs_per_call"]
        for p in r.planted:
            assert t.homolog_of[(c * r.n + p) % n] == r.tag
        seen.add(r.tag)
    assert seen == set(range(len(t.queries)))


def test_wfa_pairs_carry_their_error_count():
    config, mix = _cfg("wfa.10k_e5.cigar")
    t = pairs.make(config, mix, 4)
    L = mix["length"]
    errors = round(config["errors"]["rate"] * L)
    for q, r in zip(t.queries, t.refs):
        assert len(q) == L and set(q) <= set(b"ACGT")
        assert abs(len(r) - L) <= errors
        assert _edit_distance(q, r) <= errors


def _edit_distance(a: bytes, b: bytes) -> int:
    prev = np.arange(len(b) + 1)
    for i, x in enumerate(a, 1):
        cur = np.empty_like(prev)
        cur[0] = i
        sub = prev[:-1] + (np.frombuffer(b, np.uint8) != x)
        cur[1:] = np.minimum(sub, prev[1:] + 1)
        for j in range(1, len(b) + 1):
            cur[j] = min(cur[j], cur[j - 1] + 1)
        prev = cur
    return int(prev[-1])


def test_homolog_pairs_use_the_length_model_and_mutate():
    config, mix = _cfg("swissprot.hits.cigar")
    t = pairs.make(config, mix, 6)
    assert len(t.queries) == mix["pool"]
    assert sum(q != r for q, r in zip(t.queries, t.refs)) > mix["pool"] * 0.9
    assert np.array_equal(t.qlens, [len(q) for q in t.queries])
    assert np.array_equal(t.rlens, [len(r) for r in t.refs])
