"""The traffic generators: reproducible by seed, and matching the
statistics their configurations declare."""

from __future__ import annotations

import hashlib

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


# -- the search's ``max_query`` ------------------------------------------------


def _digest(t, calls=5) -> str:
    """The first calls' requests and the warm-up's, byte for byte, and the
    database's planted homologs."""
    h = hashlib.sha256()
    for r in [t.request(c) for c in range(calls)] + t.warmup():
        for x in (b"\0".join(r.refs), np.asarray(r.rlens, np.int64).tobytes(),
                  r.query, np.asarray(r.planted, np.int64).tobytes(),
                  f"{int(r.qlens)} {r.tag}".encode()):
            h.update(x)
    h.update(t.homolog_of.tobytes())
    return h.hexdigest()


# the requests as the generator drew them before it knew ``max_query``:
# the search's configuration at 20,000 entries, and its small size
BEFORE_MAX_QUERY = {
    ("full", 1): "35b8c7f418cc4a0bc55bf8ef1fd81d03e3565250479f2e7253b2fa5a4ee719ea",
    ("full", 7): "cd9a2aee4a8b3131f2573e17a715b919619b2340690d55f46139e11cd9b1c9a2",
    ("small", 1): "6b04547a1e8bbdcbf1bd416b5e4236cf822d08fa925786375f22de8079b52dcb",
    ("small", 7): "f933f441bf41972318972cec205c0a86d91605c8692f25bb9e5225aee3dcecbc",
}


def _search(cell, size):
    if size == "small":
        return _cfg(cell)
    _, _, config, mix = harness.cell_spec(cell)
    return harness.merged(config, {"database": {"entries": 20_000}}), mix


@pytest.mark.parametrize("size,seed", sorted(BEFORE_MAX_QUERY))
def test_search_without_max_query_draws_as_before(size, seed):
    config, mix = _search("swissprot.search", size)
    assert "max_query" not in mix
    t = search.make(config, mix, seed)
    assert _digest(t) == BEFORE_MAX_QUERY[size, seed]


@pytest.mark.parametrize("seed", [1, 7])
def test_search_with_max_query_takes_the_short_queries(seed):
    config, mix = _search("swissprot.search.short", "full")
    cap = mix["max_query"]
    t = search.make(config, mix, seed)
    full = search.make(config, {k: v for k, v in mix.items()
                                if k != "max_query"}, seed)
    assert t.db == full.db and np.array_equal(t.lens, full.lens)
    assert np.array_equal(t.homolog_of, full.homolog_of)
    assert t.queries == full.queries
    short = {qi for qi, q in enumerate(t.queries) if len(q) <= cap}
    assert 0 < len(short) < len(t.queries)
    tags = set()
    for c in range(len(short) * 3):
        r = t.request(c)
        assert len(r.query) == r.qlens <= cap
        assert r.refs == full.request(c).refs
        tags.add(r.tag)
    assert tags == short
    assert [r.tag for r in t.warmup()] == sorted(short)


def test_search_short_is_the_search_but_for_max_query():
    bench = harness.cell_spec("swissprot.search.short")
    base = harness.cell_spec("swissprot.search")
    assert bench[1]["config"] == base[1]["config"]
    assert {k: v for k, v in bench[3].items() if k != "max_query"} == base[3]
    lengths = base[2]["queries"]["lengths"]
    assert [n for n in lengths if n <= bench[3]["max_query"]] == [
        144, 189, 222, 375, 464, 567]
