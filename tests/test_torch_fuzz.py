"""Randomized fuzzing of the PyTorch port against golden, and the
differential fuzzer ``tools/fuzz_torch.py``.

The first six tests are ``tests/test_fuzz.py``'s, on the port's plain
versions (``device("cpu")``) and held to the port's golden: penalty
regimes that take different routes in the JAX package (open > ext, open
<= ext, 0/0), every mode, ``align_cigars`` against per-pair ``get_cigar``,
single-letter and empty sides, and CIGAR re-scoring.  The rest check the
fuzzer itself: a short seeded run of both tiers, its table of compiled
kernel forms against the launchers' ``case`` labels in ``csrc/``, its
repro of a planted mismatch through JSON and back, and the port against
the JAX package on a few of its draws.  On the card the ``cuda`` test
runs the fuzzer's cover schedule.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from parasail_rs_tpu_torch.engine import Aligner
from parasail_rs_tpu_torch.golden import model as golden
from parasail_rs_tpu_torch.matrices import Matrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "parasail_rs_tpu_torch", "csrc")
sys.path.insert(0, os.path.join(ROOT, "tools"))

import fuzz_torch  # noqa: E402

MODES = [("global_", "nw"), ("semi_global", "sg"), ("local", "sw")]


def seqs(rng, alpha, n, lo, hi):
    return [rng.choice(alpha, size=rng.integers(lo, hi)).astype("uint8")
            .tobytes() for _ in range(n)]


# -- tests/test_fuzz.py's six, on the port ----------------------------------------

@pytest.mark.parametrize("open_,ext", [(11, 1), (4, 4), (1, 3), (0, 0)])
def test_fuzz_scores_and_stats(open_, ext):
    rng = np.random.default_rng(open_ * 31 + ext)
    m = Matrix.create(b"ACGT", 3, -2)
    qs, rs = [], []
    for _ in range(24):
        qs += seqs(rng, list(b"ACGT"), 1, 1, 50)
        rs += seqs(rng, list(b"ACGT"), 1, 1, 50)
    for setter, mode in MODES:
        builder = (Aligner.new().matrix(m).gap_open(open_).gap_extend(ext)
                   .use_stats().device("cpu"))
        getattr(builder, setter)()
        aligner = builder.build()
        for q, r, res in zip(qs, rs, aligner.align_batch(qs, rs)):
            g = golden.align_seqs(q, r, m, open_, ext, mode)
            assert (res.get_score(), res.get_end_query(), res.get_end_ref(),
                    res.get_matches(), res.get_similar(),
                    res.get_length()) == (g.score, g.end_query, g.end_ref,
                                          g.matches, g.similar, g.length), \
                (mode, open_, ext, q, r)
        assert set(aligner.route_counter) == {("torch_plain",
                                               "batch on the cpu")}


def test_fuzz_cigars_roundtrip():
    # consuming the CIGAR reconstructs the end coordinates exactly
    rng = np.random.default_rng(77)
    m = Matrix.from_name("blosum62")
    aligner = (Aligner.new().matrix(m).gap_open(10).gap_extend(2)
               .semi_global().use_trace().device("cpu").build())
    alpha = list(b"ARNDCQEGHILKMFPSTWYV")
    for _ in range(20):
        q, = seqs(rng, alpha, 1, 2, 40)
        r, = seqs(rng, alpha, 1, 2, 40)
        res = aligner.align(q, r)
        walk = res._walk(q, r)
        qi, ri = walk.beg_query, walk.beg_ref
        for n, op in walk.ops:
            if op in ("=", "X"):
                qi += n
                ri += n
            elif op == "I":
                qi += n
            else:
                ri += n
        assert qi - 1 == res.get_end_query(), (q, r)
        assert ri - 1 == res.get_end_ref(), (q, r)
        g = golden.align_seqs(q, r, m, 10, 2, "sg")
        gw = golden.walk_trace(g.trace_table, q, r, g.end_query, g.end_ref,
                               "sg")
        assert res.get_cigar(q, r) == gw.cigar_string(), (q, r)


def test_single_char_and_empty_edge_cases():
    aligner = (Aligner.new().local().gap_open(1).gap_extend(1).device("cpu")
               .build())
    assert aligner.align(b"A", b"A").get_score() == 1
    res = aligner.align(b"A", b"C")
    assert res.get_score() == 0  # empty local alignment
    assert res.get_end_query() == 0 and res.get_end_ref() == 0
    # an empty side: golden's all-gap border (NW), nothing (SW)
    nw = Aligner.new().gap_open(5).gap_extend(2).device("cpu").build()
    res = nw.align(b"", b"ACGT")
    assert (res.get_score(), res.get_end_query(), res.get_end_ref()) == \
        (-11, -1, 3)
    res = aligner.align(b"", b"ACGT")
    assert (res.get_score(), res.get_end_query(), res.get_end_ref()) == \
        (0, 0, 0)


def test_cigar_score_reconstruction():
    # re-scoring the emitted CIGAR from the matrix and penalties gives the
    # kernel's score: trace flags, CIGARs and scores agree
    rng = np.random.default_rng(97)
    m = Matrix.from_name("blosum62")
    alpha = list(b"ARNDCQEGHILKMFPSTWYV")
    for setter, mode in MODES:
        builder = (Aligner.new().matrix(m).gap_open(10).gap_extend(2)
                   .use_trace().device("cpu"))
        getattr(builder, setter)()
        aligner = builder.build()
        for _ in range(15):
            q, = seqs(rng, alpha, 1, 2, 45)
            r, = seqs(rng, alpha, 1, 2, 45)
            res = aligner.align(q, r)
            walk = res._walk(q, r)
            qi, ri = walk.beg_query, walk.beg_ref
            score = 0
            for n, op in walk.ops:
                if op in ("=", "X"):
                    for _ in range(n):
                        score += int(m.scores_for(
                            m.encode(q[qi:qi + 1]),
                            m.encode(r[ri:ri + 1]))[0, 0])
                        qi += 1
                        ri += 1
                else:
                    score += -(10 + 2 * (n - 1))
                    if op == "I":
                        qi += n
                    else:
                        ri += n
            assert score == res.get_score(), (mode, q, r)


@pytest.mark.parametrize("open_,ext", [(11, 1), (4, 4), (1, 3), (0, 0),
                                       (0, 5), (3, 3)])
def test_fuzz_align_cigars_all_modes(open_, ext):
    """align_cigars (the walk) == per-pair get_cigar on random pairs in
    every mode and penalty regime, single letters included."""
    rng = np.random.default_rng(1000 + open_ * 13 + ext)
    m = Matrix.create(b"ACGT", 3, -2)
    qs = seqs(rng, list(b"ACGT"), 16, 1, 40)
    rs = seqs(rng, list(b"ACGT"), 16, 1, 40)
    for setter, mode in MODES:
        b1 = Aligner.new().matrix(m).gap_open(open_).gap_extend(ext)
        getattr(b1, setter)()
        tr = b1.use_trace().device("cpu").build()
        want = [a.get_cigar(q, r)
                for a, q, r in zip(tr.align_batch(qs, rs), qs, rs)]
        b2 = Aligner.new().matrix(m).gap_open(open_).gap_extend(ext)
        getattr(b2, setter)()
        alns, cigs = b2.device("cpu").build().align_cigars(qs, rs)
        assert cigs == want, (mode, open_, ext)
        for a, q, r in zip(alns, qs, rs):
            assert a.get_score() == golden.align_seqs(q, r, m, open_, ext,
                                                      mode).score


def test_fuzz_stats_walk_route_widths():
    """Stats at open <= ext across widths.  The JAX package takes its
    trace + walk route there; the port's stats sweep serves every penalty
    pair in one pass, and the width changes only the flags."""
    rng = np.random.default_rng(404)
    m = Matrix.create(b"ACGT", 3, -2)
    qs = seqs(rng, list(b"ACGT"), 8, 2, 30)
    rs = seqs(rng, list(b"ACGT"), 8, 2, 30)
    for width in ("sat", 8, 16, 32, 64):
        al = (Aligner.new().matrix(m).gap_open(2).gap_extend(3)
              .solution_width(width).use_stats().local().device("cpu")
              .build())
        for a, q, r in zip(al.align_batch(qs, rs), qs, rs):
            g = golden.align_seqs(q, r, m, 2, 3, "sw")
            assert (a.get_score(), a.get_matches(), a.get_similar(),
                    a.get_length()) == (g.score, g.matches, g.similar,
                                        g.length), (width, q, r)
        assert all(route == "torch_plain" for route, _ in al.route_counter)


# -- the fuzzer -------------------------------------------------------------------

def test_fuzz_run_both_tiers_on_the_cpu():
    res = fuzz_torch.run("cpu", draws=10, seed=5)
    assert res["draws"] == 10 and res["mismatches"] == 0
    assert res["api"] and res["ops"], res["checks"]
    assert res["reached"] and set(res["reached"]) <= set(fuzz_torch.FORMS)


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _labels(src, pattern):
    return sorted({m for m in re.findall(pattern, src)}, key=str)


def test_compiled_forms_are_the_launchers_cases():
    """The fuzzer's table of instantiations is what the sources' launchers
    switch on: rows a lane, lanes, classes, payload layouts, entries."""
    out = {"OUT_SCORE": "score", "OUT_TRACE": "trace", "OUT_STATS": "stats",
           "OUT_TABLE": "table", "OUT_STATS_TABLE": "stats_table",
           "OUT_ROWCOL": "rowcol", "OUT_STATS_ROWCOL": "stats_rowcol"}
    short = _read("scan_short.cuh")
    assert [int(r) for r in re.findall(
        r"launch_form<kOut, (\d+), kBanded>", short)] == \
        list(fuzz_torch.SHORT_ROWS)
    body = short[short.index("switch (out_class)"):]
    body = body[:body.index("#undef PT_STATS")]
    direct = re.findall(r"launch_rows<ptscore::(OUT_\w+), kBanded>", body)
    stats = re.findall(r"PT_STATS\(ptscore::(OUT_\w+)\)", body)
    assert sorted(out[c] for c in direct + stats) == sorted(fuzz_torch.OUTPUTS)
    assert sorted(out[c] for c in stats) == sorted(fuzz_torch.STATS)
    # the stats classes in both payload layouts
    assert "ptscore::pack_ops(Qp, Rp)" in short and \
        "ptscore::pack2_ops(Qp)" in short
    assert "scan_short<false>" in _read("scan_short.cu")
    assert "scan_short<true>" in _read("scan_short_banded.cu")

    ring = _read("scan_banded.cu")
    assert [int(g) for g in re.findall(r"launch_rows<(\d+)>\(a, rows", ring)
            ] == list(fuzz_torch.RING_LANES)
    assert [int(r) for r in re.findall(r"launch_form<G, (\d+)>", ring)] == \
        list(fuzz_torch.RING_ROWS)
    assert re.findall(r"band_kernel<G, kR, (true|false)>", ring) == \
        ["true", "false"] and fuzz_torch.SUBS == ("table", "profile")

    block = _read("segment_block.cuh")
    assert [int(r) for r in re.findall(
        r"launch_form<kOut, kTile, (\d+), kBanded>", block)] == \
        list(fuzz_torch.BLOCK_ROWS)
    cell = _read("score_cell.cuh")
    wide = cell[cell.index("constexpr bool seg_wide_class"):]
    wide = wide[:wide.index("}")]
    assert sorted(out[c] for c in re.findall(r"(OUT_\w+)", wide)) == \
        sorted(fuzz_torch.WIDE)
    entries = {"one-shot": ("scan_chunked.cu", r"PT_CHUNK\(ptscore::(OUT_\w+)\)"),
               "masked": ("scan_chunked_banded.cu",
                          r"PT_BANDED\(ptscore::(OUT_\w+)\)"),
               "segment": ("scan_segment.cu",
                           r"launch<ptscore::(OUT_\w+), false>"),
               "tile": ("scan_rowseg.cu", r"launch<ptscore::(OUT_\w+), true>")}
    for entry, (name, pattern) in entries.items():
        got = sorted(out[c] for c in re.findall(pattern, _read(name)))
        assert got == sorted(fuzz_torch.BLOCK_ENTRIES[entry]), entry
    assert _read("trace_walk.cu").count("<<<") == 1
    # the packed score form: rows a lane, SW or not, the pair table or not
    packed = _read("segment16.cuh")
    assert [int(r) for r in re.findall(r"launch16_form<(\d+), kLocal, kPair>",
                                       packed)] == list(fuzz_torch.PACKED_ROWS)
    assert re.findall(r"launch16_rows<(true|false), (true|false)>",
                      packed) == [("true", "true"), ("false", "true"),
                                  ("true", "false"), ("false", "false")]
    assert fuzz_torch.PACKED_KINDS == ("sw", "nw") and \
        fuzz_torch.PACKED_SUBS == ("pair", "rows")
    assert "ptseg16::launch16(" in _read("scan_segment16.cu")

    forms = fuzz_torch.FORMS
    assert len(forms) == len(set(forms)) == 80 + 24 + 39 + 12 + 1
    assert sum(k.startswith("block packed") for k in forms) == 12
    assert sum(k.startswith("short unbanded") for k in forms) == 40
    assert sum(k.startswith("short masked") for k in forms) == 40


def test_repro_round_trips_a_planted_mismatch(monkeypatch):
    """A mismatch planted in a plain version is reported with its draw,
    survives JSON, and its replay finds it again (and passes once the
    plant is gone)."""
    from parasail_rs_tpu_torch.ops import scan_kernel as tk

    plain = tk.score_align_plain

    def planted(*args, **kw):
        out = plain(*args, **kw)
        out["score"] = out["score"].clone()
        out["score"][-1] += 1
        return out

    monkeypatch.setattr(tk, "score_align_plain", planted)
    with pytest.raises(fuzz_torch.Mismatch) as err:
        # the cover schedule's first draw: check_scalars against golden
        fuzz_torch.run("cpu", draws=1, seed=3, cover=True)
    repro = json.loads(json.dumps(err.value.repro))
    assert repro["seed"] == 3 and repro["kind"] == "api"
    assert repro["settings"]["check"] == "check_scalars"
    assert repro["settings"]["qs"] and repro["settings"]["rs"]
    path, got, want = repro["cell"]
    assert path == ["score"] and got == want + 1
    with pytest.raises(fuzz_torch.Mismatch) as again:
        fuzz_torch.replay(repro, "cpu")
    assert again.value.repro["cell"] == repro["cell"]
    monkeypatch.setattr(tk, "score_align_plain", plain)
    fuzz_torch.replay(repro, "cpu")


def test_port_agrees_with_the_jax_package_on_fuzz_draws():
    """A few of the API tier's draws (no empty side, where the JAX package
    and golden differ; lengths under 32, so that it compiles few
    programs) through the port and the JAX package on the CPU."""
    from parasail_rs_tpu.engine import Aligner as RefAligner
    from parasail_rs_tpu.matrices import Matrix as RefMatrix

    for seed in range(4):
        rng = np.random.default_rng([42, seed])
        spec, alpha = fuzz_torch.rand_matrix(rng)
        setter, mode = fuzz_torch.MODES[rng.integers(0, 3)]
        open_, ext = int(rng.integers(0, 14)), int(rng.integers(0, 8))
        free = fuzz_torch.rand_free(rng) if mode == "sg" else None
        stats = bool(rng.integers(0, 2))
        qs = fuzz_torch.rand_seqs(rng, alpha, 8, 1, 32)
        rs = fuzz_torch.rand_seqs(rng, alpha, 8, 1, 32)
        got = []
        for cls, new in ((Matrix, Aligner.new), (RefMatrix, RefAligner.new)):
            b = (new().matrix(fuzz_torch.make_matrix(spec, cls))
                 .gap_open(open_).gap_extend(ext))
            getattr(b, setter)()
            if free is not None:
                b.allow_query_gaps(free[0]).allow_ref_gaps(free[1])
            if stats:
                b.use_stats()
            if cls is Matrix:
                b.device("cpu")
            got.append([(a.get_score(), a.get_end_query(), a.get_end_ref(),
                         *((a.get_matches(), a.get_similar(), a.get_length())
                           if stats else ()))
                        for a in b.build().align_batch(qs, rs)])
        assert got[0] == got[1], (seed, spec, mode, open_, ext, free)


@pytest.mark.cuda
def test_fuzz_cover_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    res = fuzz_torch.run("cuda", draws=0, seed=32, cover=True)
    assert res["reached"] == list(fuzz_torch.FORMS)
    assert not res["unreached_axes"]
