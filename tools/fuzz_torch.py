#!/usr/bin/env python
"""Differential fuzzer of the PyTorch port: the public API against golden
and the plain versions, and every kernel form the build compiles against
its plain version.

    python tools/fuzz_torch.py [minutes] [--cpu] [--seed N] [--cover]
    python tools/fuzz_torch.py --replay repro.json [--cpu]

The port's counterpart of ``tools/fuzz_session.py`` (the JAX package's
fuzzer, which stays as it is).  It imports only the port.  Two tiers, every
draw seeded from ``--seed``:

- API tier: the nine checks of ``fuzz_session.py`` on the same kinds of
  draws (alphabets and matrices, a PSSM among them; NW, the nine SG
  free-end sets and SW; open > ext, open == ext, open < ext and 0/0;
  widths sat / 8 / 16 / 32 / 64; empty and one-letter sides; case-mixed
  bytes; a random ``_CIGAR_CHUNK``, so that tail chunks run), each result
  held bit for bit to the port's ``golden`` and, on the card, to the same
  call on an aligner built with ``device("cpu")`` (the plain versions).
  Every batch's route must be ``cuda_*`` on the card, ``torch_*`` on the
  CPU: the port has no fallback, and the route is how a check sees that.
- Ops tier: shapes drawn so that each launcher picks each form it compiles
  (:data:`FORMS`), through ``score_align``, ``score_chunked`` (by
  ``dispatch.launch`` with ``CHUNK_ROWS`` patched), ``score_segment``
  chained (by ``dispatch.execute`` on the segment route, its constants
  patched: the score class on the packed form wherever it has a band,
  its flagged pairs on the int32 form at fetch; the int32 score form
  itself by a profile a pair, which the packed form does not take) and
  ``score_rowseg`` (by ``dist.seqpar_align_scan`` on virtual shards), and
  the walk on every trace plane.  Every scalar, flag cell and
  plane cell is held to the plain version on the same tensors, a sample of
  pairs to golden.  What a draw reached is read from the launchers' own
  rules for the shapes it launched (``scan_kernel.short_plan`` /
  ``band_plan`` / ``block_plan`` on the card; on the CPU the same rules
  built with g++ from ``csrc/score_host.cc``) and, on the card, confirmed
  by the wrappers' launch counters.

``--cover`` (``run(..., cover=True)``) runs a stratified schedule: each API
check once, one draw aimed at each compiled form and each plan axis
(:data:`AXES`: the short form's substitution, the block kernel's warps and
clusters, the walk's two copy paths), then random draws up to the budget.
It fails if anything stays unreached.

The oracles are golden and the plain versions, never the JAX package:
where that package disagrees with golden (ROADMAP.md, Queue 3) the port
keeps golden's answer.  At the first mismatch :func:`run` raises
:class:`Mismatch` with a repro (the draw's seed, its settings and
sequences, the first differing cell); the CLI prints it and exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import glob
import hashlib
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from parasail_rs_tpu_torch.dist import (make_device_mesh,  # noqa: E402
                                        seqpar_align_scan)
from parasail_rs_tpu_torch.engine import (Aligner, Profile,  # noqa: E402
                                          StreamingAligner)
from parasail_rs_tpu_torch.engine import aligner as aligner_mod  # noqa: E402
from parasail_rs_tpu_torch.engine import dispatch  # noqa: E402
from parasail_rs_tpu_torch.engine.aligner import resolve_device  # noqa: E402
from parasail_rs_tpu_torch.golden import model as golden  # noqa: E402
from parasail_rs_tpu_torch.matrices import Matrix  # noqa: E402
from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402
from parasail_rs_tpu_torch.ops import trace_walk as tw  # noqa: E402

NEG = -(1 << 30)

# -- what the sources compile ---------------------------------------------------
# Each tuple is a launcher's switch cases; tests/test_torch_fuzz.py holds
# them to the sources.
OUTPUTS = tk.OUTPUTS
STATS = ("stats", "stats_table", "stats_rowcol")
SHORT_ROWS = (4, 5, 6, 8)        # scan_short.cuh, launch_rows
SHORT_LAYOUTS = (1, 2)           # scan_short.cuh, PT_STATS: pack_ops, pack2_ops
RING_LANES = (8, 16, 32)         # scan_banded.cu, pt_scan_band_ring
RING_ROWS = (4, 5, 6, 8)         # scan_banded.cu, launch_rows
SUBS = ("table", "profile")      # scan_banded.cu, band_kernel<G, kR, profile>
BLOCK_ROWS = (2, 4, 8)           # segment_block.cuh, launch
WIDE = ("score", "rowcol")       # score_cell.cuh, seg_wide_class: 8 rows
BLOCK_ENTRIES = {
    "one-shot": ("table", "stats_table", "rowcol", "stats_rowcol"),  # scan_chunked.cu
    "masked": OUTPUTS,                                                # scan_chunked_banded.cu
    "segment": ("score", "trace", "stats"),                          # scan_segment.cu
    "tile": ("score", "trace", "stats"),                             # scan_rowseg.cu
}
WALK = "walk"                    # trace_walk.cu: one kernel
PACKED_ROWS = (2, 4, 8)          # segment16.cuh, launch16_rows
PACKED_KINDS = ("sw", "nw")      # segment16.cuh, launch16: SW, or NW / SG
PACKED_SUBS = ("pair", "rows")   # segment16.cuh, launch16: the pair table


def short_key(cls, rows, layout, banded) -> str:
    key = f"short {'masked' if banded else 'unbanded'} {cls} R{rows}"
    return key + (f" L{layout}" if cls in STATS else "")


def ring_key(lanes, rows, subs) -> str:
    return f"ring G{lanes} kR{rows} {subs}"


def block_key(entry, cls, rows) -> str:
    return f"block {entry} {cls} R{rows}"


def packed_key(rows, kind, subs) -> str:
    return f"block packed R{rows} {kind} {subs}"


def _forms() -> tuple:
    forms = []
    for banded in (False, True):
        for cls in OUTPUTS:
            for layout in (SHORT_LAYOUTS if cls in STATS else (0,)):
                forms += [short_key(cls, r, layout, banded)
                          for r in SHORT_ROWS]
    forms += [ring_key(g, r, s) for g in RING_LANES for r in RING_ROWS
              for s in SUBS]
    for entry, classes in BLOCK_ENTRIES.items():
        forms += [block_key(entry, cls, r) for cls in classes
                  for r in BLOCK_ROWS if r != 8 or cls in WIDE]
    forms += [packed_key(r, k, s) for r in PACKED_ROWS for k in PACKED_KINDS
              for s in PACKED_SUBS]
    return tuple(forms + [WALK])


# every kernel instantiation the build compiles
FORMS = _forms()
# runtime branches of those forms that the cover schedule must reach too
AXES = tuple(
    [f"short subs {b} {cls} {s}" for b in ("unbanded", "masked")
     for cls in OUTPUTS for s in SUBS]
    + [f"block warps {w}" for w in range(1, 9)]
    + [f"block cluster {c}" for c in range(1, 9)]
    + [f"block subs {s}" for s in SUBS]
    + ["walk copy wide", "walk copy bytes"])


# -- failures -------------------------------------------------------------------

class Mismatch(AssertionError):
    """The port differs from an oracle (or fails); ``repro`` says where."""

    def __init__(self, what: str, cell=None):
        super().__init__(what)
        self.repro = {"what": what, "cell": cell}


class Uncovered(AssertionError):
    """A cover run left a compiled form or plan axis unreached."""


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (bytes, bytearray)):
        return bytes(x).decode("latin-1")
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def diff(got, want, path=()):
    """(path, got, want) of the first difference between two trees of
    dicts, lists and arrays, or None."""
    if isinstance(want, dict):
        for k in want:
            if k not in got:
                return path + (k,), "missing", "present"
            d = diff(got[k], want[k], path + (k,))
            if d:
                return d
        return None
    if isinstance(want, (list, tuple)) and not (
            want and isinstance(want[0], (int, np.integer))):
        if len(got) != len(want):
            return path + ("len",), len(got), len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            d = diff(g, w, path + (i,))
            if d:
                return d
        return None
    if isinstance(want, (str, bytes)):
        return None if got == want else (path, got, want)
    g, w = _host(got), _host(want)
    if g.shape != w.shape:
        return path + ("shape",), g.shape, w.shape
    bad = np.argwhere(g != w)
    if not len(bad):
        return None
    i = tuple(int(v) for v in bad[0])
    return path + i, g[i].item(), w[i].item()


def hold(name, got, want) -> None:
    d = diff(got, want)
    if d:
        path, g, w = d
        raise Mismatch(f"{name}: {'/'.join(map(str, path))}: {g!r} != {w!r}",
                       cell=[list(path), g, w])


# -- draws of the API tier (fuzz_session.py's, plus a PSSM and empty sides) ------

MODES = [("global_", "nw"), ("semi_global", "sg"), ("local", "sw")]
DNA = list(b"ACGT")
AA = list(b"ARNDCQEGHILKMFPSTWYV")
MIXED = list(b"ACGTacgt")


def rand_matrix(rng, pssm=True):
    """(spec, alphabet): fuzz_session's three kinds, and a PSSM."""
    kind = int(rng.integers(0, 4 if pssm else 3))
    if kind == 0:
        return ("dna", int(rng.integers(1, 6)), -int(rng.integers(1, 6))), DNA
    if kind == 1:
        return ("blosum62",), AA
    if kind == 2:
        return ("dna", int(rng.integers(1, 4)), -int(rng.integers(1, 4))), \
            MIXED
    return ("pssm", int(rng.integers(0, 1 << 31)),
            int(rng.integers(1, 48))), DNA


def make_matrix(spec, cls=Matrix):
    """The matrix a spec names (``cls``: the port's Matrix, or another
    package's with the same constructors)."""
    if spec[0] == "dna":
        return cls.create(b"ACGT", spec[1], spec[2])
    if spec[0] == "blosum62":
        return cls.from_name("blosum62")
    seed, rows = spec[1], spec[2]
    vals = np.random.default_rng(seed).integers(-3, 6, size=rows * 4)
    return cls.create_pssm(b"ACGT", vals, rows)


def rand_seqs(rng, alpha, n, lo=1, hi=60):
    return [rng.choice(alpha, size=rng.integers(lo, hi)).astype("uint8")
            .tobytes() for _ in range(n)]


def blank(rng, seqs, p=0.08):
    """Empty some sides (golden's answer there is the port's)."""
    return [b"" if rng.random() < p else s for s in seqs]


def rand_free(rng):
    """Random (query_gaps, ref_gaps) lists in the builder's vocabulary."""
    opts = ([], ["prefix"], ["suffix"], ["prefix", "suffix"])
    return (list(opts[rng.integers(0, 4)]), list(opts[rng.integers(0, 4)]))


def builder(m, setter, open_, ext, free=None, width="sat"):
    b = (Aligner.new().matrix(m).gap_open(open_).gap_extend(ext)
         .solution_width(width))
    getattr(b, setter)()
    if free is not None:
        b.allow_query_gaps(free[0]).allow_ref_gaps(free[1])
    return b


def golden_free(mode, free):
    if mode == "sg" and free is not None:
        return golden.free_flags(mode, free[0], free[1])
    return golden.free_flags(mode)


class _EmptyLocal:
    """SW with an empty side: the empty local alignment, 0 at (0, 0)
    (golden's SW cannot index an empty grid)."""
    score = end_query = end_ref = matches = similar = length = 0


def golden_of(q, r, m, open_, ext, mode, free):
    if mode == "sw" and not (q and r):
        return _EmptyLocal
    return golden.align_seqs(q, r, m, open_, ext, mode, free=free)


def view(a) -> dict:
    """Every output of an Alignment, by name."""
    v = {"score": a.get_score(), "end_query": a.get_end_query(),
         "end_ref": a.get_end_ref(), "saturated": a.is_saturated()}
    planes = ("score", "matches", "similar", "length")
    if a.is_stats():
        v.update(matches=a.get_matches(), similar=a.get_similar(),
                 length=a.get_length())
    if a.is_table():
        for p in planes if a.is_stats_table() else planes[:1]:
            v[f"{p}_table"] = getattr(a, f"get_{p}_table")().as_array()
    if a.is_rowcol():
        for p in planes if a.is_stats_rowcol() else planes[:1]:
            v[f"{p}_row"] = getattr(a, f"get_{p}_row")()
            v[f"{p}_col"] = getattr(a, f"get_{p}_col")()
    if a.is_trace():
        v["trace_table"] = a.get_trace_table().as_array()
    return v


def hold_golden(name, v, g, planes) -> None:
    """A pair's outputs ``v`` against golden's ``g``: scalars and payloads
    always, planes, rows and columns where ``planes`` (both sides have
    letters; golden has no rows of an empty grid)."""
    want = {"score": g.score, "end_query": g.end_query, "end_ref": g.end_ref}
    want.update((k, getattr(g, k)) for k in ("matches", "similar", "length")
                if k in v)
    if planes:
        want.update((k, getattr(g, k)) for k in v
                    if k.endswith(("_table", "_row", "_col")))
    hold(name, {k: v[k] for k in want}, want)


# -- the API tier ---------------------------------------------------------------

def check_scalars(rng, ctx):
    spec, alpha = rand_matrix(rng)
    setter, mode = MODES[rng.integers(0, 3)]
    open_, ext = int(rng.integers(0, 14)), int(rng.integers(0, 8))
    free = rand_free(rng) if mode == "sg" else None
    stats = bool(rng.integers(0, 2))
    n = int(rng.integers(1, 20))
    qs = blank(rng, rand_seqs(rng, alpha, n))
    rs = blank(rng, rand_seqs(rng, alpha, n))
    ctx.note(matrix=spec, mode=mode, open=open_, ext=ext, free=free,
             stats=stats, qs=qs, rs=rs)
    m = make_matrix(spec)

    def call(dev):
        b = builder(m, setter, open_, ext, free)
        if stats:
            b.use_stats()
        al = b.device(dev).build()
        return [view(a) for a in al.align_batch(qs, rs)], [al]

    outs = ctx.each(call)
    gfree = golden_free(mode, free)
    for i, (q, r) in enumerate(zip(qs, rs)):
        hold_golden(f"scalars pair {i} vs golden", outs[0][i],
                    golden_of(q, r, m, open_, ext, mode, gfree), q and r)
    ctx.agree("scalars", outs)
    return f"scalars {mode} o{open_} e{ext} stats={stats} n={n}"


def check_cigars(rng, ctx):
    spec, alpha = rand_matrix(rng)
    setter, mode = MODES[rng.integers(0, 3)]
    open_, ext = int(rng.integers(0, 14)), int(rng.integers(1, 8))
    free = rand_free(rng) if mode == "sg" else None
    n = int(rng.integers(1, 30))
    qs = blank(rng, rand_seqs(rng, alpha, n))
    rs = blank(rng, rand_seqs(rng, alpha, n))
    chunk = int(rng.choice([4, 16, 1 << 30]))
    ctx.note(matrix=spec, mode=mode, open=open_, ext=ext, free=free,
             cigar_chunk=chunk, qs=qs, rs=rs)
    m = make_matrix(spec)

    def call(dev):
        al = builder(m, setter, open_, ext, free).device(dev).build()
        tr = builder(m, setter, open_, ext, free).use_trace().device(
            dev).build()
        with patched(aligner_mod.Aligner, _CIGAR_CHUNK=chunk):
            alns, cigs = al.align_cigars(qs, rs)
        ref = tr.align_batch(qs, rs)
        out = {"scores": [view(a) for a in alns], "cigars": cigs,
               "trace": [view(a) for a in ref],
               "trace_cigars": tr.cigars(ref, qs, rs)}
        return out, [al, tr]

    outs = ctx.each(call)
    got = outs[0]
    gfree = golden_free(mode, free)
    hold("align_cigars vs use_trace() + cigars()", got["cigars"],
         got["trace_cigars"])
    for i, (q, r) in enumerate(zip(qs, rs)):
        hold(f"cigars pair {i}: align_cigars vs use_trace()",
             got["scores"][i],
             {k: got["trace"][i][k] for k in got["scores"][i]})
        g = golden_of(q, r, m, open_, ext, mode, gfree)
        hold_golden(f"cigars pair {i} vs golden", got["trace"][i], g, q and r)
        if q and r:
            want = golden.walk_trace(g.trace_table, q, r, g.end_query,
                                     g.end_ref, mode, gfree).cigar_string()
            hold(f"cigars pair {i}: CIGAR vs golden's walk", got["cigars"][i],
                 want)
    ctx.agree("cigars", outs)
    return f"cigars {mode} o{open_} e{ext} n={n} chunk={chunk}"


def check_many(rng, ctx):
    spec, alpha = rand_matrix(rng)
    setter, mode = MODES[rng.integers(0, 3)]
    open_, ext = int(rng.integers(0, 14)), int(rng.integers(0, 8))
    n = int(rng.integers(2, 30))
    qs = blank(rng, rand_seqs(rng, alpha, n, 1, 300))
    rs = blank(rng, rand_seqs(rng, alpha, n, 1, 300))
    pick = [int(i) for i in rng.choice(n, min(n, 6), replace=False)]
    ctx.note(matrix=spec, mode=mode, open=open_, ext=ext, pick=pick, qs=qs,
             rs=rs)
    m = make_matrix(spec)

    def call(dev):
        al = builder(m, setter, open_, ext).device(dev).build()
        many = [view(a) for a in al.align_many(qs, rs)]
        return {"many": many,
                "ones": [view(al.align(qs[i], rs[i])) for i in pick]}, [al]

    outs = ctx.each(call)
    gfree = golden_free(mode, None)
    for k, i in enumerate(pick):
        hold(f"align_many pair {i} vs align", outs[0]["many"][i],
             outs[0]["ones"][k])
        if len(qs[i]) * len(rs[i]) <= 40000 and k < 3:
            hold_golden(f"align_many pair {i} vs golden", outs[0]["many"][i],
                        golden_of(qs[i], rs[i], m, open_, ext, mode, gfree),
                        qs[i] and rs[i])
    ctx.agree("many", outs)
    return f"many {mode} o{open_} e{ext} n={n}"


def check_stream(rng, ctx):
    spec, alpha = rand_matrix(rng)
    setter, mode = MODES[rng.integers(0, 3)]
    open_, ext = int(rng.integers(0, 14)), int(rng.integers(1, 8))
    n = int(rng.integers(2, 60))
    qs = blank(rng, rand_seqs(rng, alpha, n))
    rs = blank(rng, rand_seqs(rng, alpha, n))
    flush = int(rng.choice([2, 7, 64]))
    ctx.note(matrix=spec, mode=mode, open=open_, ext=ext, flush=flush, qs=qs,
             rs=rs)
    m = make_matrix(spec)

    def call(dev):
        al = builder(m, setter, open_, ext).device(dev).build()
        batch = [view(a) for a in al.align_batch(qs, rs)]
        with StreamingAligner(al, flush_size=flush) as st:
            hs = st.submit_many(qs, rs)
            st.flush()
            got = [view(h.result()) for h in hs]
        return {"batch": batch, "stream": got}, [al]

    outs = ctx.each(call)
    hold("stream vs align_batch", outs[0]["stream"], outs[0]["batch"])
    gfree = golden_free(mode, None)
    for i in [int(i) for i in rng.choice(n, min(n, 8), replace=False)]:
        hold_golden(f"stream pair {i} vs golden", outs[0]["stream"][i],
                    golden_of(qs[i], rs[i], m, open_, ext, mode, gfree),
                    qs[i] and rs[i])
    ctx.agree("stream", outs)
    return f"stream {mode} o{open_} e{ext} n={n} flush={flush}"


def _one_pair_check(name, rng, ctx, configure):
    """A table or rowcol check: one pair, golden's planes."""
    spec, alpha = rand_matrix(rng)
    setter, mode = MODES[rng.integers(0, 3)]
    open_, ext = int(rng.integers(0, 10)), int(rng.integers(0, 6))
    free = rand_free(rng) if mode == "sg" else None
    stats = bool(rng.integers(0, 2))
    q, = rand_seqs(rng, alpha, 1, 1, 40)
    r, = rand_seqs(rng, alpha, 1, 1, 40)
    ctx.note(matrix=spec, mode=mode, open=open_, ext=ext, free=free,
             stats=stats, qs=[q], rs=[r])
    m = make_matrix(spec)

    def call(dev):
        b = configure(builder(m, setter, open_, ext, free))
        if stats:
            b.use_stats()
        al = b.device(dev).build()
        return view(al.align(q, r)), [al]

    outs = ctx.each(call)
    hold_golden(f"{name} vs golden", outs[0],
                golden_of(q, r, m, open_, ext, mode, golden_free(mode, free)),
                True)
    ctx.agree(name, outs)
    return f"{name} {mode} o{open_} e{ext} stats={stats}"


def check_tables(rng, ctx):
    return _one_pair_check("table", rng, ctx, lambda b: b.use_table())


def check_rowcol(rng, ctx):
    return _one_pair_check("rowcol", rng, ctx, lambda b: b.use_last_rowcol())


def check_widths(rng, ctx):
    spec, alpha = rand_matrix(rng)
    setter, mode = MODES[rng.integers(0, 3)]
    open_, ext = int(rng.integers(0, 12)), int(rng.integers(0, 6))
    n = int(rng.integers(1, 10))
    qs = blank(rng, rand_seqs(rng, alpha, n))
    rs = blank(rng, rand_seqs(rng, alpha, n))
    ctx.note(matrix=spec, mode=mode, open=open_, ext=ext, qs=qs, rs=rs)
    m = make_matrix(spec)
    widths = ("sat", "8", "16", "32", "64")

    def call(dev):
        out, als = {}, []
        for width in widths:
            al = builder(m, setter, open_, ext, width=width).device(
                dev).build()
            out[width] = [view(a) for a in al.align_batch(qs, rs)]
            als.append(al)
        return out, als

    outs = ctx.each(call)
    gfree = golden_free(mode, None)
    for i, (q, r) in enumerate(zip(qs, rs)):
        g = golden_of(q, r, m, open_, ext, mode, gfree)
        for width in widths:
            # scores are exact at every width; only the flags differ
            hold_golden(f"width {width} pair {i} vs golden",
                        outs[0][width][i], g, q and r)
    ctx.agree("widths", outs)
    return f"widths {mode} o{open_} e{ext} n={n}"


def check_banded(rng, ctx):
    spec, alpha = rand_matrix(rng)
    open_, ext = int(rng.integers(0, 10)), int(rng.integers(0, 6))
    n = int(rng.integers(1, 10))
    qs = blank(rng, rand_seqs(rng, alpha, n, 1, 40))
    rs = blank(rng, rand_seqs(rng, alpha, n, 1, 40))
    bw = max(1, max(len(x) for x in qs), max(len(x) for x in rs))
    bw2 = int(rng.integers(1, 8))
    pick = [int(i) for i in rng.choice(n, min(n, 3), replace=False)]
    ctx.note(matrix=spec, open=open_, ext=ext, bandwidth=bw, narrow=bw2,
             pick=pick, qs=qs, rs=rs)
    m = make_matrix(spec)

    def call(dev):
        full = (Aligner.new().matrix(m).gap_open(open_).gap_extend(ext)
                .bandwidth(bw).device(dev).build())
        narrow = (Aligner.new().matrix(m).gap_open(open_).gap_extend(ext)
                  .bandwidth(bw2).device(dev).build())
        out = {"full": [a.get_score() for a in full.banded_nw_batch(qs, rs)],
               "narrow": [a.get_score()
                          for a in narrow.banded_nw_batch(qs, rs)],
               "ones": [narrow.banded_nw(qs[i], rs[i]).get_score()
                        for i in pick]}
        return out, [full, narrow]

    outs = ctx.each(call)
    got = outs[0]
    for i, (q, r) in enumerate(zip(qs, rs)):
        # a band as wide as the pair is exact NW
        hold(f"banded pair {i} (full band) vs golden NW", got["full"][i],
             golden_of(q, r, m, open_, ext, "nw", None).score)
        sub = m.scores_for(m.encode(q), m.encode(r)).astype(np.int64)
        want = golden.banded_nw_fill(sub, open_, ext, bw2)
        hold(f"banded pair {i} (bw {bw2}) vs golden's banded fill",
             got["narrow"][i], NEG if want < -(10 ** 8) else want)
    for k, i in enumerate(pick):
        hold(f"banded_nw_batch pair {i} vs banded_nw", got["narrow"][i],
             got["ones"][k])
    ctx.agree("banded", outs)
    return f"banded o{open_} e{ext} n={n} bw={bw2}"


def check_profile(rng, ctx):
    spec, alpha = rand_matrix(rng, pssm=False)
    setter, mode = MODES[rng.integers(0, 3)]
    open_, ext = int(rng.integers(0, 12)), int(rng.integers(1, 6))
    q, = rand_seqs(rng, alpha, 1, 2, 40)
    n = int(rng.integers(1, 15))
    refs = blank(rng, rand_seqs(rng, alpha, n, 1, 60))
    stats = bool(rng.integers(0, 2))
    ctx.note(matrix=spec, mode=mode, open=open_, ext=ext, stats=stats,
             qs=[q], rs=refs)
    m = make_matrix(spec)

    def call(dev):
        b = (Aligner.new().profile(Profile.new(q, stats, m)).gap_open(open_)
             .gap_extend(ext))
        getattr(b, setter)()
        al = b.device(dev).build()
        return [view(a) for a in al.align_batch(None, refs)], [al]

    outs = ctx.each(call)
    gfree = golden.free_flags(mode)
    for i, r in enumerate(refs):
        hold_golden(f"profile ref {i} vs golden", outs[0][i],
                    golden_of(q, r, m, open_, ext, mode, gfree), q and r)
    ctx.agree("profile", outs)
    return f"profile {mode} o{open_} e{ext} stats={stats} n={n}"


API_CHECKS = (check_scalars, check_cigars, check_many, check_stream,
              check_tables, check_widths, check_rowcol, check_banded,
              check_profile)


# -- the launchers' rules ---------------------------------------------------------

CSRC = os.path.join(ROOT, "parasail_rs_tpu_torch", "csrc")
_host_lib = None


def host_plans() -> ctypes.CDLL:
    """The launchers' rules on the CPU: ``csrc/score_host.cc``'s
    ``pt_*_plan_host`` (the same functions of ``score_cell.cuh`` the card's
    launchers call), built once with g++ -O0 into the port's git-ignored
    ``_build/``, named by a hash of the sources."""
    global _host_lib
    if _host_lib is not None:
        return _host_lib
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cc")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha1()
    for path in srcs:
        with open(path, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(ROOT, "parasail_rs_tpu_torch", "_build")
    final = os.path.join(out_dir, f"libptplans-{h.hexdigest()[:12]}.so")
    if not os.path.exists(final):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{final}.tmp{os.getpid()}"
        try:
            subprocess.run([os.environ.get("CXX", "g++"), "-O0", "-std=c++17",
                            "-shared", "-fPIC", "-I", CSRC,
                            os.path.join(CSRC, "score_host.cc"), "-o", tmp],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(final)
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.pt_short_plan_host.argtypes = [i] * 7 + [p]
    lib.pt_band_plan_host.argtypes = [i] * 6 + [p]
    lib.pt_block_plan_host.argtypes = [i] * 9 + [p]
    lib.pt_segment16_plan_host.argtypes = [i] * 8 + [p]
    _host_lib = lib
    return lib


class Plans:
    """The three rules, asked of the built library on the card
    (``scan_kernel.short_plan`` / ``band_plan`` / ``block_plan``) and of
    their g++ build on the CPU (:func:`host_plans`)."""

    def __init__(self, device: torch.device):
        self.lib = None if device.type == "cuda" else host_plans()

    def _ask(self, fn, n, *args):
        plan = (ctypes.c_int * n)()
        fn(*(int(a) for a in args), ctypes.cast(plan, ctypes.c_void_p))
        return tuple(plan)

    def short(self, cls, B, Bq, Qp, Rp, A, profile):
        if self.lib is None:
            return tk.short_plan(cls, B, Bq, Qp, Rp, A, profile)
        return self._ask(self.lib.pt_short_plan_host, 3, OUTPUTS.index(cls),
                         B, Bq, Qp, Rp, A, profile)

    def band(self, B, Qp, Rp, A, bw, profile):
        if self.lib is None:
            return tk.band_plan(B, Qp, Rp, A, bw, profile)
        bw = max(-1, min(int(bw), int(Qp) + int(Rp)))
        return self._ask(self.lib.pt_band_plan_host, 2, B, Qp, Rp, bw, A,
                         profile)

    def block(self, cls, B, Qs, ncols, A, profile):
        """Under the current overrides, as the launcher reads them."""
        if self.lib is None:
            return tk.block_plan(cls, B, Qs, ncols, A, profile)
        return self._ask(self.lib.pt_block_plan_host, 3, OUTPUTS.index(cls),
                         B, Qs, ncols, A, profile, tk.SEGMENT_WARPS,
                         tk._LANE_ROWS, tk._CLUSTER)

    def packed(self, U, Qs, ncols, A, profile):
        """The packed form's, for U units, under the current overrides."""
        if self.lib is None:
            return tk.segment16_plan(U, Qs, ncols, A, profile)
        return self._ask(self.lib.pt_segment16_plan_host, 3, U, Qs, ncols, A,
                         profile, tk.SEGMENT_WARPS, tk._LANE_ROWS,
                         tk._CLUSTER)


@contextlib.contextmanager
def patched(obj, **values):
    """Set attributes for a block, and put every one back after it."""
    old = {k: getattr(obj, k) for k in values}
    try:
        for k, v in values.items():
            setattr(obj, k, v)
        yield
    finally:
        for k, v in old.items():
            setattr(obj, k, v)


def launches() -> Counter:
    """The wrappers' launch counters, by kernel family."""
    return Counter({
        "short": sum(tk.SHORT_LAUNCHES.values()),
        "ring": tk.BANDED_WARP_LAUNCHES,
        "short masked": tk.BANDED_FORM_LAUNCHES["short"],
        "block masked": tk.BANDED_FORM_LAUNCHES["block"],
        "chunked": tk.CHUNKED_LAUNCHES, "segment": tk.SEGMENT_LAUNCHES,
        "packed": tk.SEGMENT16_LAUNCHES, "tile": tk.ROWSEG_LAUNCHES,
        "walk": tw.LAUNCHES})


# -- draws of the ops tier --------------------------------------------------------

SHORT_QP = {4: (1, 128), 5: (129, 160), 6: (161, 192), 8: (193, 256)}


def _penalties(rng):
    regime = int(rng.integers(0, 4))
    if regime == 0:                                   # open > ext
        e = int(rng.integers(1, 6))
        return int(rng.integers(e + 1, 15)), e
    if regime == 1:                                   # open == ext
        o = int(rng.integers(1, 7))
        return o, o
    if regime == 2:                                   # open < ext
        o = int(rng.integers(0, 6))
        return o, int(rng.integers(o + 1, 9))
    return 0, 0


def _block_force(rng, rows):
    """(warps, rows, cluster) for the overrides: 0 leaves one to the rule."""
    def pick():
        return int(rng.integers(1, 9)) if rng.random() < 0.75 else 0
    return [pick(), rows, pick()]


def ops_draw(rng, target=None) -> dict:
    """One ops-tier draw, aimed at ``target`` (a key of :data:`FORMS` or
    :data:`AXES`) or, with None, at a random one with the rules' own
    picks half the time."""
    aimed = target is not None
    if target is None:
        target = str(rng.choice(FORMS + AXES))
    mode = ("nw", "sg", "sw")[int(rng.integers(0, 3))]
    free = {"nw": [False] * 4, "sw": [True] * 4}.get(
        mode, [bool(x) for x in rng.integers(0, 2, size=4)])
    open_, ext = _penalties(rng)
    subs = SUBS[int(rng.integers(0, 2))]
    d = {"target": target, "seed": int(rng.integers(0, 1 << 31)),
         "op": "align", "outputs": "score", "mode": mode, "free": free,
         "open": open_, "ext": ext,
         "width": ("sat", "8", "16", "32", "64")[int(rng.integers(0, 5))],
         "subs": subs, "A": int(rng.choice([4, 5, 20, 24, 25])),
         "scale": int(rng.choice([1, 1, 1, 40])), "banded": False, "bw": 0,
         "band_form": None, "force": [0, 0, 0], "B": int(rng.integers(1, 9)),
         "bq_shared": bool(rng.random() < 0.3)}
    t = target.split()

    def dims(Qp, Rp):
        d["Qp"], d["Rp"] = int(Qp), int(Rp)

    def banded(cls, Qp, Rp):
        d.update(banded=True, bw=int(rng.integers(-1, max(Qp, Rp) + 3)))
        if cls == "score":
            d["band_form"] = [0, 0]          # the masked sweep, not the ring

    def block(entry, cls, rows):
        d["outputs"] = cls
        d["force"] = _block_force(rng, rows)
        if entry == "one-shot":
            d["op"] = "chunked"
            dims(rng.integers(1, 321), rng.integers(1, 129))
        elif entry == "segment":
            d["op"] = "segment"
            d["seg"] = int(rng.integers(8, 97))
            dims(rng.integers(1, 321), rng.integers(1, 161))
        elif entry == "masked":
            dims(rng.integers(257, 321), rng.integers(1, 97))
            banded(cls, d["Qp"], d["Rp"])
        else:                                            # tile
            d["op"] = "rowseg"
            d["D"], d["q_chunk"] = int(rng.integers(1, 5)), int(
                rng.integers(8, 97))
            dims(d["q_chunk"] * int(rng.integers(1, 4)),
                 d["D"] * int(rng.integers(1, 49)))

    def short(cls, rows, layout, is_banded):
        d["outputs"] = cls
        lo, hi = SHORT_QP[rows]
        Qp = int(rng.integers(lo, hi + 1))
        if layout == 2:                   # [m | s] + l: Qp + Rp >= 1023
            Rp = int(rng.integers(1023 - Qp, 1023 - Qp + 16))
        else:
            Rp = int(rng.integers(1, 129))
            if Qp * Rp <= 20000 and rng.random() < 0.15:
                d["B"] = int(rng.integers(133, 301))     # pairs a block > 1
        dims(Qp, Rp)
        if is_banded:
            banded(cls, Qp, Rp)

    def any_block():
        entry = str(rng.choice(list(BLOCK_ENTRIES)))
        cls = str(rng.choice(BLOCK_ENTRIES[entry]))
        rows = int(rng.choice([r for r in BLOCK_ROWS if r != 8 or
                               cls in WIDE]))
        block(entry, cls, rows)

    if t[0] == "short" and t[1] == "subs":
        d["subs"] = t[4]
        short(t[3], int(rng.choice(SHORT_ROWS)), None, t[2] == "masked")
    elif t[0] == "short":
        short(t[2], int(t[3][1:]), int(t[4][1:]) if len(t) > 4 else None,
              t[1] == "masked")
    elif t[0] == "ring":
        lanes, rows = int(t[1][1:]), int(t[2][2:])
        reach = (lanes - 1) * rows + lanes + 1
        d.update(subs=t[3], band_form=[lanes, rows], banded=True,
                 bw=int(rng.integers(-1, (reach - 1) // 2 + 1)))
        dims(rng.integers(1, 129), rng.integers(1, 129))
    elif t[0] == "block" and t[1] == "packed":
        # the packed form: the score class of the segment route, with a
        # band; its kind by the mode, its scores by the letters
        block("segment", "score", int(t[2][1:]))
        if t[3] == "sw":
            d.update(mode="sw", free=[True] * 4)
        elif d["mode"] == "sw":
            d.update(mode="nw", free=[False] * 4)
        if t[4] == "pair":
            d.update(subs="table", A=int(rng.choice([4, 5])))
        else:
            d.update(A=int(rng.choice([20, 24, 25])), bq_shared=True)
    elif t[0] == "block" and t[1] in BLOCK_ENTRIES:
        block(t[1], t[2], int(t[3][1:]))
        if t[1] == "segment" and t[2] == "score":
            # a profile a pair of two pairs or more: the int32 form (the
            # packed one takes a table or one query's profile)
            d.update(subs="profile", bq_shared=False, B=max(d["B"], 2))
    elif t[0] == "block":
        any_block()
        if t[1] == "subs":
            d["subs"] = t[2]
        else:
            d["force"][0 if t[1] == "warps" else 2] = int(t[2])
    else:                                                # walk
        d["outputs"] = "trace"
        Qp, Rp = int(rng.integers(1, 257)), 16 * int(rng.integers(1, 9))
        if t[-1] == "bytes" or (len(t) == 1 and rng.random() < 0.5):
            Rp -= int(rng.integers(1, 16))
        dims(Qp, Rp)
        if rng.random() < 0.25:
            banded("trace", Qp, Rp)
    if not aimed and rng.random() < 0.5:
        d["force"], d["band_form"] = [0, 0, 0], None     # the rules' picks
    return d


def ops_inputs(d, device) -> dict:
    """A draw's tensors, from its seed: numpy arrays (``np``) and the same
    on ``device``."""
    rng = np.random.default_rng(d["seed"])
    B, Bq, Qp, Rp, A = _dims(d)
    profile = d["subs"] == "profile"

    def lengths(P):
        kind = rng.integers(0, 8, size=B)
        n = rng.integers(1, P + 1, size=B)
        n[kind == 0], n[kind == 1], n[kind == 2] = 0, 1, P
        return n.astype(np.int32)

    qlen, rlen = lengths(Qp), lengths(Rp)
    qidx = rng.integers(0, A, size=(Bq, Qp)).astype(np.int32)
    ridx = rng.integers(0, A, size=(B, Rp)).astype(np.int32)
    if rng.random() < 0.15:      # letters outside [0, A) score 0
        qidx[rng.random(qidx.shape) < 0.03] = A
        ridx[rng.random(ridx.shape) < 0.03] = A
    qfill = qlen if Bq == B else np.full(1, qlen.max(), np.int32)
    qidx[np.arange(Qp)[None, :] >= qfill[:, None]] = -1
    ridx[np.arange(Rp)[None, :] >= rlen[:, None]] = 0
    s = d["scale"]
    x = {"ridx": ridx, "qlen": qlen, "rlen": rlen, "qidx": qidx}
    if profile:
        x["profile"] = rng.integers(-4 * s, 12 * s,
                                    size=(Bq, Qp, A)).astype(np.int32)
    else:
        x["table"] = rng.integers(-4 * s, 7 * s, size=(A, A)).astype(np.int32)
    return {"np": x, "dev": {k: torch.from_numpy(v).to(device)
                             for k, v in x.items()}}


@contextlib.contextmanager
def forced(d):
    """The draw's overrides of the launchers' rules, put back after."""
    warps, rows, cluster = d["force"]
    band = None if d["band_form"] is None else tuple(d["band_form"])
    with patched(tk, SEGMENT_WARPS=warps, _LANE_ROWS=rows, _CLUSTER=cluster,
                 _BAND_FORM=band):
        yield


def packed(d) -> bool:
    """Does the segment route run the draw's score class packed
    (``dispatch.packed_units``: a table or one query's profile, and a
    band at its penalties and largest |score|)?  The largest |score| is
    the most that :func:`ops_inputs` can draw: the one it drew is no
    larger, and both leave the band at every drawn penalty."""
    s = d["scale"]
    bound = max(4 * s, (12 if d["subs"] == "profile" else 7) * s - 1)
    return (d["outputs"] == "score" and d["op"] == "segment" and
            (d["subs"] == "table" or d["bq_shared"] or d["B"] == 1) and
            tk.packed_usable(d["open"], d["ext"], bound))


def predict(d, dims, plans):
    """(forms, axes, launches) of a draw, by the launchers' rules."""
    cls, op = d["outputs"], d["op"]
    B, Bq, Qp, Rp, A = dims
    profile = d["subs"] == "profile"
    forms, axes, n = [], [], Counter()

    def block(entry, Qs, ncols):
        R, W, C = plans.block(cls, B, Qs, ncols, A, profile)
        forms.append(block_key(entry, cls, R))
        axes.extend([f"block warps {W}", f"block cluster {C}",
                     f"block subs {d['subs']}"])

    one_shot = "segment" if cls in tk.SEGMENT_OUTPUTS else "one-shot"
    if op == "align":
        form = None
        if d["banded"] and cls == "score":
            form = tk._BAND_FORM or plans.band(B, Qp, Rp, A, d["bw"], profile)
        rows, _, layout = plans.short(cls, B, Bq, Qp, Rp, A, profile)
        masked = "masked" if d["banded"] else "unbanded"
        if form and form[0]:
            forms.append(ring_key(form[0], form[1], d["subs"]))
            n["ring"] += 1
        elif rows:
            forms.append(short_key(cls, rows, layout, d["banded"]))
            axes.append(f"short subs {masked} {cls} {d['subs']}")
            n["short masked" if d["banded"] else "short"] += 1
        else:
            block("masked" if d["banded"] else one_shot, Qp, Rp)
            n["block masked" if d["banded"] else "chunked"] += 1
    elif op == "chunked":
        block(one_shot, Qp, Rp)
        n["chunked"] += 1
    elif op == "segment" and packed(d):
        seg = max(1, min(d["seg"], Rp))
        R, W, C = plans.packed(-(-B // 2), Qp, seg, A, profile)
        forms.append(packed_key(R, "sw" if d["mode"] == "sw" else "nw",
                                "rows" if profile or A > 7 else "pair"))
        axes.extend([f"block warps {W}", f"block cluster {C}",
                     f"block subs {d['subs']}"])
        n["packed"] += -(-Rp // seg)
    elif op == "segment":
        seg = max(1, min(d["seg"], Rp))
        block("segment", Qp, seg)
        n["segment"] += -(-Rp // seg)
    else:
        qc, D = d["q_chunk"], d["D"]
        block("tile", qc, Rp // D)
        n["tile"] += (Qp // qc) * D
    if cls == "trace":
        # every trace plane is a contiguous (B, Qp, Rp) tensor: the walk
        # copies its rows 16 bytes at a time where Rp is a multiple of 16
        forms.append(WALK)
        axes.append(f"walk copy {'bytes' if Rp % 16 else 'wide'}")
        n["walk"] += 1
    return forms, axes, n


def _dims(d) -> tuple:
    return (d["B"], 1 if d["bq_shared"] else d["B"], d["Qp"], d["Rp"],
            d["A"])


def _kw(d):
    return dict(open_=d["open"], ext=d["ext"], mode=d["mode"],
                free=tuple(d["free"]), width=d["width"], outputs=d["outputs"])


def _subs(x):
    t = x["dev"]
    if "table" in t:
        return {"table": t["table"], "qidx": t["qidx"]}
    return {"profile": t["profile"], "qidx": t["qidx"]}


def _batch(x, device):
    t = x["dev"]
    return dispatch.PairBatch(
        profile=t.get("profile"), qidx=t["qidx"], ridx=t["ridx"],
        qlen=x["np"]["qlen"], rlen=x["np"]["rlen"], table=t.get("table"),
        device=device)


def _routed(fn):
    routes = []
    out = fn(lambda route, reason: routes.append(route))
    return out, routes


def op_align(d, x, ctx):
    t = x["dev"]
    args = (t["ridx"], t["qlen"], t["rlen"])
    kw = dict(_kw(d), banded=d["banded"], bandwidth=d["bw"], **_subs(x))
    return tk.score_align(*args, **kw), tk.score_align_plain(*args, **kw)


def _plain(d, x):
    t = x["dev"]
    return tk.score_align_plain(t["ridx"], t["qlen"], t["rlen"], **_kw(d),
                                **_subs(x))


def op_chunked(d, x, ctx):
    """dispatch.launch with every batch long: the chunked route."""
    batch = _batch(x, ctx.device)
    kw = _kw(d)
    with patched(dispatch, CHUNK_ROWS=0):
        out, routes = _routed(lambda on: dispatch.launch(
            batch, gap_open=kw["open_"], gap_extend=kw["ext"],
            mode=kw["mode"], free=kw["free"], outputs=kw["outputs"],
            width=kw["width"], on_route=on))
    ctx.route(routes, "chunked")
    return out, _plain(d, x)


def op_segment(d, x, ctx):
    """dispatch.execute on the segment route: score_segment chained over
    segments of ``seg`` columns."""
    batch = _batch(x, ctx.device)
    kw = _kw(d)
    cols = dict.fromkeys(tk.SEGMENT_OUTPUTS, d["seg"])
    with patched(dispatch, SEGMENT_MIN_CELLS=1, SEGMENT_COLS=cols,
                 TRACE_ONE_SHOT_BYTES=0):
        out, routes = _routed(lambda on: dispatch.execute(
            batch, gap_open=kw["open_"], gap_extend=kw["ext"],
            mode=kw["mode"], free=kw["free"], outputs=kw["outputs"],
            width=kw["width"], on_route=on))
    ctx.route(routes, "segments")
    if "trace_table" in out:
        out["trace_table"] = torch.from_numpy(out["trace_table"]).to(
            ctx.device)
    return out, _plain(d, x)


def op_rowseg(d, x, ctx):
    """dist.seqpar_align_scan over D virtual shards: the tile kernel, held
    to the same chain of plain tiles and to the one-shot plain sweep."""
    t = x["dev"]
    table = t.get("table")
    kw = dict(open_=d["open"], ext=d["ext"], mesh=make_device_mesh(d["D"]),
              mode=d["mode"], free=tuple(d["free"]), q_chunk=d["q_chunk"],
              outputs=d["outputs"], width=d["width"], device=ctx.device,
              table=table)
    args = (t.get("profile"), t["ridx"], t["qlen"], t["rlen"], t["qidx"])
    got = seqpar_align_scan(*args, **kw)
    tiles = seqpar_align_scan(*args, **kw, _tile_fn=tk.score_rowseg_plain)
    hold("tile chain vs the one-shot plain sweep", tiles, _plain(d, x))
    return got, tiles


OPS = {"align": op_align, "chunked": op_chunked, "segment": op_segment,
       "rowseg": op_rowseg}


def _walk(d, got, x, ctx):
    """The walk on a trace plane, held to its plain version."""
    plane = got["trace_table"]
    if not plane.is_contiguous():
        raise Mismatch(f"a {d['op']} trace plane is not contiguous")
    t = x["dev"]

    def ends(k):
        return torch.as_tensor(_host(got[k]), dtype=torch.int32,
                               device=ctx.device)

    args = (plane, t["qidx"], t["ridx"], ends("end_query"), ends("end_ref"),
            d["mode"], tuple(d["free"]))
    hold("walk vs plain", tw.device_walk(*args),
         tw.device_walk_plain(*args))


def _pair(d, x, b):
    """Pair ``b``'s letters and (qlen, rlen) substitution scores, a letter
    outside [0, A) scoring 0, as the kernels read them."""
    a = x["np"]
    ql, rl = int(a["qlen"][b]), int(a["rlen"][b])
    bq = 0 if a["qidx"].shape[0] == 1 else b
    q, r = a["qidx"][bq, :ql], a["ridx"][b, :rl]
    A = d["A"]
    rok = (r >= 0) & (r < A)
    if "table" in a:
        ok = ((q >= 0) & (q < A))[:, None] & rok[None, :]
        sub = a["table"][np.clip(q, 0, A - 1)][:, np.clip(r, 0, A - 1)]
    else:
        ok = np.broadcast_to(rok[None, :], (ql, rl))
        sub = a["profile"][bq, :ql][:, np.clip(r, 0, A - 1)]
    return q, r, np.where(ok, sub, 0).astype(np.int64)


def _golden_pair(d, x, b, got) -> None:
    """Pair ``b`` of an unbanded draw against golden."""
    q, r, sub = _pair(d, x, b)
    ql, rl = len(q), len(r)
    if d["mode"] == "sw" and not (ql and rl):
        g = _EmptyLocal
    else:
        g = golden.align(sub, q[:, None] == r[None, :], d["open"], d["ext"],
                         d["mode"], tuple(d["free"]))
    v = {k: _host(got[k])[b] for k in got}
    for k in v:
        if k.endswith("_table"):
            v[k] = v[k][:ql, :rl]
        elif k.endswith("_row"):
            v[k] = v[k][:rl]
        elif k.endswith("_col"):
            v[k] = v[k][:ql]
    hold_golden(f"pair {b} vs golden", v, g, ql and rl)


def _golden_banded(d, x, b, got) -> None:
    """Pair ``b``'s banded NW score against golden's banded fill."""
    _, _, sub = _pair(d, x, b)
    want = golden.banded_nw_fill(sub, d["open"], d["ext"], d["bw"])
    hold(f"banded pair {b} vs golden's banded fill",
         int(_host(got["score"])[b]), NEG if want < -(10 ** 8) else want)


def _pair_of(path):
    """The batch index in a differing cell's path: the first int after the
    output's name (after the tuple index for the walk's outputs)."""
    names = [k for k, p in enumerate(path) if isinstance(p, str)]
    at = names[0] + 1 if names else 1
    return path[at] if at < len(path) and isinstance(path[at], int) else None


def run_ops(d, ctx):
    """Run one ops draw; return the forms and axes it reached.  A mismatch
    carries the differing pair's letters and scores in its repro."""
    x = ops_inputs(d, ctx.device)
    ctx.note(**d)
    try:
        return _run_ops(d, x, ctx)
    except Mismatch as e:
        b = _pair_of((e.repro.get("cell") or [()])[0])
        a = x["np"]
        if b is not None and b < d["B"]:
            bq = 0 if a["qidx"].shape[0] == 1 else b
            e.repro["pair"] = {
                "index": b, "qlen": a["qlen"][b], "rlen": a["rlen"][b],
                "qidx": a["qidx"][bq], "ridx": a["ridx"][b],
                **({"table": a["table"]} if "table" in a else
                   {"profile": a["profile"][bq]})}
            e.repro["pair"] = _jsonable(e.repro["pair"])
        raise


def _run_ops(d, x, ctx):
    with forced(d):
        forms, axes, want = predict(d, _dims(d), ctx.plans)
        before, reran = launches(), Counter(dispatch.RERUN16)
        got, plain = OPS[d["op"]](d, x, ctx)
        hold(f"{d['op']} {d['outputs']} vs plain", got, plain)
        if d["outputs"] == "trace":
            _walk(d, got, x, ctx)
        ran = launches()
        ran.subtract(before)
        reran = Counter(dispatch.RERUN16) - reran
        if reran["batches"]:
            # pairs the packed form flagged, again on the int32 form
            Qp, Rp, seg = d["Qp"], d["Rp"], max(1, min(d["seg"], d["Rp"]))
            R, W, C = ctx.plans.block("score", reran["pairs"], Qp, seg,
                                      d["A"], d["subs"] == "profile")
            forms.append(block_key("segment", "score", R))
            axes.extend([f"block warps {W}", f"block cluster {C}"])
            want["segment"] += -(-Rp // seg)
    ran = +ran
    if ran != (want if ctx.card else Counter()):
        raise Mismatch(f"launches {dict(ran)}, the rules say "
                       f"{dict(want) if ctx.card else {}}")
    # one pair against golden (banded: NW scores only), small enough for
    # golden's scalar fill to take milliseconds
    a, pick = x["np"], np.random.default_rng([d["seed"], 1])
    small = [b for b in range(d["B"]) if a["qlen"][b] * a["rlen"][b] <= 20000]
    for b in pick.choice(small, min(len(small), 1), replace=False):
        if not d["banded"]:
            _golden_pair(d, x, int(b), got)
        elif d["mode"] == "nw" and d["outputs"] == "score":
            _golden_banded(d, x, int(b), got)
    return forms, axes


# -- the run ------------------------------------------------------------------------

class Ctx:
    """One run's device, rules, tallies and the draw under way."""

    def __init__(self, device: torch.device):
        self.device = device
        self.card = device.type == "cuda"
        self.devices = [device] + ([torch.device("cpu")] if self.card else [])
        self.plans = Plans(device)
        self.draw = {}

    def note(self, **settings):
        self.draw.update(settings)

    def route(self, routes, kind):
        want = ("cuda_" if self.card else "torch_") + kind
        if not routes or set(routes) != {want}:
            raise Mismatch(f"routes {routes}, expected only {want!r}")

    def each(self, call):
        """``call(device)`` -> (result, aligners) on this run's device and,
        on the card, on the CPU too; every aligner's routes checked."""
        outs = []
        for dev in self.devices:
            out, als = call(dev)
            prefix = "cuda_" if dev.type == "cuda" else "torch_"
            for al in als:
                routes = dict(al.route_counter)
                if not routes or any(not r.startswith(prefix)
                                     for r, _ in routes):
                    raise Mismatch(f"routes on {dev}: {routes}")
            outs.append(out)
        return outs

    def agree(self, name, outs):
        if len(outs) == 2:
            hold(f"{name}: {self.device} vs the plain versions on the cpu",
                 outs[0], outs[1])


def run(device="cuda", draws=200, seed=0, cover=False, seconds=None,
        log=None) -> dict:
    """Fuzz the port on ``device`` (``"cuda"``: the kernels, each call also
    held to the CPU's plain versions; ``"cpu"``: the plain versions).

    ``draws`` is the budget of draws (None: until ``seconds`` run out); with
    ``cover`` the stratified schedule runs first, whatever the budget, and
    an unreached form or axis raises :class:`Uncovered`.  The first
    mismatch raises :class:`Mismatch`, whose ``repro`` holds the draw.
    Returns counts by check and by form, the compiled and reached tables,
    the unreached ones and the seconds taken."""
    dev = resolve_device(device)
    ctx = Ctx(dev)
    schedule = []
    if cover:
        schedule = ([("api", c.__name__) for c in API_CHECKS] +
                    [("ops", k) for k in FORMS] + [("ops", k) for k in AXES])
    checks = {c.__name__: c for c in API_CHECKS}
    master = np.random.default_rng(seed)
    counts, forms, axes, spent = Counter(), Counter(), Counter(), Counter()
    t0 = time.perf_counter()
    i = n = 0
    while True:
        if i < len(schedule):
            kind, target = schedule[i]
            if target in AXES and axes[target]:
                i += 1
                continue
        elif (draws is not None and n >= draws) or (
                seconds is not None and time.perf_counter() - t0 > seconds):
            break
        else:
            kind, target = ("api", None) if master.random() < 0.35 else \
                ("ops", None)
        draw_seed = [seed, i]
        rng = np.random.default_rng(draw_seed)
        ctx.draw = {}
        t1 = time.perf_counter()
        try:
            if kind == "api":
                fn = checks[target] if target else API_CHECKS[
                    int(rng.integers(0, len(API_CHECKS)))]
                ctx.note(check=fn.__name__)
                fn(rng, ctx)
                name = fn.__name__
            else:
                for _ in range(50):          # aim until the rules agree
                    d = ops_draw(rng, target)
                    with forced(d):
                        got = predict(d, _dims(d), ctx.plans)
                    if target is None or target in got[0] + got[1]:
                        break
                else:
                    raise Mismatch(f"no draw reached {target!r}")
                reached, ax = run_ops(d, ctx)
                name = f"ops {d['op']}"
                forms.update(reached)
                axes.update(ax)
            counts[name] += 1
            spent[name] += time.perf_counter() - t1
        except AssertionError as e:
            fail = e if isinstance(e, Mismatch) else Mismatch(repr(e))
            fail.repro.update(seed=seed, draw=i, draw_seed=draw_seed,
                              kind=kind, target=target,
                              settings=_jsonable(ctx.draw))
            raise fail from e
        except Exception as e:
            fail = Mismatch(f"{type(e).__name__}: {e}")
            fail.repro.update(seed=seed, draw=i, draw_seed=draw_seed,
                              kind=kind, target=target,
                              settings=_jsonable(ctx.draw))
            raise fail from e
        i += 1
        n += 1
        if log and n % 25 == 0:
            log(f"[fuzz] {n} draws, {time.perf_counter() - t0:.1f} s: "
                f"{dict(counts)}; forms {len(set(forms) & set(FORMS))}/"
                f"{len(FORMS)}")
    res = {"device": str(dev), "seed": seed, "draws": n,
           "api": sum(v for k, v in counts.items() if k.startswith("check")),
           "ops": sum(v for k, v in counts.items() if k.startswith("ops")),
           "checks": dict(counts), "seconds_by": dict(spent),
           "forms": dict(forms), "axes": dict(axes),
           "compiled": list(FORMS),
           "reached": [k for k in FORMS if forms[k]],
           "unreached": [k for k in FORMS if not forms[k]],
           "unreached_axes": [k for k in AXES if not axes[k]],
           "mismatches": 0, "seconds": time.perf_counter() - t0}
    if cover and (res["unreached"] or res["unreached_axes"]):
        raise Uncovered(f"unreached: {res['unreached']} "
                        f"{res['unreached_axes']}")
    return res


def replay(repro: dict, device="cuda") -> None:
    """Run the draw of a :class:`Mismatch`'s ``repro`` again (it may have
    been through JSON); raises the mismatch again if it still stands."""
    ctx = Ctx(resolve_device(device))
    settings = dict(repro["settings"])
    if repro["kind"] == "api":
        checks = {c.__name__: c for c in API_CHECKS}
        checks[settings["check"]](np.random.default_rng(repro["draw_seed"]),
                                  ctx)
    else:
        run_ops(settings, ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("minutes", nargs="?", type=float, default=10.0)
    ap.add_argument("--cpu", action="store_true",
                    help="fuzz the plain versions on the CPU")
    ap.add_argument("--seed", type=int, default=None,
                    help="the run's seed (default: the clock)")
    ap.add_argument("--cover", action="store_true",
                    help="first one draw aimed at every compiled form")
    ap.add_argument("--replay", metavar="JSON",
                    help="run the draw of a printed repro again")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.replay:
        with open(args.replay) as f:
            replay(json.load(f), device)
        print("[fuzz] the repro's draw passes now", flush=True)
        return 0
    seed = args.seed if args.seed is not None else int(time.time())
    print(f"[fuzz] seed {seed} on {'cpu' if args.cpu else 'cuda'}",
          flush=True)
    try:
        res = run(device, draws=None, seed=seed,
                  cover=args.cover, seconds=args.minutes * 60,
                  log=lambda m: print(m, flush=True))
    except Mismatch as e:
        print("FUZZ MISMATCH; repro:", flush=True)
        print(json.dumps(e.repro, indent=1), flush=True)
        return 1
    print(f"[fuzz] PASSED: {res['draws']} draws clean in "
          f"{res['seconds']:.1f} s, {len(res['reached'])}/{len(FORMS)} "
          f"forms: {res['checks']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
