#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the kernels from ``parasail_rs_tpu_torch/csrc`` with nvcc and
runs thirty-three phases on ``cuda``; any failure raises and the script exits
non-zero without printing a result.  ``score_align`` runs every unbanded
class on the short form (kernels K1a-K1d, ``csrc/scan_short.cu``, one
warp a pair) up to 256 padded query rows and on the block kernel's
one-shot form past them, so phases 2-13, 16, 17 and 23 hold and time
those forms where they say "score kernel", "trace kernel", "stats
kernel" or name a plane class:

1. build: the library's path, build time and each kernel's registers;
2. kernel vs plain: the score kernel against its plain PyTorch version
   on the same device tensors, at the headline shape (8,192 pairs of 150
   residues padded to 160, a seeded (B, 160, 25) profile, SW 11/1, width
   sat), on small seeded ragged batches covering NW, the nine SG
   free-end sets, SW, every width, both substitution forms, open < ext,
   open == ext, BLOSUM62, a PSSM and scores beyond int8, and on pairs
   with an empty side (which must also equal golden): exact equality;
3. golden: 16 sampled pairs of the 8,192-pair BLOSUM62 batch against the
   scalar golden oracle;
4. the score path through the public API on the default device: SW
   BLOSUM62 on 8,192 protein pairs of 140-160 residues, one profile
   against 16,384 references, one 150 bp NW DNA pair, and 128 DNA pairs
   of 2,000 bp.  Every kernel's launches are counted from zero over this
   phase only; the short form's score class must launch three times and
   the block kernel's one-shot form not at all, every route must be
   "cuda_kernel" (the 2,000 bp batch: "cuda_segments", on the packed
   score form, ``SEGMENT16_LAUNCHES``, and not on the int32 one), and
   the scores must equal the plain version's;
5. timings of the score path: the short form's score class (K1a), the
   block kernel's one-shot form and the plain version at the headline
   shape and on phase 3's 8,192 table-form pairs (CUDA-event medians,
   after warm-up) beside the bound, and the end-to-end ``align_batch``
   time of the 8,192 pairs and ``Aligner.align`` of the 150 bp pair,
   beside the card's name and power limit;
6. trace kernel and walk kernel vs plain: the trace class of the kernel
   against its plain version on batches drawn like phase 2's, the
   empty-side pairs
   and cfg4b's 4,096-pair shape (scalars and every flag cell), and the
   walk kernel (the tiled walk) against its plain version on those
   planes (opcode rows and begin cells): exact equality;
7. the trace + CIGAR path through the public API: ``align_cigars`` of
   cfg4b (4,096 SG BLOSUM62 11/1 protein pairs of 140-160 residues), and
   ``use_trace()`` + ``align_batch`` + ``Aligner.cigars`` on the same
   pairs.  Launches are counted from zero over this phase only; the
   trace and walk kernels must launch, every route must be
   "cuda_kernel", and the two paths' CIGARs and scalars must be equal;
8. golden: 16 sampled pairs of phase 7 against golden's alignment and
   walk (score, end cell, CIGAR);
9. timings of the trace path: trace kernel, walk kernel (a call, on the
   4,096 pairs and on a 512-pair chunk; the kernel alone in phase 29)
   and their plain versions at cfg4b's shape, ``align_cigars`` end to end with its stage
   clocks and at one chunk of 4,096 pairs, ``use_trace()`` +
   ``cigars()`` end to end, and the peak device memory;
10. stats and plane forms vs plain: the kernel's stats, table,
   stats_table, rowcol and stats_rowcol classes against their plain
   version (the wavefront) on phase 2's small batches (with query letters
   beside the profile forms), on the empty-side pairs (which must also
   equal golden's payloads), on bench.py's stats headline (the headline
   profile with letters from numpy seed 3, SW 11/1, width sat) and on 512
   BLOSUM62 pairs of 1-192 residues: exact equality of the scalars and of
   every plane cell;
11. the stats, table and rowcol path through the public API:
   ``use_stats()`` + ``align_batch`` of phase 3's 8,192 SW pairs,
   ``semi_global().use_stats()`` on cfg4b's 4,096 pairs at 11/1 and at
   2/2, ``use_last_rowcol()`` with and without stats on the 8,192 pairs
   and ``use_table()`` with and without stats on 512 of them.  Launches
   are counted from zero over this phase only; every class must launch
   the short form and nothing the block kernel's or a banded form, every
   route must be "cuda_kernel", and every result must equal the plain
   version's;
12. golden: 16 sampled pairs of each phase-11 case against golden's
   stats, tables, rows and columns;
13. timings: the stats kernel and its plain version at the headline (and
   the score kernel beside it, and the stats kernel on 2,048 of its
   pairs), each plane class (K1d) on the short form, on the block
   kernel's one-shot form and plain at the 512-pair batch beside its
   bound, ``use_stats()`` ``align_batch`` of the 8,192 pairs with its
   stage clocks, ``use_last_rowcol()`` with and without stats on them,
   SG stats on cfg4b's pairs, and the peak device memory of the table
   phase;
14. banded kernel vs plain: every class of the banded mode (K1e; the
   score class sweeps the band alone on the ring where it reaches, every
   other launch every cell, masked, on the short form or past 256 query
   rows the block kernel) against its plain version (the wavefront with
   ``banded=True``), the
   trace class's plane also walked by the walk kernel and its plain
   version, on 256-pair DNA batches at 4/1, 2/2 and 1/3 and a BLOSUM62
   batch at 11/1, lengths from 0 (so empty sides and corners or end rows
   outside the band occur): the NW score form at bands 0, 3, 16, 64 and
   4,096, every class x NW, SG (the nine free-end sets in turn) and SW at
   one of them in turn; and every class x NW, SG and SW on the empty-side
   and unreachable-corner pairs of the banded repair, whose NW scores must
   also equal golden's banded oracle (-2^30 where it has none); every
   class x NW, SG and SW on 32 DNA pairs of 200-300 x 40-120 letters
   (Qp 304, numpy seed 14) at bw 5, 64 or 200, whose masked launches
   must all be the block kernel's: exact equality;
15. the banded path through the public API: ``banded_nw_batch`` of phase
   3's 8,192 BLOSUM62 pairs, NW 11/1, bandwidth 16, counted from zero:
   the banded warp form (K1e's score class, a ring of row blocks,
   ``csrc/scan_banded.cu``) must launch on "cuda_kernel" and no masked
   sweep, equal the plain version and the score class's masked sweep
   (forced), and 16 sampled pairs golden's banded oracle; the warp form
   at every (G, kR) it has, at the widest band each reaches, against the
   plain version, and one past it refused; ``banded_nw_batch`` of 64 DNA
   pairs of 700-1,000 bp at bw 200, past the ring's reach, on the block
   kernel's masked sweep (``csrc/scan_chunked_banded.cu``) alone, equal
   to plain and timed; then the warp form and the masked sweep (a call by
   CUDA events; the kernels alone in phase 29), the plain version and
   the unbanded score kernel on cfg2, and ``banded_nw_batch`` end to end.
   Then the banded slice on the same 8,192 pairs (Qp = Rp = 192),
   counted from zero: every class x NW, SG (all ends free) and SW through
   ``dispatch.launch(banded=True)``, each once, on "cuda_kernel": the
   score class 3 launches on the ring, every other class 3 on the short
   form's masked sweep (``csrc/scan_short_banded.cu``), none on another
   form; the first 1,024 pairs of each equal to the plain version, the
   trace planes walked by the walk kernel as by the plain walk, the peak
   device memory of each call; then each class and mode timed
   (CUDA-event medians) beside its plain version (NW, one run) and its
   bounds over the band's cells and over every cell; and
   ``banded_nw_batch`` of 128 DNA pairs of 4,096 bp at bw 64, NW 5/1 (the
   long-read banded path) on the warp form, its first 8 pairs equal to
   the plain version and all 128 to the block kernel's masked sweep
   (forced), both forms timed, the call end to end with its stage
   clocks;
16. ``align_many``, counted from zero: cfg5 (256 DNA pairs of 100-2,000
   bp, SW 5/2) equal to ``align_batch`` and to plain, a ``use_stats()``
   and a ``use_trace()`` batch equal to ``align_batch``, and 128 DNA
   pairs of 4,096 bp (SW 5/1; cfg6 at a quarter of its length), whose
   first 16 pairs must equal plain; the bins of long pairs take the
   segment kernel (the score class its packed form); then cfg5 end to end (binned, with stage clocks and
   GCUPS; unbinned; with more bins);
17. SSW, counted from zero: ``ssw_batch`` of 1,024 of the BLOSUM62 pairs
   at 11/1, one pass and ``windowed=True``, and a profile at score_size 0
   and 2, on "cuda_kernel" and equal to the same calls on the CPU, 16
   sampled pairs equal to golden's SW and walk; then both passes timed;
18. segment kernel vs plain: ``score_segment`` chained over 2-5 segments
   against ``score_segment_plain`` chained the same way and against the
   one-shot ``score_align``, for the score, stats and trace classes x NW,
   the nine SG free-end sets and SW x 11/1, 2/2 and 1/3, on 64 pairs of
   0-70 by 0-200 letters (so empty sides, ragged stripes and pairs that
   end in an earlier segment occur): exact equality of every output, flag
   cell and state row;
19. the long-pair path through the public API, counted from zero: cfg6 at
   full width (128 DNA pairs of 16,384 bp, SW 5/1) through
   ``align_batch``, its first four pairs equal to the plain column
   sweep; then 128 DNA pairs of 50-4,096 bp (Qp = Rp = 4,096) through
   ``align_batch`` with the score class, ``use_stats()`` and
   ``use_trace()`` (a 2 GiB plane, streamed out in segments): every
   route "cuda_segments", the score class on the packed form (no pair
   flagged, so no int32 score launch), stats and trace on the int32
   form, every output
   equal to the block kernel's one-shot form on the same pairs (one
   launch of the same block: a check of the chain, whose plain version
   phase 20 holds at this shape), and the short pairs equal to golden
   (score, end cell, stats, flags, CIGAR);
20. timings of the segment kernel, beside the card's name and power
   limit: cfg6 end to end and as a chain of launches, 128 x 1,024 bp
   through the block kernel's one-shot form and the segment kernel, 128
   x 4,096 bp through the segment kernel and its packed score form (held
   to the same plain version), the stats and
   trace classes on 128 x 4,096 bp with their plain versions (whose
   outputs the segment kernel's must equal at this shape too), the trace
   class end to end with its stage clocks against its kernels alone
   (the copy overlap), each path's peak device memory, and bench.py's
   headline batch through the segment kernel;
21. tile kernel vs plain: ``score_rowseg`` chained in superstep order
   over S x D tiles against ``score_segment`` chained over the same
   column shards and the one-shot ``score_align``, for the score, stats
   and trace classes x NW, the nine SG free-end sets and SW x 11/1, 2/2
   and 1/3, on 64 pairs of 0-192 by 0-192 letters, D in {1, 3, 4},
   q_chunk in {24, 32, 64}, 1-8 warps a pair; and, for every mode and
   class at one of the penalty pairs in turn, against
   ``score_rowseg_plain`` chained the same way: exact equality of every
   output, right-going state, down-state row and flag cell of every tile;
22. the sequence-parallel path through ``dist.seqpar_align_scan`` on the
   card, counted from zero: cfg6 at full width (128 DNA pairs of 16,384
   bp, SW 5/1) over 4 virtual shards of 4,096 columns and row chunks of
   2,048: 32 tiles, which must be 32 launches, equal to ``align_batch``
   of the same pairs (the segment kernel) and its first four pairs to the
   plain column sweep; then the 128 pairs of 50-4,096 bp with stats and
   with trace (a 2 GiB plane over four shards, row chunks of 1,024):
   equal to the one-shot kernel's outputs and flags, ``seqpar_cigars``
   equal to ``align_cigars``, the short pairs equal to golden;
23. data parallelism on the card, in a process group of ONE rank (NCCL
   puts one rank on a device, so one card shows that this layer is
   correct, not that it scales): ``sharded_align`` and ``align_global`` of
   phase 3's 8,192 SW BLOSUM62 pairs, score and stats, on "cuda_kernel"
   and equal to ``align_batch``;
24. timings of the tile kernel, beside the card's name and power limit:
   cfg6's 32 tiles through ``seqpar_align_scan`` (CUDA events and end to
   end) beside the segment kernel's two launches on the same pairs, one
   tile of each class at the main path's shape beside its plain version
   (whose outputs it must equal there too), the stats and trace classes
   at 4,096 bp, and the peak device memory;
25. chunked sweep vs plain: ``score_chunked`` (kernel K1f, the block
   kernel over all of a pair's columns, which ``score_align`` launches
   itself past 256 rows) for all seven classes x NW, the nine SG
   free-end sets and SW x 11/1, 2/2 and 1/3, on 64 pairs of 0-600 by
   0-200 letters at Qp = 608 (one to three groups of 256 rows, empty
   sides, ragged stripes), 1, 3 and 8 warps and the launcher's pick,
   against the plain version at every penalty pair (the seven classes'
   plain outputs from its stats_table and trace calls on each input,
   held to each class's own plain call at the first); then every class
   on 16 pairs at 3,072 x 96 against the plain version: exact equality
   of every scalar, plane cell, row and column;
26. the long one-shot path through the public API, counted from zero, on
   the long mixed batch (120 DNA pairs of 1,024-4,096 bp and 8 of 50-200
   bp, Qp = Rp = 4,096): ``align_cigars`` at SW 5/1 and SG 11/1,
   ``ssw_batch``, ``use_last_rowcol()`` with and without stats, and
   ``use_table()`` with and without stats on 16 of the pairs (the stats
   classes also at 2,048 bp).  Every batch of long pairs must take
   "cuda_chunked" (only the short pairs' bins "cuda_kernel", which a
   recorder of ``dispatch.score_align``'s shapes checks), the chunked
   sweep must launch;
   CIGARs and scalars must equal ``use_trace()`` + ``cigars()`` on the
   segment route, SSW ``align_cigars``, the planes, rows and columns of
   4 of the pairs ``score_align_plain``'s at Qp = Rp = 4,096 and (the
   stats classes) 2,048, and the short pairs golden;
27. timings of the chunked sweep, beside the card's name and power limit:
   each class at 128 x 4,096 (the tables 16 x 4,096), 128 x 1,024 and
   128 x 3,072 x 96, and below the route's thresholds at 128 x 512 x 512
   and 128 x 2,048 x 96, with the peak device memory of one call; the
   score class on the headline batch beside the short form; the trace
   class on the long mixed batch beside its plain version;
   ``align_cigars`` of that batch end to end with its stage clocks and
   peak memory; the forms' registers;
28. the short form (K1a-K1d) vs plain: the trace and stats classes of
   ``score_align`` on phase 2's small batches and the empty-side pairs;
   every class on 256 pairs at Qp x Rp = 24 x 24 (stats payloads
   [m | s | l] in one word), 16 x 1,100 ([m | s] and l), 128 x 96 (4
   rows a lane), 129 x 96 and 130 x 64 (5), 186 x 64 and 192 x 64 (6),
   193 x 64, 250 x 64 and 256 x 64 (8) and 300 x 64 (past 256 rows: the
   block kernel's one-shot form), the plane classes' stores whole
   vectors, pairs of words or word by word by Qp, trace and stats in
   three modes and the other classes in one in turn; every class on one
   pair of 192 x 192 (one warp); align_cigars' 512-pair chunk of cfg4b,
   ssw_batch's 1,024 SW pairs and 1,024 pairs of the stats headline; the
   trace planes walked by the walk kernel and its plain version; the
   form the rule picks (``scan_kernel.short_plan``) must be the one the
   counters show ran, and everything equal to the plain version.  Then,
   counted from zero each: ``align_cigars`` of cfg4b, ``ssw_batch`` of
   1,024 BLOSUM62 pairs, ``align_batch`` of phase 3's 8,192 pairs with
   the score class, ``use_stats()`` and ``use_last_rowcol()``,
   ``Aligner.align`` of a 150 bp pair and ``use_table()`` +
   ``use_stats()`` on 512 of the pairs must launch the short form, not
   the block form, and no banded form, by the launch counters;
29. timings of the short form, beside the card's name and power limit:
   K1b's 512-pair chunk of cfg4b, the whole 4,096 pairs and ssw_batch's
   1,024 pairs, K1c's stats headline, K1a's score headline and K1d's
   four classes at phase 13's 512-pair batch, the short form against
   the block kernel's one-shot form on the same inputs, a call by CUDA
   events and the kernel alone by torch.profiler's device time;
   ``align_cigars`` of cfg4b and ``use_stats()`` ``align_batch`` of the
   8,192 pairs end to end with their stage clocks; the short forms'
   registers and spills (none allowed; the masked forms' too); then, by
   torch.profiler, the banded warp form and the score class's masked
   sweep on phase 15's cfg2 and long batches, the block kernel's masked
   sweep on its bw 200 batch, each other banded class (NW) on cfg2 on
   the short form's masked sweep, and the tiled walk (a warp a pair, ``csrc/trace_walk.cu``) on
   phase 9's cfg4b planes, the 4,096 pairs and a 512-pair chunk
   (torch.profiler is used from this phase on only);
30. the walk on long global paths: 16 DNA pairs of 4,096 bp, each query
   its reference with 10% of the letters redrawn (numpy seed 30), NW
   5/1, the chunked sweep's trace (K1f) then the tiled walk, counted from
   zero; 2 pairs equal to the plain walk, every walk beginning at (0,
   0); the walk timed by CUDA events and torch.profiler;
31. ``StreamingAligner`` on the card: cfg7 (bench.py's stream, 16,384 SW
   BLOSUM62 11/1 protein pairs of 140-160 residues, numpy seed 31,
   ``submit_many`` + ``flush`` at flush 8,192), counted from zero: only
   the short form's score class may launch, once for each bucket the
   flush rule makes (3: the 2^28-cell cap holds a (192, 192) bucket to
   7,281 pairs), every route "cuda_kernel", every field equal to
   ``align_batch`` and 16 sampled pairs to golden; its end-to-end time
   (median of 5, the results read) beside ``align_batch`` of the same
   pairs and the stream's stage clocks; a mixed stream of 2,000 pairs of
   50-250 residues submitted one at a time at flush 1,024, topped up with
   cfg7 pairs until its (192, 192) bucket fills, which must resolve
   without ``flush()`` while the other buckets wait, ``result()`` of a
   partial bucket's handle launching that bucket alone; ``use_stats()``
   (4,096 pairs), ``use_trace()`` (512, CIGARs also against
   ``align_cigars``) and ``use_table()`` (64) streams, a bucket of 8
   DNA pairs of 4,096 bp on "cuda_segments" (the packed score form), and
   8 SW pairs of 1.5-3 kbp, three of them identical, whose scores leave
   the packed form's band (the fetch thread reruns them under the
   stream's lock; scores and ends equal to the int32 form's), each equal
   to ``align_batch``; then ``utils.profiling.capture`` around one
   ``align_batch`` of 8,192 of the pairs and one cfg7 run, whose Chrome
   trace (under ``chiprun_out/phase31_trace/``) must hold the
   ``pt.execute.sw.score`` region, with the kernel events and the card's
   busy share of each window logged;
32. the fuzzer on the card (``tools/fuzz_torch.py``, counted from zero):
   ``fuzz_torch.run("cuda", FUZZ_DRAWS, FUZZ_SEED, cover=True)``, its
   nine API checks once each and then a draw aimed at every kernel form
   the sources compile (the short form's 80, the ring's 24, the block
   kernel's 39 in its one-shot, masked, segment and tile entries, the
   walk) and every plan axis (the short form's substitution, the block
   kernel's 1-8 warps and 1-8 blocks a cluster, the walk's two copy
   paths), then random draws: every public call also on the CPU's plain
   versions and golden, every launch held to its plain version on the
   same tensors and a sample of pairs to golden, each draw's launches to
   what the launchers' rules say.  Every compiled form must be reached
   with no mismatch (a repro goes to ``chiprun_out/phase32_repro.json``).
   Then ``entry.entry()`` on the card (the short form's score class,
   equal to plain) and ``entry.dryrun_multichip(1)`` (one NCCL process:
   ``sharded_align`` / ``align_global`` in four classes and
   ``seqpar_align_scan`` in three, against golden).
33. the packed score form (``csrc/scan_segment16.cu``, two pairs a lane
   on 16x2 DPX) against the int32 form of the block kernel: chained
   segments of seeded batches (odd B, ragged lengths, empty sides) in NW,
   the nine SG sets and SW, the pair table (ACGT), a protein table and
   one query's profile, each rows-a-lane and cluster form, with resume:
   every output and state row equal and no pair flagged; pairs built to
   leave the 16-bit band (SW of identical 3 kbp sequences, NW borders
   past -32,768) flagged, recomputed at fetch and equal to the int32
   form through ``dispatch.execute``, the counters with them; then the
   packed and the int32 form timed side by side (CUDA events, and the
   kernels' device time) on 128 pairs of 4,096 bp and of 10 kbp, and the
   forms' registers and spills.  ``python3 chip_smoke.py --only packed``
   runs the build and this phase alone.

The line before the last is the card's name and power limit, the one
before it a JSON summary of every kernel (launches on its main path,
error, times, and the least time the card could take: ``bound``; the
score, trace, stats and plane rows are the short form's, with phase
29's kernel times beside the block form's; the segment kernel's score
row is the int32 form, which the main path launches only for the pairs
the packed form flags, and the packed form has a row of its own, timed
beside it at phase 20's shape); the last line is
``{"ok": true, "device": {...}}``.  Imports no JAX and nothing of the
JAX package.
"""

from __future__ import annotations

import collections
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PROTEIN = b"ARNDCQEGHILKMFPSTWYV"
DNA = b"ACGT"
SG_FREE = [(True, False, False, False), (False, True, False, False),
           (True, True, False, False), (False, False, True, False),
           (False, False, False, True), (False, False, True, True),
           (True, False, False, True), (False, True, True, False),
           (True, True, True, True)]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def random_seqs(rng, alphabet: bytes, n: int, lo: int, hi: int) -> list:
    """n sequences with lengths in [lo, hi], letters drawn uniformly."""
    alpha = np.frombuffer(alphabet, np.uint8)
    lens = rng.integers(lo, hi + 1, size=n)
    body = alpha[rng.integers(0, len(alpha), size=(n, hi))]
    return [body[k, :lens[k]].tobytes() for k in range(n)]


PLANE_CLASSES = ("stats", "table", "stats_table", "rowcol", "stats_rowcol")
STATS_CLASSES = ("stats", "stats_table", "stats_rowcol")
# the classes with block-kernel forms of 8 rows a lane
WIDE_CLASSES = ("score", "rowcol")

# The card's peaks for the bounds (NVIDIA H100 SXM data sheet): 3.35 TB/s
# of device memory; 67 TFLOP/s of float32 outside the tensor cores, that
# is 33.5 T fused multiply-adds a second on 128 float32 lanes an SM, and
# the SM's 64 int32 lanes issue half as many integer operations.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12
# int32 operations of one cell: E and F two subtractions and a max each,
# the diagonal's addition, two max for H and SW's clamp; the trace class
# adds the comparisons and ors of three flags, the stats classes the
# comparisons and selects of three payloads.
OPS_PER_CELL = {"score": 10, "trace": 16, "stats": 22, "table": 10,
                "stats_table": 22, "rowcol": 10, "stats_rowcol": 22}
# the walk: a flag test, two index updates, an opcode and a store a step
OPS_PER_WALK_STEP = 8


def bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take for the work: the larger of
    its int32 operations over the int32 rate and its bytes (each input
    read once, each output written once) over the memory rate.  No single
    PyTorch call computes an affine-gap sweep or a traceback, so
    ``library_ms`` is null."""
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def sweep_bound(cls: str, args, kw, cells: int | None = None,
                lanes: int = 1) -> dict:
    """bound() of one sweep of class ``cls`` over score_align's inputs:
    the pairs' real cells (``cells``: a banded batch's cells inside the
    band), the input tensors, the scalars and the class's planes (every
    padded cell, whatever the band); ``lanes``: cells an operation
    computes (2 for the packed form's 16x2 instructions)."""
    ridx, qlen, rlen = args
    B, Rp = ridx.shape
    subs = [kw.get(k) for k in ("table", "qidx", "profile")]
    Qp = (kw["profile"] if kw.get("profile") is not None
          else kw["qidx"]).shape[1]
    if cells is None:
        cells = int((qlen.long() * rlen.long()).sum().item())
    nbytes = sum(t.numel() * t.element_size()
                 for t in (ridx, qlen, rlen, *subs) if t is not None)
    n = 4 if cls in STATS_CLASSES else 1
    nbytes += (8 if cls in STATS_CLASSES else 5) * B * 4
    if cls == "trace":
        nbytes += B * Qp * Rp
    elif cls in ("table", "stats_table"):
        nbytes += n * B * Qp * Rp * 4
    elif cls in ("rowcol", "stats_rowcol"):
        nbytes += n * B * (Qp + Rp) * 4
    return bound(cells * OPS_PER_CELL[cls] / lanes, nbytes)


def max_abs_diff(a: dict, b: dict) -> int:
    if set(a) != set(b):
        raise AssertionError(f"output keys differ: {sorted(a)} {sorted(b)}")
    return max(int((a[k].long() - b[k].long()).abs().max().item())
               if a[k].numel() else 0 for k in a)


def compare(torch, tk, name, args, kw) -> int:
    """Kernel vs plain on the same device tensors; raises unless equal."""
    got = tk.score_align(*args, **kw)
    want = tk.score_align_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max_abs_diff(got, want)
    if err != 0:
        raise AssertionError(f"kernel != plain on {name}: max |diff| {err}")
    return err


def compare_trace(torch, tk, tw, name, args, kw, qsym, rsym):
    """Trace kernel vs plain, then walk kernel vs plain on the kernel's
    plane; raises unless equal.  Returns (trace error, walk error)."""
    kw = {**kw, "outputs": "trace"}
    got = tk.score_align(*args, **kw)
    want = tk.score_align_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max_abs_diff(got, want)
    if err != 0:
        raise AssertionError(f"trace kernel != plain on {name}: max |diff| "
                             f"{err}")
    walk = (got["trace_table"], qsym, rsym, got["end_query"],
            got["end_ref"], kw["mode"], kw["free"])
    w_got = tw.device_walk(*walk)
    w_want = tw.device_walk_plain(*walk)
    torch.cuda.synchronize()
    werr = max_abs_diff(dict(zip("obr", w_got)), dict(zip("obr", w_want)))
    if werr != 0:
        raise AssertionError(f"walk kernel != plain on {name}: max |diff| "
                             f"{werr}")
    return err, werr


# qlen == 0 or rlen == 0 (default DNA matrix, open 5, ext 2), and golden's
# (score, end_query, end_ref) for them; golden's SW cannot index an empty
# grid, and its empty local alignment is 0 at (0, 0)
EMPTY_QS = [b"", b"ACGT", b"ACGTACGTACGTACGTACGTACGTACGTAC", b""]
EMPTY_RS = [b"ACGT", b"", b"ACGTAC", b""]
EMPTY_WANT = {
    "nw": [(-11, -1, 3), (-11, 3, -1), (-45, 29, 5), (0, -1, -1)],
    "sg": [(0, -1, 0), (0, 0, -1), (6, 5, 5), (0, -1, -1)],
    "sw": [(0, 0, 0), (0, 0, 0), (6, 5, 5), (0, 0, 0)],
}


def empty_side_cases(torch, dev):
    """The empty-side pairs as (name, (args, subs), kwargs, want)."""
    from parasail_rs_tpu_torch.matrices import Matrix

    m = Matrix.default()
    P = 32
    qidx = np.full((len(EMPTY_QS), P), -1, np.int32)
    ridx = np.zeros((len(EMPTY_RS), P), np.int32)
    for b, (q, r) in enumerate(zip(EMPTY_QS, EMPTY_RS)):
        qidx[b, :len(q)] = m.encode(q)
        ridx[b, :len(r)] = m.encode(r)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    args = (t(ridx), t([len(q) for q in EMPTY_QS]),
            t([len(r) for r in EMPTY_RS]))
    subs = {"table": t(m.data), "qidx": t(qidx)}
    return [(f"empty side {mode}", (args, subs),
             dict(mode=mode, free=(mode != "nw",) * 4, open_=5, ext=2,
                  width="sat"), EMPTY_WANT[mode])
            for mode in ("nw", "sg", "sw")]


def small_cases(rng, torch, dev):
    """Seeded ragged batches (128 pairs, lengths < 32), as
    (name, args, kwargs) for score_align."""
    from parasail_rs_tpu_torch.matrices import Matrix

    B, Qp, Rp = 128, 32, 32

    def t(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    def lengths():
        return (rng.integers(1, 31, size=B).astype(np.int32),
                rng.integers(1, 31, size=B).astype(np.int32))

    def letters(lens, A, P, fill):
        x = np.full((len(lens), P), fill, np.int32)
        for b, n in enumerate(lens):
            x[b, :n] = rng.integers(0, A, size=n)
        return x

    def table_batch(A=25, lo=-4, hi=8, table=None, shared=False):
        table = (rng.integers(lo, hi, size=(A, A)).astype(np.int32)
                 if table is None else table)
        A = table.shape[0]
        ql, rl = lengths()
        if shared:
            ql[:] = ql[0]
        qidx = letters(ql[:1] if shared else ql, A, Qp, -1)
        return (t(letters(rl, A, Rp, 0)), t(ql), t(rl)), \
            {"table": t(table), "qidx": t(qidx)}

    def profile_batch(A=25, lo=-4, hi=12, shared=False, rows=None):
        ql, rl = lengths()
        if shared:
            ql[:] = ql[0]
        if rows is None:
            rows = rng.integers(lo, hi, size=(1 if shared else B, Qp, A))
        A = rows.shape[-1]
        return (t(letters(rl, A, Rp, 0)), t(ql), t(rl)), \
            {"profile": t(rows.astype(np.int32))}

    sw = dict(mode="sw", free=(True,) * 4)
    nw = dict(mode="nw", free=(False,) * 4)
    blosum = Matrix.from_name("blosum62")
    pssm = Matrix.create_pssm(DNA, rng.integers(-3, 6, size=40 * 4), 40)
    pssm_rows = pssm.data[np.arange(Qp) % pssm.length][None]
    cases = [("nw", table_batch(), dict(nw, open_=11, ext=1, width="sat")),
             ("sw", table_batch(), dict(sw, open_=11, ext=1, width="sat"))]
    for f in SG_FREE:
        cases.append((f"sg{tuple(int(x) for x in f)}", table_batch(),
                      dict(mode="sg", free=f, open_=5, ext=2, width="sat")))
    for w in ("8", "16", "32", "sat", "64"):
        cases.append((f"width {w}", profile_batch(lo=-20, hi=60),
                      dict(sw, open_=11, ext=1, width=w)))
    cases += [
        ("width sat, 16-bit saturating", profile_batch(lo=-200, hi=2400),
         dict(sw, open_=11, ext=1, width="sat")),
        ("table, per-pair query", table_batch(),
         dict(mode="sg", free=(True, False, False, True), open_=10, ext=1,
              width="sat")),
        ("table, shared query", table_batch(shared=True),
         dict(nw, open_=4, ext=2, width="sat")),
        ("shared profile", profile_batch(shared=True),
         dict(sw, open_=11, ext=1, width="sat")),
        ("per-pair profile", profile_batch(),
         dict(mode="sg", free=(False, True, True, False), open_=11, ext=1,
              width="sat")),
        ("open < ext (1, 3) nw", table_batch(),
         dict(nw, open_=1, ext=3, width="32")),
        ("open < ext (2, 5) sw", table_batch(),
         dict(sw, open_=2, ext=5, width="32")),
        ("open == ext (2, 2) nw", table_batch(),
         dict(nw, open_=2, ext=2, width="32")),
        ("open == ext (0, 0) sg", table_batch(),
         dict(mode="sg", free=(True,) * 4, open_=0, ext=0, width="32")),
        ("blosum62", table_batch(table=blosum.data.astype(np.int32)),
         dict(sw, open_=11, ext=1, width="sat")),
        ("pssm", profile_batch(shared=True, rows=pssm_rows),
         dict(sw, open_=5, ext=2, width="sat")),
        ("scores beyond int8", table_batch(lo=-300, hi=400),
         dict(sw, open_=11, ext=1, width="sat")),
        ("alphabet of 40", table_batch(A=40),
         dict(nw, open_=11, ext=1, width="16")),
    ]
    return cases


def headline_inputs(torch, dev):
    """bench.py's headline: 8,192 pairs of 150 residues padded to 160, a
    numpy seed-0 (B, 160, 25) profile in [-4, 12), random letters."""
    B, L, A, Qp, Rp = 8192, 150, 25, 160, 160
    rng = np.random.default_rng(0)
    profile = rng.integers(-4, 12, size=(B, Qp, A)).astype(np.int32)
    ridx = rng.integers(0, A, size=(B, Rp)).astype(np.int32)
    qlen = np.full(B, L, np.int32)
    rlen = np.full(B, L, np.int32)
    args = tuple(torch.from_numpy(x).to(dev) for x in (ridx, qlen, rlen))
    kw = dict(open_=11, ext=1, mode="sw", free=(True,) * 4, width="sat",
              profile=torch.from_numpy(profile).to(dev))
    return args, kw


def time_cuda(torch, fn, reps=7, warmup=2) -> float:
    """Median milliseconds of fn() over reps runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def reset_launches(tk, tw) -> None:
    """Set every kernel's launch count to 0, to count one phase's work."""
    tk.SEGMENT_LAUNCHES = tk.SEGMENT16_LAUNCHES = 0
    tk.ROWSEG_LAUNCHES = tk.CHUNKED_LAUNCHES = tw.LAUNCHES = 0
    tk.SHORT_LAUNCHES = dict.fromkeys(tk.SHORT_LAUNCHES, 0)
    reset_banded_launches(tk)


def plan_note(tk, cls, B, Qs, ncols, A, profile=False) -> str:
    """The block kernel's form for a launch: rows a lane, warps a block and
    blocks a pair, as its launcher takes them (``scan_kernel.block_plan``)."""
    r, w, c = tk.block_plan(cls, B, Qs, ncols, A, profile)
    return f"R {r}, {w} warps, C {c}"


# (rows a lane, blocks a pair) forced in turn in the block kernel's checks;
# (0, 0) is the launcher's pick; only the score and rowcol classes have
# forms of 8 rows a lane, the others stop at 4
BLOCK_FORMS = ((0, 0), (2, 1), (4, 2), (8, 3), (4, 8), (8, 1), (2, 4))


def force_form(tk, cls, warps, form) -> str:
    """Set the block kernel's warps, rows a lane and cluster for a check;
    returns the form's name."""
    rows, cluster = form
    if cls not in WIDE_CLASSES and rows == 8:
        rows = 4
    tk.SEGMENT_WARPS, tk._LANE_ROWS, tk._CLUSTER = warps, rows, cluster
    return f"warps {warps} R {rows} C {cluster}"


def unforce(tk) -> None:
    tk.SEGMENT_WARPS = tk._LANE_ROWS = tk._CLUSTER = 0


def time_host(fn, reps=5, warmup=1) -> float:
    """Median milliseconds of fn() on the host clock (fn returns host
    results, so the device work is inside the window)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def plain_of(tk, aligner, queries, references) -> dict:
    """The plain version's outputs on the batch the aligner packs."""
    batch, _, _ = aligner._pack(queries, references)
    subs = ({"table": batch.table, "qidx": batch.qidx}
            if batch.table is not None else {"profile": batch.profile})
    width = {"64": "32"}.get(aligner.key.width, aligner.key.width)
    out = tk.score_align_plain(
        batch.ridx, batch.qlen_t, batch.rlen_t, open_=aligner.gap_open,
        ext=aligner.gap_extend, mode=aligner.key.mode, free=aligner.key.free,
        width=width, **subs)
    return {k: v.cpu().numpy() for k, v in out.items()}


def check_against_plain(name, alignments, plain) -> None:
    got = np.array([(a.get_score(), a.get_end_query(), a.get_end_ref(),
                     a.is_saturated()) for a in alignments], np.int64)
    want = np.stack([plain["score"], plain["end_query"], plain["end_ref"],
                     plain["saturated"]], axis=1).astype(np.int64)
    if not np.array_equal(got, want):
        bad = int(np.nonzero((got != want).any(axis=1))[0][0])
        raise AssertionError(
            f"{name}: pair {bad} {got[bad].tolist()} != plain "
            f"{want[bad].tolist()}")


def main(argv=None) -> int:
    import torch

    only = None
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--only"] and argv[1:2] == ["packed"]:
        only = "packed"
    elif argv:
        log(f"chip_smoke: unknown arguments {argv}; use --only packed")
        return 2

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is "
            "False); nothing was run")
        return 2
    if not os.path.isdir(os.path.join(HERE, "parasail_rs_tpu_torch")):
        log("chip_smoke: run it from a checkout of the repository "
            "(parasail_rs_tpu_torch/ is missing)")
        return 2
    sys.path.insert(0, HERE)
    import parasail_rs_tpu_torch as pt
    from parasail_rs_tpu_torch.engine import dispatch
    from parasail_rs_tpu_torch.golden import model as golden
    from parasail_rs_tpu_torch.ops import _build
    from parasail_rs_tpu_torch.ops import scan_kernel as tk
    from parasail_rs_tpu_torch.ops import trace_walk as tw
    from parasail_rs_tpu_torch.utils import stages

    dev = torch.device("cuda")
    card = card_info()
    start = time.perf_counter()

    def clock(phases):
        log(f"[clock] phases {phases} done, {time.perf_counter() - start:.1f}"
            f" s since the start")

    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"[1 build] ok: {os.path.relpath(path, HERE)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        f"{'ran' if _build.BUILD_SECONDS is not None else 'cached'})")
    for line in _build.BUILD_LOG.splitlines():
        if "entry function" in line or "registers" in line or \
                "spill" in line:
            log(f"[1 build] {line.strip()}")
    if only == "packed":
        res = packed_path(torch, pt, tk, dispatch, stages, card,
                          _build.BUILD_LOG)
        print(json.dumps({"packed": res}), flush=True)
        print(card, flush=True)
        return 0

    # -- 2. kernel vs plain --------------------------------------------------
    rng = np.random.default_rng(1)
    head_args, head_kw = headline_inputs(torch, dev)
    max_err = compare(torch, tk, "headline", head_args, head_kw)
    log("[2 kernel vs plain] headline B=8192 Qp=Rp=160 A=25 SW 11/1 sat: "
        "equal")
    for name, (args, subs), kw in small_cases(rng, torch, dev):
        max_err = max(max_err, compare(torch, tk, name, args, {**kw, **subs}))
        log(f"[2 kernel vs plain] {name}: equal")
    for name, (args, subs), kw, want in empty_side_cases(torch, dev):
        max_err = max(max_err, compare(torch, tk, name, args, {**kw, **subs}))
        out = tk.score_align(*args, **kw, **subs)
        got = [tuple(int(out[k][b]) for k in ("score", "end_query",
                                              "end_ref"))
               for b in range(len(want))]
        if got != want:
            raise AssertionError(f"{name}: kernel {got} != golden {want}")
        log(f"[2 kernel vs plain] {name}: equal, and equal to golden")

    # -- 3. golden spot check ------------------------------------------------
    blosum = pt.Matrix.from_name("blosum62")
    qs = random_seqs(rng, PROTEIN, 8192, 140, 160)
    rs = random_seqs(rng, PROTEIN, 8192, 140, 160)
    sw = (pt.Aligner.new().matrix(blosum).gap_open(11).gap_extend(1)
          .local().build())
    batch, _, _ = sw._pack(qs, rs)
    out = tk.score_align(batch.ridx, batch.qlen_t, batch.rlen_t, open_=11,
                         ext=1, mode="sw", free=(True,) * 4, width="sat",
                         table=batch.table, qidx=batch.qidx)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    for b in rng.choice(len(qs), size=16, replace=False).tolist():
        g = golden.align_seqs(qs[b], rs[b], blosum, 11, 1, "sw")
        got = (int(out["score"][b]), int(out["end_query"][b]),
               int(out["end_ref"][b]))
        if got != (g.score, g.end_query, g.end_ref):
            raise AssertionError(f"pair {b}: kernel {got} != golden "
                                 f"{(g.score, g.end_query, g.end_ref)}")
    log("[3 golden] 16 sampled pairs of the BLOSUM62 batch: equal")

    # -- 4. the main path through the public API ------------------------------
    query = qs[0]
    prof = pt.Profile.new(query, False, blosum)
    pa = (pt.Aligner.new().profile(prof).gap_open(11).gap_extend(1).local()
          .scan().build())
    refs = random_seqs(rng, PROTEIN, 16384, 140, 160)
    nw = pt.Aligner.new().gap_open(5).gap_extend(2).build()
    q150, r150 = random_seqs(rng, DNA, 2, 150, 150)
    dna = pt.Matrix.create(DNA, 2, -3)
    lng = (pt.Aligner.new().matrix(dna).gap_open(5).gap_extend(2).local()
           .build())
    lq = random_seqs(rng, DNA, 128, 2000, 2000)
    lr = random_seqs(rng, DNA, 128, 2000, 2000)
    dispatch.ROUTE_COUNTS.clear()
    reset_launches(tk, tw)
    res_sw = sw.align_batch(qs, rs)
    res_prof = pa.align_batch(None, refs)
    res_nw = nw.align(q150, r150)
    res_long = lng.align_batch(lq, lr)
    launches = tk.SHORT_LAUNCHES["score"]
    routes = dict(dispatch.ROUTE_COUNTS)
    log(f"[4 main path] score launches={launches} (short form "
        f"{tk.SHORT_LAUNCHES}, chunked {tk.CHUNKED_LAUNCHES}, walk "
        f"{tw.LAUNCHES}, segment {tk.SEGMENT_LAUNCHES}, packed segment "
        f"{tk.SEGMENT16_LAUNCHES}) routes={routes}")
    # the long pairs' score class: the packed form, none of them flagged
    if launches < 3 or tk.SEGMENT16_LAUNCHES < 1 or tk.SEGMENT_LAUNCHES or \
            tk.CHUNKED_LAUNCHES:
        raise AssertionError(
            f"main path launched the short form's score class {launches} "
            f"times, the packed segment form {tk.SEGMENT16_LAUNCHES} times, "
            f"the int32 segment form {tk.SEGMENT_LAUNCHES} times and the "
            f"block kernel's one-shot form {tk.CHUNKED_LAUNCHES} times, "
            f"expected 3, 1, 0 and 0")
    if routes != {("cuda_kernel", ""): 3, ("cuda_segments", "long pairs"): 1}:
        raise AssertionError(f"main path left the kernel routes: {routes}")
    check_against_plain("SW BLOSUM62 8192 pairs", res_sw,
                        plain_of(tk, sw, qs, rs))
    check_against_plain("profile vs 16384 refs", res_prof,
                        plain_of(tk, pa, None, refs))
    check_against_plain("NW 150 bp pair", [res_nw],
                        plain_of(tk, nw, [q150], [r150]))
    check_against_plain("128 x 2000 bp DNA", res_long,
                        plain_of(tk, lng, lq, lr))
    g = golden.align_seqs(q150, r150, pt.Matrix.default(), 5, 2, "nw")
    if (res_nw.get_score(), res_nw.get_end_query(), res_nw.get_end_ref()) \
            != (g.score, g.end_query, g.end_ref):
        raise AssertionError("NW 150 bp pair differs from golden")
    log("[4 main path] SW 8192 pairs, profile vs 16384 refs, NW 150 bp "
        "pair: on cuda_kernel; 128 x 2000 bp: on cuda_segments, the packed "
        "form; all equal to plain")

    # -- 5. timings -----------------------------------------------------------
    # the short form's score class (K1a) at the headline, the block
    # kernel's one-shot form beside it on the same inputs
    ms = time_cuda(torch, lambda: tk.score_align(*head_args, **head_kw))
    block_ms = time_cuda(torch, lambda: tk.score_chunked(*head_args,
                                                         **head_kw))
    plain_ms = time_cuda(
        torch, lambda: tk.score_align_plain(*head_args, **head_kw), reps=5,
        warmup=1)
    tab_args = (batch.ridx, batch.qlen_t, batch.rlen_t)
    tab_kw = dict(open_=11, ext=1, mode="sw", free=(True,) * 4, width="sat",
                  table=batch.table, qidx=batch.qidx)
    table_ms = time_cuda(torch, lambda: tk.score_align(*tab_args, **tab_kw))
    table_block_ms = time_cuda(torch, lambda: tk.score_chunked(*tab_args,
                                                               **tab_kw))
    head_bound = sweep_bound("score", head_args, head_kw)
    tab_bound = sweep_bound("score", tab_args, tab_kw)
    torch.cuda.reset_peak_memory_stats()
    e2e_ms = time_host(lambda: sw.align_batch(qs, rs))
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    prof_ms = time_host(lambda: pa.align_batch(None, refs), reps=3)
    nw_ms = time_host(lambda: nw.align(q150, r150), reps=7)
    # a separate run with the stage clocks on: where the e2e time goes
    with stages.measuring():
        for _ in range(5):
            sw.align_batch(qs, rs)
        snap = stages.snapshot()
    per_call = {k: v["ms"] / v["calls"] for k, v in snap.items() if "ms" in v}
    log(f"[5 timing] card: {card}")
    log(f"[5 timing] headline (8,192 per-pair profiles, 160 x 160): short "
        f"form (K1a, {tk.short_plan('score', 8192, 8192, 160, 160, 25, True)}"
        f" rows a lane, pairs a block, layout) median {ms} ms "
        f"({8192 / ms * 1e3} aln/s, {8192 * 150 * 150 / ms / 1e6} GCUPS); "
        f"the block kernel's one-shot form {block_ms} ms; plain median "
        f"{plain_ms} ms; bound {head_bound['bound_ms']} ms "
        f"({head_bound['bound_by']}) [{card}]")
    log(f"[5 timing] the SW BLOSUM62 8192-pair batch (table form, Qp=Rp="
        f"{batch.qidx.shape[1]}): short form median {table_ms} ms, the block "
        f"kernel's one-shot form {table_block_ms} ms, bound "
        f"{tab_bound['bound_ms']} ms ({tab_bound['bound_by']}) [{card}]")
    log(f"[5 timing] align_batch SW BLOSUM62 8192 pairs e2e median "
        f"{e2e_ms} ms ({8192 / e2e_ms * 1e3} aln/s), peak device memory "
        f"{peak_mib} MiB [{card}]")
    log(f"[5 timing] align_batch stages, ms per call (stage clocks on): "
        f"{json.dumps(per_call)} [{card}]")
    log(f"[5 timing] profile vs 16384 refs e2e median {prof_ms} ms; "
        f"NW 150 bp single pair median {nw_ms} ms [{card}]")

    clock("1-5")
    trace = trace_path(torch, pt, tk, tw, dispatch, golden, stages, rng,
                       blosum, card)
    planes = stats_path(torch, pt, tk, tw, dispatch, golden, stages, rng,
                        blosum, card, (qs, rs), trace["cfg4b"])
    clock("6-13")
    banded = banded_path(torch, pt, tk, tw, dispatch, golden, stages, rng,
                         blosum, card, (qs, rs))
    clock("14-15")
    long_k1 = many_path(torch, pt, tk, tw, dispatch, golden, stages, rng,
                        blosum, card, (qs, rs))
    clock("16-17")
    segments = segment_path(torch, pt, tk, tw, dispatch, golden, stages, rng,
                            card, (head_args, head_kw), long_k1)
    pairs = segments.pop("pairs")
    clock("18-20")
    tiles = dist_path(torch, pt, tk, dispatch, golden, rng, card, (qs, rs),
                      sw, pairs)
    clock("21-24")
    chunked = chunked_path(torch, pt, tk, tw, dispatch, golden, stages, rng,
                           card, pairs, (head_args, head_kw))
    clock("25-27")
    short = short_path(torch, pt, tk, tw, dispatch, stages, rng, blosum, card,
                       (qs, rs), trace["cfg4b"], planes.pop("tab"),
                       (head_args, head_kw))
    times = kernel_times(torch, tk, tw, card, banded.pop("inputs"),
                         trace.pop("walk_inputs"))
    clock("28-29")
    trace["walk"].update(long_walk(torch, pt, tk, tw, card))
    trace["walk"].update(kernel_ms=times["walk"]["cfg4b 4,096"],
                         chunk_kernel_ms=times["walk"]["cfg4b chunk of 512"])
    banded["score"].update(kernel_ms=times["band"]["cfg2"],
                           masked_kernel_ms=times["masked"]["cfg2"])
    banded["score"]["long"].update(kernel_ms=times["band"]["long"],
                                   masked_kernel_ms=times["masked"]["long"])
    banded["score_block"].update(kernel_ms=times["wide"])
    for cls, t in times["classes"].items():
        banded[cls].update(kernel_ms=t)
    clock("30")
    streamed = stream_path(torch, pt, tk, tw, dispatch, golden, stages,
                           blosum, card)
    clock("31")
    fuzz_path(torch, tk, tw, card)
    clock("32")
    packed_path(torch, pt, tk, dispatch, stages, card, _build.BUILD_LOG)
    clock("33")

    def with_short(cls, row):
        """A class's row, phases 4-13, with phases 28-29's numbers."""
        return {**row, **short[cls], "max_abs_err": max(
            row["max_abs_err"], short[cls]["max_abs_err"])}

    print(json.dumps({"kernels": [{
        "name": "scan_score_align (score), one warp a pair",
        "route": "cuda",
        "source": "parasail_rs_tpu_torch/csrc/scan_short.cu",
        "replaces": "parasail_rs_tpu/ops/scan_kernel.py:1453",
        **with_short("score", {
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "block_ms": block_ms,
            "e2e_ms": {"align_batch 8192": e2e_ms,
                       "Aligner.align 150 bp": nw_ms,
                       "stream cfg7 16384": streamed["stream_ms"],
                       "align_batch cfg7 16384": streamed["batch_ms"]},
            **head_bound}),
    }, {
        "name": "scan_score_align (trace), one warp a pair",
        "route": "cuda",
        "source": "parasail_rs_tpu_torch/csrc/scan_short.cu",
        "replaces": "parasail_rs_tpu/ops/scan_kernel.py:1453",
        **with_short("trace", trace["trace"]),
    }, {
        "name": "trace_walk._walk_impl, a warp a pair over staged tiles",
        "route": "cuda",
        "source": "parasail_rs_tpu_torch/csrc/trace_walk.cu",
        "replaces": "parasail_rs_tpu/ops/trace_walk.py:122",
        **trace["walk"],
    }] + [{
        "name": "scan_score_align (stats), one warp a pair",
        "route": "cuda",
        "source": "parasail_rs_tpu_torch/csrc/scan_short.cu",
        "replaces": "parasail_rs_tpu/ops/scan_kernel.py:1453",
        **with_short("stats", planes["stats"]),
    }] + [{
        "name": f"scan_score_align ({cls}), one warp a pair",
        "route": "cuda",
        "source": "parasail_rs_tpu_torch/csrc/scan_short.cu",
        "replaces": "parasail_rs_tpu/ops/scan_kernel.py:1453",
        **with_short(cls, planes[cls]),
    } for cls in PLANE_CLASSES[1:]] + [{
        "name": "scan_score_align (banded), a ring of row blocks",
        "route": "cuda",
        "source": "parasail_rs_tpu_torch/csrc/scan_banded.cu",
        "replaces": "parasail_rs_tpu/ops/scan_kernel.py:1453",
        **banded["score"],
    }, {
        "name": "scan_score_align (banded), the block kernel's masked sweep "
                "past the ring's reach",
        "route": "cuda",
        "source": "parasail_rs_tpu_torch/csrc/scan_chunked_banded.cu",
        "replaces": "parasail_rs_tpu/ops/scan_kernel.py:1453",
        **banded["score_block"],
    }] + [{
        "name": f"scan_score_align (banded, {cls}), one warp a pair, masked",
        "route": "cuda",
        "source": "parasail_rs_tpu_torch/csrc/scan_short_banded.cu",
        "replaces": "parasail_rs_tpu/ops/scan_kernel.py:1453",
        **banded[cls],
    } for cls in tk.OUTPUTS[1:]] + [{
        "name": f"scan_score_segment ({cls})",
        "route": "cuda",
        "source": "parasail_rs_tpu_torch/csrc/scan_segment.cu",
        "replaces": "parasail_rs_tpu/ops/scan_kernel.py:1672",
        **segments[cls],
    } for cls in ("score", "stats", "trace")] + [{
        "name": "scan_score_segment (score), packed: two pairs a lane on "
                "16x2 DPX",
        "route": "cuda",
        "source": "parasail_rs_tpu_torch/csrc/scan_segment16.cu",
        "replaces": "parasail_rs_tpu/ops/scan_kernel.py:1672, :1453",
        **segments["score16"],
    }] + [{
        "name": f"scan_rowseg_step ({cls})",
        "route": "cuda",
        "source": "parasail_rs_tpu_torch/csrc/scan_rowseg.cu",
        "replaces": "parasail_rs_tpu/ops/scan_kernel.py:1877",
        **tiles[cls],
    } for cls in ("score", "stats", "trace")] + [{
        "name": "scan_score_align, query in row chunks (K1f)",
        "route": "cuda",
        "source": "parasail_rs_tpu_torch/csrc/scan_chunked.cu",
        "replaces": "parasail_rs_tpu/ops/scan_kernel.py:1453",
        **chunked,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def trace_path(torch, pt, tk, tw, dispatch, golden, stages, rng, blosum,
               card) -> dict:
    """Phases 6-9, the trace + CIGAR path; returns the trace and walk
    kernels' launches, errors and times."""
    dev = torch.device("cuda")

    # -- 6. trace kernel and walk kernel vs plain -----------------------------
    errs = [0, 0]

    def check(name, args, kw, qsym, rsym):
        e = compare_trace(torch, tk, tw, name, args, kw, qsym, rsym)
        errs[0], errs[1] = max(errs[0], e[0]), max(errs[1], e[1])
        log(f"[6 trace vs plain] {name}: trace and walk equal")

    for name, (args, subs), kw in small_cases(rng, torch, dev):
        # the profile form has no letters: any symbols do for the walk
        qsym = subs["qidx"] if "qidx" in subs else torch.zeros(
            (1, subs["profile"].shape[1]), dtype=torch.int32, device=dev)
        check(name, args, {**kw, **subs}, qsym, args[0])
    for name, (args, subs), kw, _want in empty_side_cases(torch, dev):
        check(name, args, {**kw, **subs}, subs["qidx"], args[0])
    cig_al = (pt.Aligner.new().matrix(blosum).gap_open(11).gap_extend(1)
              .semi_global().build())
    q4b = random_seqs(rng, PROTEIN, 4096, 140, 160)
    r4b = random_seqs(rng, PROTEIN, 4096, 140, 160)
    b4b, _, _ = cig_al._pack(q4b, r4b)
    args4b = (b4b.ridx, b4b.qlen_t, b4b.rlen_t)
    kw4b = dict(open_=11, ext=1, mode="sg", free=(True,) * 4, width="sat",
                table=b4b.table, qidx=b4b.qidx)
    check("cfg4b B=4096 Qp=Rp=192 SG BLOSUM62 11/1", args4b, kw4b,
          b4b.qbytes, b4b.rbytes)

    # -- 7. the trace + CIGAR path through the public API ----------------------
    tr_al = (pt.Aligner.new().matrix(blosum).gap_open(11).gap_extend(1)
             .semi_global().use_trace().build())
    dispatch.ROUTE_COUNTS.clear()
    reset_launches(tk, tw)
    alns_c, cigs = cig_al.align_cigars(q4b, r4b)
    alns_t = tr_al.align_batch(q4b, r4b)
    cigs_t = tr_al.cigars(alns_t, q4b, r4b)
    trace_launches, walk_launches = tk.SHORT_LAUNCHES["trace"], tw.LAUNCHES
    routes = dict(dispatch.ROUTE_COUNTS)
    log(f"[7 trace path] trace launches={trace_launches} walk "
        f"launches={walk_launches} (score {tk.SHORT_LAUNCHES['score']}) "
        f"routes={routes}")
    if trace_launches < 1 or walk_launches < 1:
        raise AssertionError("the trace path did not launch the short "
                             "form's trace class and the walk kernel")
    if set(routes) != {("cuda_kernel", "")} or \
            set(cig_al.route_counter) | set(tr_al.route_counter) != \
            {("cuda_kernel", "")}:
        raise AssertionError(f"the trace path left the kernel route: "
                             f"{routes}")
    if cigs != cigs_t:
        bad = next(b for b in range(len(cigs)) if cigs[b] != cigs_t[b])
        raise AssertionError(f"pair {bad}: device walk {cigs[bad]!r} != "
                             f"host walk {cigs_t[bad]!r}")
    scal = [(a.get_score(), a.get_end_query(), a.get_end_ref())
            for a in alns_c]
    if scal != [(a.get_score(), a.get_end_query(), a.get_end_ref())
                for a in alns_t]:
        raise AssertionError("align_cigars and use_trace scalars differ")
    if any(a.is_trace() for a in alns_c) or not all(
            a.is_trace() for a in alns_t):
        raise AssertionError("result classes are wrong")
    log("[7 trace path] align_cigars and use_trace + cigars on 4,096 SG "
        "BLOSUM62 pairs: all on cuda_kernel, CIGARs and scalars equal")

    # -- 8. golden ---------------------------------------------------------------
    for b in rng.choice(len(q4b), size=16, replace=False).tolist():
        g = golden.align_seqs(q4b[b], r4b[b], blosum, 11, 1, "sg")
        w = golden.walk_trace(g.trace_table, q4b[b], r4b[b], g.end_query,
                              g.end_ref, "sg")
        want = (g.score, g.end_query, g.end_ref, w.cigar_string())
        got = (*scal[b], cigs[b])
        if got != want or alns_t[b].get_cigar(q4b[b], r4b[b]) != want[3]:
            raise AssertionError(f"pair {b}: {got} != golden {want}")
    log("[8 golden] 16 sampled pairs of the cfg4b batch: score, end cell "
        "and CIGAR equal to golden")

    # -- 9. timings ----------------------------------------------------------------
    trace_kw = {**kw4b, "outputs": "trace"}
    plane = tk.score_align(*args4b, **trace_kw)
    walk_args = (plane["trace_table"], b4b.qbytes, b4b.rbytes,
                 plane["end_query"], plane["end_ref"], "sg", (True,) * 4)
    t_ms = time_cuda(torch, lambda: tk.score_align(*args4b, **trace_kw))
    t_plain = time_cuda(torch, lambda: tk.score_align_plain(
        *args4b, **trace_kw), reps=3, warmup=1)
    s_ms = time_cuda(torch, lambda: tk.score_align(*args4b, **kw4b))
    sub = (b4b.ridx[:512], b4b.qlen_t[:512], b4b.rlen_t[:512])
    chunk_ms = time_cuda(torch, lambda: tk.score_align(
        *sub, **{**trace_kw, "qidx": b4b.qidx[:512]}))
    w_ms = time_cuda(torch, lambda: tw.device_walk(*walk_args))
    chunk_walk = tuple(a[:512] for a in walk_args[:5]) + walk_args[5:]
    w_chunk_ms = time_cuda(torch, lambda: tw.device_walk(*chunk_walk))
    w_plain = time_cuda(torch, lambda: tw.device_walk_plain(*walk_args),
                        reps=3, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    cig_ms = time_host(lambda: cig_al.align_cigars(q4b, r4b))
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    with stages.measuring():
        for _ in range(5):
            cig_al.align_cigars(q4b, r4b)
        snap = stages.snapshot()
    per_call = {k: v["ms"] / 5 for k, v in snap.items() if "ms" in v}
    cig_al._CIGAR_CHUNK = 4096
    one_ms = time_host(lambda: cig_al.align_cigars(q4b, r4b))
    with stages.measuring():
        for _ in range(5):
            cig_al.align_cigars(q4b, r4b)
        one_snap = stages.snapshot()
    one_call = {k: v["ms"] / 5 for k, v in one_snap.items() if "ms" in v}
    del cig_al._CIGAR_CHUNK
    torch.cuda.reset_peak_memory_stats()
    tr_ms = time_host(lambda: tr_al.cigars(tr_al.align_batch(q4b, r4b),
                                           q4b, r4b), reps=3)
    tr_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"[9 timing] card: {card}")
    log(f"[9 timing] cfg4b shape B=4096 Qp=Rp=192: trace kernel median "
        f"{t_ms} ms, plain {t_plain} ms; score kernel on the same batch "
        f"{s_ms} ms; trace kernel on a 512-pair chunk {chunk_ms} ms; walk "
        f"kernel (tiled) {w_ms} ms a call, on the 512-pair chunk "
        f"{w_chunk_ms} ms a call; plain {w_plain} ms [{card}]")
    log(f"[9 timing] align_cigars 4096 pairs e2e median {cig_ms} ms "
        f"({4096 / cig_ms * 1e3} CIGARs/s), chunks of 512; peak device "
        f"memory {peak_mib} MiB [{card}]")
    log(f"[9 timing] align_cigars stages, ms per call summed over its 8 "
        f"chunks (stage clocks on): {json.dumps(per_call)} [{card}]")
    log(f"[9 timing] align_cigars 4096 pairs in one chunk of 4096 e2e "
        f"median {one_ms} ms ({4096 / one_ms * 1e3} CIGARs/s); stages, ms "
        f"per call: {json.dumps(one_call)} [{card}]")
    log(f"[9 timing] use_trace align_batch + cigars 4096 pairs e2e median "
        f"{tr_ms} ms ({4096 / tr_ms * 1e3} CIGARs/s), peak device memory "
        f"{tr_peak} MiB [{card}]")
    # the walk reads one flag a step along each pair's path and writes the
    # opcode rows and begin cells
    steps = int((tw.device_walk(*walk_args)[0] != 0).sum().item())
    nb, qp, rp = plane["trace_table"].shape
    walk_bound = bound(steps * OPS_PER_WALK_STEP,
                       steps + nb * (qp + rp) + 4 * nb * 4)
    return {"trace": {"launches": trace_launches, "max_abs_err": errs[0],
                      "ms": t_ms, "plain_ms": t_plain,
                      **sweep_bound("trace", args4b, kw4b)},
            "walk": {"launches": walk_launches, "max_abs_err": errs[1],
                     "ms": w_ms, "chunk_ms": w_chunk_ms, "plain_ms": w_plain,
                     **walk_bound},
            "walk_inputs": {"cfg4b 4,096": walk_args,
                            "cfg4b chunk of 512": chunk_walk},
            "cfg4b": (q4b, r4b)}


def with_letters(torch, rng, subs, outputs):
    """The stats classes compare query letters: give a profile form
    seeded letters beside its rows (the table form has them)."""
    if outputs not in STATS_CLASSES or "qidx" in subs:
        return subs
    prof = subs["profile"]
    q = rng.integers(0, prof.shape[2], size=prof.shape[:2]).astype(np.int32)
    return {**subs, "qidx": torch.from_numpy(q).to(prof.device)}


def check_api_against_plain(tk, dispatch, name, aligner, alignments, qs,
                            rs) -> None:
    """Every output of every alignment equals the plain version's on the
    batch the aligner packs; raises on the first difference."""
    batch, qlens, rlens = aligner._pack(qs, rs)
    subs = ({"table": batch.table, "qidx": batch.qidx}
            if batch.table is not None else {"profile": batch.profile})
    if aligner.key.outputs in STATS_CLASSES:
        subs["qidx"] = batch.qidx
    plain = tk.score_align_plain(
        batch.ridx, batch.qlen_t, batch.rlen_t, open_=aligner.gap_open,
        ext=aligner.gap_extend, mode=aligner.key.mode, free=aligner.key.free,
        width={"64": "32"}.get(aligner.key.width, aligner.key.width),
        outputs=aligner.key.outputs, **subs)
    plain = {k: v.cpu().numpy() for k, v in plain.items()}
    for b, a in enumerate(alignments):
        want = dispatch.slice_pair(plain, b, qlens[b], rlens[b])
        for k, v in want.items():
            if not np.array_equal(np.asarray(a.fields[k]), v):
                raise AssertionError(f"{name}: pair {b} {k} differs from "
                                     f"the plain version")


def golden_views(a, g) -> list:
    """(API result, golden) pairs of every output the result's class has."""
    views = [((a.get_score(), a.get_end_query(), a.get_end_ref()),
              (g.score, g.end_query, g.end_ref))]
    if a.is_stats():
        views.append(((a.get_matches(), a.get_similar(), a.get_length()),
                      (g.matches, g.similar, g.length)))
    names = ("score", "matches", "similar", "length")[
        :4 if a.is_stats() else 1]
    for n in names:
        if a.is_table() or a.is_stats_table():
            views.append((a.fields[f"{n}_table"].tolist(),
                          getattr(g, f"{n}_table").tolist()))
        if a.is_rowcol() or a.is_stats_rowcol():
            views.append((a.fields[f"{n}_row"].tolist(),
                          getattr(g, f"{n}_row").tolist()))
            views.append((a.fields[f"{n}_col"].tolist(),
                          getattr(g, f"{n}_col").tolist()))
    return views


def stats_path(torch, pt, tk, tw, dispatch, golden, stages, rng, blosum,
               card, sw_pairs, cfg4b) -> dict:
    """Phases 10-13, the stats, table and rowcol classes; returns each
    new form's launches, error and times."""
    dev = torch.device("cuda")
    errs = dict.fromkeys(PLANE_CLASSES, 0)

    def check(cls, name, args, kw):
        errs[cls] = max(errs[cls], compare(torch, tk, f"{cls} {name}", args,
                                           {**kw, "outputs": cls}))

    # -- 10. stats and plane forms vs plain --------------------------------------
    for cls in PLANE_CLASSES:
        small = small_cases(rng, torch, dev)
        for name, (args, subs), kw in small:
            check(cls, name, args, {**kw, **with_letters(torch, rng, subs,
                                                         cls)})
        log(f"[10 stats/planes vs plain] {cls}: {len(small)} small batches "
            "equal")
    m = pt.Matrix.default()
    for name, (args, subs), kw, _want in empty_side_cases(torch, dev):
        for cls in PLANE_CLASSES:
            check(cls, name, args, {**kw, **subs})
        out = tk.score_align(*args, **kw, **subs, outputs="stats")
        keys = ("score", "end_query", "end_ref", "matches", "similar",
                "length")
        for b, (q, r) in enumerate(zip(EMPTY_QS, EMPTY_RS)):
            got = tuple(int(out[k][b]) for k in keys)
            if kw["mode"] == "sw" and not (q and r):
                want = (0,) * 6
            else:
                g = golden.align_seqs(q, r, m, 5, 2, kw["mode"], kw["free"])
                want = tuple(getattr(g, k) for k in keys)
            if got != want:
                raise AssertionError(f"{name} pair {b}: kernel stats {got} "
                                     f"!= golden {want}")
        log(f"[10 stats/planes vs plain] {name}: every class equal, stats "
            "equal to golden")
    head_args, head_kw = headline_inputs(torch, dev)
    hb, hq, ha = head_kw["profile"].shape
    head_q = np.random.default_rng(3).integers(
        0, ha, size=(hb, hq)).astype(np.int32)       # bench.py:621-624
    head_kw = {**head_kw, "qidx": torch.from_numpy(head_q).to(dev),
               "outputs": "stats"}
    errs["stats"] = max(errs["stats"], compare(torch, tk, "stats headline",
                                               head_args, head_kw))
    log("[10 stats/planes vs plain] bench.py stats headline B=8192 "
        "Qp=Rp=160 A=25 SW 11/1 sat: equal")
    tq = random_seqs(rng, PROTEIN, 512, 1, 192)
    tr = random_seqs(rng, PROTEIN, 512, 1, 192)
    tab_al = pt.Aligner.new().matrix(blosum).gap_open(11).gap_extend(1) \
        .local().build()
    tb, _, _ = tab_al._pack(tq, tr)
    tab_args = (tb.ridx, tb.qlen_t, tb.rlen_t)
    tab_kw = dict(open_=11, ext=1, mode="sw", free=(True,) * 4, width="sat",
                  table=tb.table, qidx=tb.qidx)
    for cls in PLANE_CLASSES[1:]:
        check(cls, "512 BLOSUM62 pairs of 1-192", tab_args, tab_kw)
    log(f"[10 stats/planes vs plain] 512 BLOSUM62 pairs of 1-192 residues "
        f"(Qp={tb.qidx.shape[1]}, Rp={tb.ridx.shape[1]}): every plane class "
        f"equal")

    # -- 11. the main path through the public API --------------------------------
    qs, rs = sw_pairs
    q4b, r4b = cfg4b

    def sw():
        return pt.Aligner.new().matrix(blosum).gap_open(11).gap_extend(1) \
            .local()

    def sg(gap_open, gap_extend):
        return pt.Aligner.new().matrix(blosum).semi_global() \
            .gap_open(gap_open).gap_extend(gap_extend).use_stats().build()

    n = len(qs)
    cases = [
        (f"use_stats SW {n}", sw().use_stats().build(), qs, rs),
        (f"SG use_stats cfg4b {len(q4b)} 11/1", sg(11, 1), q4b, r4b),
        (f"SG use_stats cfg4b {len(q4b)} 2/2", sg(2, 2), q4b, r4b),
        (f"use_last_rowcol SW {n}", sw().use_last_rowcol().build(), qs, rs),
        (f"use_last_rowcol + stats SW {n}",
         sw().use_last_rowcol().use_stats().build(), qs, rs),
        ("use_table SW 512", sw().use_table().build(), qs[:512], rs[:512]),
        ("use_table + stats SW 512", sw().use_table().use_stats().build(),
         qs[:512], rs[:512]),
    ]
    dispatch.ROUTE_COUNTS.clear()
    reset_launches(tk, tw)
    results = [al.align_batch(q, r) for _, al, q, r in cases]
    # every class is the short form's
    launches = {cls: tk.SHORT_LAUNCHES[cls] for cls in PLANE_CLASSES}
    routes = dict(dispatch.ROUTE_COUNTS)
    log(f"[11 stats/planes path] short form launches={launches} (score "
        f"{tk.SHORT_LAUNCHES['score']}, trace {tk.SHORT_LAUNCHES['trace']}, "
        f"chunked {tk.CHUNKED_LAUNCHES}, banded "
        f"{banded_launches(tk)}, walk {tw.LAUNCHES}) routes={routes}")
    if min(launches.values()) < 1 or tk.CHUNKED_LAUNCHES or \
            sum(banded_launches(tk).values()):
        raise AssertionError(f"a class did not launch the short form: "
                             f"{launches}, chunked {tk.CHUNKED_LAUNCHES}, "
                             f"banded {banded_launches(tk)}")
    bad = [n for n, al, _, _ in cases
           if set(al.route_counter) != {("cuda_kernel", "")}]
    if set(routes) != {("cuda_kernel", "")} or bad:
        raise AssertionError(f"left the kernel route: {routes} {bad}")
    for (name, al, q, r), res in zip(cases, results):
        check_api_against_plain(tk, dispatch, name, al, res, q, r)
    log("[11 stats/planes path] " + ", ".join(n for n, *_ in cases) +
        ": all on cuda_kernel, equal to plain")

    # -- 12. golden -------------------------------------------------------------------
    for (name, al, q, r), res in zip(cases, results):
        for b in rng.choice(len(q), size=16, replace=False).tolist():
            g = golden.align_seqs(q[b], r[b], blosum, al.gap_open,
                                  al.gap_extend, al.key.mode, al.key.free)
            for got, want in golden_views(res[b], g):
                if got != want:
                    raise AssertionError(f"{name} pair {b}: {got} != golden "
                                         f"{want}")
        log(f"[12 golden] {name}: 16 sampled pairs equal to golden")

    # -- 13. timings -----------------------------------------------------------------
    score_kw = {k: v for k, v in head_kw.items() if k not in ("qidx",
                                                              "outputs")}
    st_ms = time_cuda(torch, lambda: tk.score_align(*head_args, **head_kw))
    sc_ms = time_cuda(torch, lambda: tk.score_align(*head_args, **score_kw))
    st_plain = time_cuda(torch, lambda: tk.score_align_plain(
        *head_args, **head_kw), reps=3, warmup=1)
    sub = tuple(a[:2048] for a in head_args)
    sub_kw = {**head_kw, "profile": head_kw["profile"][:2048],
              "qidx": head_kw["qidx"][:2048]}
    st_2048 = time_cuda(torch, lambda: tk.score_align(*sub, **sub_kw))
    sc_2048 = time_cuda(torch, lambda: tk.score_align(
        *sub, **{k: v for k, v in sub_kw.items()
                 if k not in ("qidx", "outputs")}))
    times = {"stats": (st_ms, st_plain)}
    torch.cuda.reset_peak_memory_stats()
    block = {}
    for cls in PLANE_CLASSES[1:]:
        kw = {**tab_kw, "outputs": cls}
        times[cls] = (
            time_cuda(torch, lambda: tk.score_align(*tab_args, **kw)),
            time_cuda(torch, lambda: tk.score_align_plain(*tab_args, **kw),
                      reps=3, warmup=1))
        block[cls] = time_cuda(torch, lambda: tk.score_chunked(*tab_args,
                                                               **kw))
    tab_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    stats_al = cases[0][1]
    e2e_ms = time_host(lambda: stats_al.align_batch(qs, rs))
    with stages.measuring():
        for _ in range(5):
            stats_al.align_batch(qs, rs)
        snap = stages.snapshot()
    per_call = {k: v["ms"] / v["calls"] for k, v in snap.items() if "ms" in v}
    sg_ms = time_host(lambda: cases[1][1].align_batch(q4b, r4b))
    sg22_ms = time_host(lambda: cases[2][1].align_batch(q4b, r4b))
    torch.cuda.reset_peak_memory_stats()
    tab_e2e = time_host(lambda: cases[6][1].align_batch(qs[:512], rs[:512]),
                        reps=3)
    api_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    rc_e2e = time_host(lambda: cases[3][1].align_batch(qs, rs))
    src_e2e = time_host(lambda: cases[4][1].align_batch(qs, rs))
    log(f"[13 timing] card: {card}")
    log(f"[13 timing] headline B=8192 Qp=Rp=160 SW 11/1 sat: stats kernel "
        f"median {st_ms} ms ({8192 / st_ms * 1e3} aln/s), plain {st_plain} "
        f"ms; score kernel on the same inputs {sc_ms} ms; on 2,048 of the "
        f"pairs stats {st_2048} ms, score {sc_2048} ms [{card}]")
    for cls in PLANE_CLASSES[1:]:
        b = sweep_bound(cls, tab_args, tab_kw)
        log(f"[13 timing] {cls} on the 512-pair batch (Qp={tb.qidx.shape[1]}, "
            f"Rp={tb.ridx.shape[1]}): short form (K1d, "
            f"{tk.short_plan(cls, 512, 512, tb.qidx.shape[1], tb.ridx.shape[1], tb.table.shape[0])}"
            f" rows a lane, pairs a block, layout) median {times[cls][0]} ms, "
            f"the block kernel's one-shot form {block[cls]} ms, plain "
            f"{times[cls][1]} ms, bound {b['bound_ms']} ms ({b['bound_by']}) "
            f"[{card}]")
    log(f"[13 timing] peak device memory of the plane timings {tab_peak} "
        f"MiB; use_table + stats align_batch of 512 pairs e2e median "
        f"{tab_e2e} ms, peak {api_peak} MiB [{card}]")
    log(f"[13 timing] use_stats align_batch SW BLOSUM62 {n} pairs e2e "
        f"median {e2e_ms} ms ({n / e2e_ms * 1e3} aln/s); stages, ms per "
        f"call: {json.dumps(per_call)} [{card}]")
    log(f"[13 timing] use_last_rowcol align_batch SW BLOSUM62 {n} pairs e2e "
        f"median {rc_e2e} ms, with use_stats {src_e2e} ms [{card}]")
    log(f"[13 timing] SG use_stats cfg4b {len(q4b)} pairs e2e median {sg_ms} "
        f"ms ({len(q4b) / sg_ms * 1e3} aln/s) at 11/1, {sg22_ms} ms at 2/2 "
        f"[{card}]")
    out = {cls: {"launches": launches[cls], "max_abs_err": errs[cls],
                 "ms": times[cls][0], "plain_ms": times[cls][1],
                 **(sweep_bound(cls, head_args, head_kw) if cls == "stats"
                    else sweep_bound(cls, tab_args, tab_kw))}
           for cls in PLANE_CLASSES}
    for cls in PLANE_CLASSES[1:]:
        out[cls].update(block_ms=block[cls],
                        shape=f"512 BLOSUM62 pairs, Qp={tb.qidx.shape[1]}, "
                              f"Rp={tb.ridx.shape[1]}, SW 11/1")
    out["tab"] = (tab_args, tab_kw)       # for phase 29's kernel times
    return out


F4 = (False,) * 4
NEG = -(1 << 30)
# the long-pair phases' lengths: cfg6's, the mixed batch's longest pair
# (and phase 16's long batch), and the shorter batch of the one-shot
# against segment kernel comparison
CFG6_LEN = 16384
LONG_LEN = 4096
MID_LEN = 1024
# the empty-side and unreachable-corner pairs of the banded repair (NW,
# DNA +2/-3, open 4, ext 1, bandwidth 2): (qlen, rlen) and the score, or
# None for golden's banded oracle on seeded letters
STEP0 = [((0, 5), NEG), ((5, 0), NEG), ((0, 2), -5), ((3, 9), NEG),
         ((6, 6), None)]


def pack_table(torch, dev, matrix, qs, rs, P):
    """Pairs (empty sides allowed) -> ((ridx, qlen, rlen), table + qidx)
    on the card, padded to P."""
    qidx = np.full((len(qs), P), -1, np.int32)
    ridx = np.zeros((len(rs), P), np.int32)
    for b, (q, r) in enumerate(zip(qs, rs)):
        qidx[b, :len(q)] = matrix.encode(q)
        ridx[b, :len(r)] = matrix.encode(r)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    return ((t(ridx), t([len(q) for q in qs]), t([len(r) for r in rs])),
            {"table": t(matrix.data), "qidx": t(qidx)})


def banded_oracle(golden, matrix, q, r, open_, ext, bw) -> int:
    """golden's scalar banded fill, its unreachable sentinel as -2^30."""
    sub = matrix.scores_for(matrix.encode(q), matrix.encode(r))
    want = golden.banded_nw_fill(sub.astype(np.int64), open_, ext, bw)
    return NEG if want < -(10 ** 8) else want


def band_cells(qlen: np.ndarray, rlen: np.ndarray, bw: int) -> int:
    """Cells with |i - j| <= bw inside each pair, summed."""
    total = 0
    for ql, rl in zip(qlen.tolist(), rlen.tolist()):
        i = np.arange(ql)
        total += int(np.clip(np.minimum(rl - 1, i + bw) -
                             np.maximum(0, i - bw) + 1, 0, None).sum())
    return total


# the banded slice's modes: NW, SG with all four ends free, SW
BANDED_MODES = (("nw", F4), ("sg", (True,) * 4), ("sw", (True,) * 4))
# the banded phase-14 batches' bands
BANDS_14 = (0, 3, 16, 64, 4096)


def banded_launches(tk) -> dict:
    """The banded forms' launch counts by class (the score class on the
    ring and on the masked full sweep together)."""
    return {**tk.BANDED_CLASS_LAUNCHES,
            "score": tk.BANDED_WARP_LAUNCHES +
            tk.BANDED_CLASS_LAUNCHES["score"]}


def reset_banded_launches(tk) -> None:
    tk.BANDED_WARP_LAUNCHES = 0
    tk.BANDED_CLASS_LAUNCHES = dict.fromkeys(tk.BANDED_CLASS_LAUNCHES, 0)
    tk.BANDED_FORM_LAUNCHES = dict.fromkeys(tk.BANDED_FORM_LAUNCHES, 0)


# (G lanes, kR rows) of the banded warp form, every form it has
BAND_FORMS = tuple((g, r) for g in (8, 16, 32) for r in (4, 5, 6, 8))


def band_reach(form) -> int:
    """The widest band (half-width) a warp form reaches: 2 bw < (G - 1)
    kR + G + 1."""
    g, r = form
    return ((g - 1) * r + g) // 2


def banded_masked(tk, fn):
    """fn() with the banded score class forced onto the masked full sweep
    (off the ring)."""
    tk._BAND_FORM = (0, 0)
    try:
        return fn()
    finally:
        tk._BAND_FORM = None


def banded_path(torch, pt, tk, tw, dispatch, golden, stages, rng, blosum,
                card, sw_pairs) -> dict:
    """Phases 14-15 and the banded timings; returns each banded form's
    launches, error and times, by class."""
    dev = torch.device("cuda")
    dna = pt.Matrix.create(DNA, 2, -3)
    errs = dict.fromkeys(tk.OUTPUTS, 0)

    def check(name, args, kw):
        """A banded class against its plain version (and, for the trace
        class, the walk kernel against the plain walk on its plane)."""
        cls = kw["outputs"]
        if cls == "trace":
            err = max(compare_trace(torch, tk, tw, name, args, kw,
                                    kw["qidx"], args[0]))
        else:
            err = compare(torch, tk, name, args, kw)
        errs[cls] = max(errs[cls], err)

    # -- 14. banded kernel vs plain ------------------------------------------
    batches = [("DNA 4/1", dna, DNA, 4, 1, 60), ("DNA 2/2", dna, DNA, 2, 2, 60),
               ("DNA 1/3", dna, DNA, 1, 3, 60),
               ("BLOSUM62 11/1", blosum, PROTEIN, 11, 1, 150)]
    for bi, (name, m, alpha, open_, ext, hi) in enumerate(batches):
        n = 256
        qs = random_seqs(rng, alpha, n, 0, hi)
        rs = random_seqs(rng, alpha, n, 0, hi)
        args, subs = pack_table(torch, dev, m, qs, rs, hi + 4)
        # the NW score form at every band, every other class and mode at
        # one band a batch, in turn; SG takes the nine free-end sets in turn
        for ci, cls in enumerate(tk.OUTPUTS):
            for mi, (mode, free) in enumerate(BANDED_MODES):
                k = bi + ci + mi
                if mode == "sg":
                    free = SG_FREE[k % len(SG_FREE)]
                bands = BANDS_14 if (cls, mode) == ("score", "nw") else \
                    (BANDS_14[k % 5],)
                for bw in bands:
                    check(f"banded {cls} {mode}{free if mode == 'sg' else ''}"
                          f" {name} bw={bw}", args,
                          dict(open_=open_, ext=ext, mode=mode, free=free,
                               width="sat", banded=True, bandwidth=bw,
                               outputs=cls, **subs))
        log(f"[14 banded vs plain] {name}, {n} pairs of 0-{hi}: the NW "
            f"score form at bw 0, 3, 16, 64, 4096, every class x NW, SG, SW "
            f"at one of them: equal")
    q9, r9 = random_seqs(rng, DNA, 2, 9, 9)
    s0q = [q9[:a] for (a, _), _ in STEP0]
    s0r = [r9[:b] for (_, b), _ in STEP0]
    args, subs = pack_table(torch, dev, dna, s0q, s0r, 16)
    kw = dict(open_=4, ext=1, mode="nw", free=F4, width="32", banded=True,
              bandwidth=2, **subs)
    for cls in tk.OUTPUTS:
        for mode, free in BANDED_MODES + (("sg", (True, False, False, True)),):
            check(f"banded step-0 pairs {cls} {mode}{free}", args,
                  dict(kw, mode=mode, free=free, outputs=cls))
    out = tk.score_align(*args, **kw)
    for k, ((a, b), want) in enumerate(STEP0):
        oracle = banded_oracle(golden, dna, s0q[k], s0r[k], 4, 1, 2)
        got = int(out["score"][k])
        if got != oracle or (want is not None and got != want):
            raise AssertionError(f"banded ({a}, {b}): kernel {got}, oracle "
                                 f"{oracle}, expected {want}")
    log("[14 banded vs plain] empty sides and unreachable corners (0, 5), "
        "(5, 0), (0, 2), (3, 9), (6, 6): every class x NW, SG, SW equal to "
        "plain, the NW score equal to golden's banded oracle: "
        f"{out['score'].tolist()}")
    # past 256 query rows the short form does not take a batch: the block
    # kernel's masked form, every class, counted by form (pairs from a
    # generator of their own, numpy seed 14, so that the later phases draw
    # what they drew before)
    long_rng = np.random.default_rng(14)
    qs = random_seqs(long_rng, DNA, 32, 200, 300)
    rs = random_seqs(long_rng, DNA, 32, 40, 120)
    args, subs = pack_table(torch, dev, dna, qs, rs, 304)
    reset_banded_launches(tk)
    for ci, cls in enumerate(tk.OUTPUTS):
        for mi, (mode, free) in enumerate(BANDED_MODES):
            if mode == "sg":
                free = SG_FREE[ci % len(SG_FREE)]
            bw = (5, 64, 200)[(ci + mi) % 3]
            check(f"banded {cls} {mode}{free if mode == 'sg' else ''} "
                  f"32 DNA pairs of 200-300 x 40-120 bw={bw}", args,
                  dict(open_=4, ext=1, mode=mode, free=free, width="sat",
                       banded=True, bandwidth=bw, outputs=cls, **subs))
    masked = sum(tk.BANDED_CLASS_LAUNCHES.values())
    log(f"[14 banded vs plain] 32 DNA pairs of 200-300 x 40-120 (Qp 304), "
        f"every class x NW, SG, SW at bw 5, 64 or 200: equal to plain; "
        f"masked sweeps by form {tk.BANDED_FORM_LAUNCHES}, the ring "
        f"{tk.BANDED_WARP_LAUNCHES}")
    if tk.BANDED_FORM_LAUNCHES != {"short": 0, "block": masked} or \
            masked + tk.BANDED_WARP_LAUNCHES != len(tk.OUTPUTS) * len(
                BANDED_MODES):
        raise AssertionError(f"the Qp 304 batch launched the masked sweep "
                             f"{tk.BANDED_FORM_LAUNCHES}, expected the "
                             "block kernel's alone")

    # -- 15. the banded main path through the public API -----------------------
    qs, rs = sw_pairs
    bw = 16
    bal = (pt.Aligner.new().matrix(blosum).gap_open(11).gap_extend(1)
           .bandwidth(bw).build())
    dispatch.ROUTE_COUNTS.clear()
    reset_launches(tk, tw)
    res = bal.banded_nw_batch(qs, rs)
    launches = tk.BANDED_WARP_LAUNCHES
    routes = dict(dispatch.ROUTE_COUNTS)
    log(f"[15 banded path] banded warp form launches={launches} (masked "
        f"sweep {tk.BANDED_CLASS_LAUNCHES['score']}, short score "
        f"{tk.SHORT_LAUNCHES['score']}) routes={routes}")
    if launches < 1 or sum(tk.BANDED_CLASS_LAUNCHES.values()):
        raise AssertionError("banded_nw_batch did not launch the banded "
                             "warp form alone")
    if set(routes) != {("cuda_kernel", "")} or \
            set(bal.route_counter) != {("cuda_kernel", "")}:
        raise AssertionError(f"the banded path left the kernel route: "
                             f"{routes}")
    batch, _, _ = bal._pack(qs, rs)
    args = (batch.ridx, batch.qlen_t, batch.rlen_t)
    kw = dict(open_=11, ext=1, mode="nw", free=F4, width="32",
              table=batch.table, qidx=batch.qidx, banded=True, bandwidth=bw)
    plain = {k: v.cpu().numpy() for k, v in
             tk.score_align_plain(*args, **kw).items()}
    check_against_plain(f"banded_nw_batch {len(qs)} pairs bw {bw}", res,
                        plain)
    errs["score"] = max(errs["score"],
                        compare(torch, tk, "phase 15 batch", args, kw))
    if not all(a.is_banded() and a.is_global() for a in res):
        raise AssertionError("banded results have the wrong flags")
    for b in rng.choice(len(qs), size=16, replace=False).tolist():
        want = banded_oracle(golden, blosum, qs[b], rs[b], 11, 1, bw)
        if res[b].get_score() != want:
            raise AssertionError(f"banded pair {b}: {res[b].get_score()} != "
                                 f"golden's banded oracle {want}")
    unreachable = sum(a.get_score() == NEG for a in res)
    log(f"[15 banded path] banded_nw_batch of {len(qs)} BLOSUM62 pairs of "
        f"140-160, NW 11/1, bw {bw}: on cuda_kernel, equal to plain, 16 "
        f"sampled pairs equal to golden's banded oracle; {unreachable} "
        "corners out of the band (-2^30)")

    errs["score"] = max(errs["score"], banded_masked(
        tk, lambda: compare(torch, tk, "phase 15 batch, masked sweep", args,
                            kw)))
    errs["score"] = max(errs["score"], band_forms(torch, tk, card))
    wide, wide_inputs = wide_band(torch, pt, tk, tw, dispatch, card)

    # -- banded timings ---------------------------------------------------------
    ms = time_cuda(torch, lambda: tk.score_align(*args, **kw))
    masked_ms = banded_masked(tk, lambda: time_cuda(
        torch, lambda: tk.score_align(*args, **kw)))
    plain_ms = time_cuda(torch, lambda: tk.score_align_plain(*args, **kw),
                         reps=3, warmup=1)
    unb = {k: v for k, v in kw.items() if k not in ("banded", "bandwidth")}
    unb_ms = time_cuda(torch, lambda: tk.score_align(*args, **unb))
    e2e_ms = time_host(lambda: bal.banded_nw_batch(qs, rs))
    with stages.measuring():
        for _ in range(3):
            bal.banded_nw_batch(qs, rs)
        snap = stages.snapshot()
    per_call = {k: v["ms"] / 3 for k, v in snap.items() if "ms" in v}
    cells = band_cells(batch.qlen, batch.rlen, bw)
    full = int((batch.qlen.astype(np.int64) * batch.rlen).sum())
    log(f"[15 timing] card: {card}")
    b = sweep_bound("score", args, kw, cells)
    form = tk.band_plan(len(qs), batch.qp, batch.ridx.shape[1],
                        batch.table.shape[0], bw)
    log(f"[15 timing] {len(qs)} pairs Qp={batch.qidx.shape[1]} "
        f"Rp={batch.ridx.shape[1]} NW 11/1, bw {bw}: banded warp form "
        f"({form} lanes a pair, rows a block) median {ms} ms a call "
        f"({cells} band cells, {cells / ms / 1e6} GCUPS); the score class "
        f"on the masked full sweep (short form) {masked_ms} ms a call; "
        f"plain {plain_ms} ms; bound "
        f"{b['bound_ms']} ms "
        f"({b['bound_by']}); unbanded score kernel on the same batch "
        f"{unb_ms} ms ({full} cells, {full / unb_ms / 1e6} GCUPS) [{card}]")
    log(f"[15 timing] banded_nw_batch {len(qs)} pairs e2e median {e2e_ms} ms "
        f"({len(qs) / e2e_ms * 1e3} aln/s); stages, ms per call: "
        f"{json.dumps(per_call)} [{card}]")
    rows = {"score": {"launches": launches, "ms": ms, "plain_ms": plain_ms,
                      "e2e_ms": e2e_ms, "masked_ms": masked_ms, **b},
            "score_block": wide}

    # -- 15. every banded class and mode at full width ---------------------------
    rows.update(banded_classes(torch, tk, tw, dispatch, card, batch, bw))
    rows["score"]["long"], long_inputs = long_banded(torch, pt, tk, card,
                                                     errs)
    for cls, row in rows.items():
        row["max_abs_err"] = errs.get(cls, row.get("max_abs_err"))
    # the kernels alone are profiled in phase 29 (kernel_times)
    rows["inputs"] = {"cfg2": (args, kw), "long": long_inputs,
                      "wide": wide_inputs}
    return rows


def band_forms(torch, tk, card) -> int:
    """The banded warp form at every (G, kR) it has, each at the widest
    band it reaches, on 256 DNA pairs longer than the band (lengths no
    multiple of kR, one side far shorter on a few), NW, SG and SW in turn,
    against the plain version; and a band one past each form's reach, which
    that form refuses.  Its pairs come from a generator of their own (numpy
    seed 12).  Returns the largest error (0)."""
    from parasail_rs_tpu_torch.matrices import Matrix

    rng = np.random.default_rng(12)
    dev = torch.device("cuda")
    dna = Matrix.create(DNA, 2, -3)
    err = 0
    for n, form in enumerate(BAND_FORMS):
        bw = band_reach(form)
        hi = 2 * bw + 40
        qs = random_seqs(rng, DNA, 256, 2 * bw + 1, hi)
        rs = random_seqs(rng, DNA, 256, 2 * bw + 1, hi)
        qs[:4] = [q[:9 + k] for k, q in enumerate(qs[:4])]
        args, subs = pack_table(torch, dev, dna, qs, rs, hi)
        mode, free = BANDED_MODES[n % 3]
        if mode == "sg":
            free = SG_FREE[n % len(SG_FREE)]
        kw = dict(open_=4, ext=1, mode=mode, free=free, width="sat",
                  banded=True, bandwidth=bw, **subs)
        tk._BAND_FORM = form
        try:
            before = tk.BANDED_WARP_LAUNCHES
            err = max(err, compare(torch, tk, f"warp form {form} bw {bw}",
                                   args, kw))
            if tk.BANDED_WARP_LAUNCHES != before + 1:
                raise AssertionError(f"warp form {form} did not launch")
            try:
                tk.score_align(*args, **dict(kw, bandwidth=bw + 1))
            except RuntimeError:
                pass
            else:
                raise AssertionError(f"warp form {form} took bw {bw + 1}, "
                                     "past its reach")
        finally:
            tk._BAND_FORM = None
    log(f"[15 banded warp forms] every (G, kR) of {BAND_FORMS} at the widest "
        "band it reaches, 256 DNA pairs longer than the band, NW / SG / SW "
        "in turn: equal to plain; one past its reach refused [" + card + "]")
    return err


def wide_band(torch, pt, tk, tw, dispatch, card) -> tuple:
    """``banded_nw_batch`` of 64 DNA pairs of 700-1,000 bp at bw 200, past
    the warp form's reach (bw 140), counted from zero: it must launch the
    block kernel's masked full sweep (past 256 query rows) once, and
    nothing else, on "cuda_kernel", and equal the plain version; then
    that launch timed (a call by CUDA events; the kernel alone in phase
    29) beside the plain version and its bounds.  Its pairs come from a
    generator of their own (numpy seed 13).  Returns its row and inputs."""
    rng = np.random.default_rng(13)
    dna = pt.Matrix.create(DNA, 2, -3)
    bw = 200
    qs = random_seqs(rng, DNA, 64, 700, 1000)
    rs = random_seqs(rng, DNA, 64, 700, 1000)
    al = (pt.Aligner.new().matrix(dna).gap_open(5).gap_extend(1)
          .bandwidth(bw).build())
    dispatch.ROUTE_COUNTS.clear()
    reset_launches(tk, tw)
    res = al.banded_nw_batch(qs, rs)
    launches = (tk.BANDED_WARP_LAUNCHES, dict(tk.BANDED_CLASS_LAUNCHES),
                dict(tk.BANDED_FORM_LAUNCHES))
    routes = dict(dispatch.ROUTE_COUNTS)
    if launches != (0, {**dict.fromkeys(tk.OUTPUTS, 0), "score": 1},
                    {"short": 0, "block": 1}) or \
            set(routes) != {("cuda_kernel", "")} or \
            sum(tk.SHORT_LAUNCHES.values()) or tk.CHUNKED_LAUNCHES:
        raise AssertionError(f"banded_nw_batch at bw {bw} launched (ring, "
                             f"masked by class, by form) {launches} on "
                             f"{routes}")
    plain = plain_of_banded(tk, al, qs, rs, bw)
    check_against_plain(f"banded_nw_batch 64 x 700-1,000 bp bw {bw}", res,
                        plain)
    batch, _, _ = al._pack(qs, rs)
    args = (batch.ridx, batch.qlen_t, batch.rlen_t)
    kw = dict(open_=5, ext=1, mode="nw", free=F4, width="32",
              table=batch.table, qidx=batch.qidx, banded=True, bandwidth=bw)
    err = compare(torch, tk, f"the bw {bw} batch", args, kw)
    ms = time_cuda(torch, lambda: tk.score_align(*args, **kw), reps=5,
                   warmup=1)
    plain_ms = time_cuda(torch, lambda: tk.score_align_plain(*args, **kw),
                         reps=1, warmup=0)
    e2e_ms = time_host(lambda: al.banded_nw_batch(qs, rs), reps=3)
    cells = band_cells(batch.qlen, batch.rlen, bw)
    b = sweep_bound("score", args, kw, cells)
    full = sweep_bound("score", args, kw)
    Qp, Rp = batch.qidx.shape[1], batch.ridx.shape[1]
    form = plan_note(tk, "score", 64, Qp, Rp, batch.table.shape[0])
    log(f"[15 banded path] banded_nw_batch of 64 DNA pairs of 700-1,000 bp "
        f"at bw {bw} (past the warp form's reach): the block kernel's "
        f"masked sweep ({form}) launched once on {routes}, equal to plain")
    log(f"[15 timing] the bw {bw} batch (64 pairs, Qp {Qp}, Rp {Rp}): the "
        f"block kernel's masked sweep median {ms} ms a call ({cells} band "
        f"cells; bound {b['bound_ms']} ms, {b['bound_by']}; the masked "
        f"sweep's every cell {full['bound_ms']} ms); plain {plain_ms} ms; "
        f"banded_nw_batch e2e median {e2e_ms} ms [{card}]")
    return ({"launches": 1, "ms": ms, "plain_ms": plain_ms,
             "e2e_ms": e2e_ms, "max_abs_err": err, "form": form,
             "full_bound_ms": full["bound_ms"], **b}, (args, kw))


def plain_of_banded(tk, aligner, qs, rs, bw) -> dict:
    """The plain version's NW outputs of ``banded_nw_batch``'s batch."""
    batch, _, _ = aligner._pack(qs, rs)
    out = tk.score_align_plain(
        batch.ridx, batch.qlen_t, batch.rlen_t, open_=aligner.gap_open,
        ext=aligner.gap_extend, mode="nw", free=F4, width="32",
        table=batch.table, qidx=batch.qidx, banded=True, bandwidth=bw)
    return {k: v.cpu().numpy() for k, v in out.items()}


def banded_classes(torch, tk, tw, dispatch, card, batch, bw) -> dict:
    """The banded slice on the 8,192 BLOSUM62 pairs (Qp = Rp = 192), 11/1,
    bw 16: every class under NW, SG (all ends free) and SW through
    ``dispatch.launch`` once, counted from zero: the score class must take
    the ring, every other class the short form's masked sweep and no other
    form; each held to the plain version on its first 1,024 pairs (the
    trace class also walked); then each timed, beside its bound over the
    band's cells and over every cell (what a masked full sweep can reach).
    Returns the six non-score classes' rows."""
    n_check = 1024
    width = "32"
    subset = (batch.ridx[:n_check], batch.qlen_t[:n_check],
              batch.rlen_t[:n_check])
    sub_kw = dict(table=batch.table, qidx=batch.qidx[:n_check])
    dispatch.ROUTE_COUNTS.clear()
    reset_banded_launches(tk)
    peaks = {}
    for cls in tk.OUTPUTS:
        for mode, free in BANDED_MODES:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = dispatch.launch(batch, gap_open=11, gap_extend=1, mode=mode,
                                  free=free, outputs=cls, width=width,
                                  banded=True, bandwidth=bw)
            torch.cuda.synchronize()
            peaks[(cls, mode)] = (torch.cuda.max_memory_allocated() -
                                  base) / 2 ** 20
            want = tk.score_align_plain(
                *subset, open_=11, ext=1, mode=mode, free=free, width=width,
                outputs=cls, banded=True, bandwidth=bw, **sub_kw)
            got = {k: v[:n_check] for k, v in out.items()}
            err = max_abs_diff(got, want)
            if err:
                raise AssertionError(f"banded {cls} {mode} at {batch.size} x "
                                     f"{batch.qp}: kernel != plain on the "
                                     f"first {n_check} pairs, max |diff| "
                                     f"{err}")
            if cls == "trace":
                walk = (got["trace_table"], sub_kw["qidx"], subset[0],
                        got["end_query"], got["end_ref"], mode, free)
                werr = max_abs_diff(dict(zip("obr", tw.device_walk(*walk))),
                                    dict(zip("obr",
                                             tw.device_walk_plain(*walk))))
                if werr:
                    raise AssertionError(f"banded {mode}: walk kernel != "
                                         f"plain, max |diff| {werr}")
            del out, got, want
    launches = banded_launches(tk)
    forms = dict(tk.BANDED_FORM_LAUNCHES)
    routes = dict(dispatch.ROUTE_COUNTS)
    log(f"[15 banded classes] launches {launches} (score: warp form "
        f"{tk.BANDED_WARP_LAUNCHES}; the masked sweep by form {forms}), "
        f"routes {routes}")
    n = len(BANDED_MODES)
    if any(launches[cls] != n for cls in tk.OUTPUTS) or \
            tk.BANDED_WARP_LAUNCHES != n or \
            forms != {"short": n * (len(tk.OUTPUTS) - 1), "block": 0}:
        raise AssertionError(f"the banded slice launched {launches}, by "
                             f"form {forms}, expected {n} a class, the "
                             "score class on the ring and the others on the "
                             "short form")
    if routes != {("cuda_kernel", ""): len(tk.OUTPUTS) * len(BANDED_MODES)}:
        raise AssertionError(f"the banded slice left the kernel route: "
                             f"{routes}")
    log(f"[15 banded classes] {batch.size} BLOSUM62 pairs, Qp = Rp = "
        f"{batch.qp}, 11/1, bw {bw}, every class x NW, SG (all ends free), "
        f"SW on cuda_kernel: the first {n_check} pairs equal to plain, the "
        "trace planes walked by the walk kernel as by the plain walk")

    args = (batch.ridx, batch.qlen_t, batch.rlen_t)
    base_kw = dict(open_=11, ext=1, width=width, table=batch.table,
                   qidx=batch.qidx, banded=True, bandwidth=bw)
    cells = band_cells(batch.qlen, batch.rlen, bw)
    log(f"[15 timing] banded classes, card: {card}")
    rows = {}
    for cls in tk.OUTPUTS:
        times = {}
        for mode, free in BANDED_MODES:
            kw = dict(base_kw, mode=mode, free=free, outputs=cls)
            times[mode] = time_cuda(torch, lambda: tk.score_align(*args, **kw),
                                    reps=5, warmup=1)
        kw = dict(base_kw, mode="nw", free=F4, outputs=cls)
        plain_ms = time_cuda(torch,
                             lambda: tk.score_align_plain(*args, **kw),
                             reps=1, warmup=0)
        # the unbanded class on the same pairs: what the mask costs
        unb = {k: v for k, v in kw.items() if k not in ("banded",
                                                       "bandwidth")}
        unb_ms = time_cuda(torch, lambda: tk.score_align(*args, **unb),
                           reps=5, warmup=1)
        b = sweep_bound(cls, args, kw, cells)
        full = sweep_bound(cls, args, kw)
        log(f"[15 timing] banded {cls}, {batch.size} x {batch.qp}^2 bw {bw}: "
            f"kernel median NW {times['nw']} ms, SG {times['sg']} ms, SW "
            f"{times['sw']} ms; unbanded NW {unb_ms} ms; plain (NW, one run) "
            f"{plain_ms} ms; bound {b['bound_ms']} ms ({b['bound_by']}), "
            f"over every cell {full['bound_ms']} ms ({full['bound_by']}); "
            f"peak device memory of "
            f"one call NW / SG / SW "
            f"{' / '.join(str(peaks[(cls, m)]) for m, _ in BANDED_MODES)} "
            f"MiB above the inputs [{card}]")
        if cls != "score":
            rows[cls] = {"launches": launches[cls], "ms": times["nw"],
                         "sg_ms": times["sg"], "sw_ms": times["sw"],
                         "unbanded_ms": unb_ms, "plain_ms": plain_ms,
                         "full_bound_ms": full["bound_ms"], **b}
    return rows


def long_banded(torch, pt, tk, card, errs) -> dict:
    """``banded_nw_batch`` of 128 DNA pairs of 4,096 bp at bw 64, NW 5/1
    (K1e's band-only score form as the long-read banded path), counted
    from zero: the warp form must launch; 8 pairs against the plain
    version, all 128 against the masked full sweep (the block kernel's,
    forced); the warp form and the masked sweep timed (a call by CUDA
    events, the kernel by torch.profiler) and the call end to end with its
    stage clocks.  Its
    pairs come from a generator of their own (numpy seed 15), so that the
    later phases draw what they drew before.  Returns the times."""
    from parasail_rs_tpu_torch.ops import trace_walk as tw
    from parasail_rs_tpu_torch.utils import stages

    rng = np.random.default_rng(15)
    dna = pt.Matrix.create(DNA, 2, -3)
    bw = 64
    qs = random_seqs(rng, DNA, 128, LONG_LEN, LONG_LEN)
    rs = random_seqs(rng, DNA, 128, LONG_LEN, LONG_LEN)
    al = (pt.Aligner.new().matrix(dna).gap_open(5).gap_extend(1)
          .bandwidth(bw).build())
    reset_launches(tk, tw)
    res = al.banded_nw_batch(qs, rs)
    launches = (tk.BANDED_WARP_LAUNCHES, tk.BANDED_CLASS_LAUNCHES["score"])
    if launches != (1, 0):
        raise AssertionError(f"the long banded batch launched (warp, "
                             f"masked sweep) {launches}")
    batch, _, _ = al._pack(qs, rs)
    args = (batch.ridx, batch.qlen_t, batch.rlen_t)
    kw = dict(open_=5, ext=1, mode="nw", free=F4, width="32",
              table=batch.table, qidx=batch.qidx, banded=True, bandwidth=bw)
    n = 8
    plain = {k: v.cpu().numpy() for k, v in tk.score_align_plain(
        *(a[:n] for a in args), **dict(kw, qidx=batch.qidx[:n])).items()}
    check_against_plain(f"banded_nw_batch 128 x {LONG_LEN} bp bw {bw}",
                        res[:n], plain)
    warp = tk.score_align(*args, **kw)
    masked = banded_masked(tk, lambda: tk.score_align(*args, **kw))
    torch.cuda.synchronize()
    err = max_abs_diff(warp, masked)
    if err:
        raise AssertionError(f"the long banded batch: warp form != "
                             f"the masked sweep, max |diff| {err}")
    errs["score"] = max(errs["score"], err)
    ms = time_cuda(torch, lambda: tk.score_align(*args, **kw), reps=5,
                   warmup=1)
    masked_ms = banded_masked(tk, lambda: time_cuda(
        torch, lambda: tk.score_align(*args, **kw), reps=3, warmup=1))
    e2e_ms = time_host(lambda: al.banded_nw_batch(qs, rs), reps=3)
    with stages.measuring():
        for _ in range(3):
            al.banded_nw_batch(qs, rs)
        snap = stages.snapshot()
    per_call = {k: v["ms"] / 3 for k, v in snap.items() if "ms" in v}
    cells = band_cells(batch.qlen, batch.rlen, bw)
    b = sweep_bound("score", args, kw, cells)
    form = tk.band_plan(128, batch.qp, batch.ridx.shape[1],
                        batch.table.shape[0], bw)
    log(f"[15 timing] banded_nw_batch 128 DNA pairs of {LONG_LEN} bp, NW "
        f"5/1, bw {bw}: warp form launched ({form} lanes, rows), the first "
        f"{n} pairs equal to plain, all 128 to the masked sweep; warp "
        f"form median {ms} ms a call ({cells} band cells, "
        f"{cells / ms / 1e6} GCUPS; bound {b['bound_ms']} ms, "
        f"{b['bound_by']}); the block kernel's masked sweep {masked_ms} ms a "
        f"call; e2e "
        f"median {e2e_ms} ms; stages, ms per call: {json.dumps(per_call)} "
        f"[{card}]")
    return ({"ms": ms, "masked_ms": masked_ms, "e2e_ms": e2e_ms,
             "bound_ms": b["bound_ms"]}, (args, kw))


def check_fields(name, got, want) -> None:
    """Every field of every alignment equal; raises on the first
    difference."""
    for b, (x, y) in enumerate(zip(got, want)):
        keys = sorted(y.fields.keys())
        if sorted(x.fields.keys()) != keys:
            raise AssertionError(f"{name}: pair {b} fields differ")
        for k in keys:
            if not np.array_equal(np.asarray(x.fields[k]),
                                  np.asarray(y.fields[k])):
                raise AssertionError(f"{name}: pair {b} {k} differs")


def merged_cigar(ops) -> str:
    """A CIGAR's (count, op) runs, a golden walk's ``ops`` or a parsed
    string, as SSW's CIGAR: '=' and 'X' merged into 'M'."""
    runs: list = []
    for n, op in ops:
        op = "M" if op in "=X" else op
        if runs and runs[-1][1] == op:
            runs[-1][0] += n
        else:
            runs.append([n, op])
    return "".join(f"{n}{op}" for n, op in runs)


def ssw_view(results) -> list:
    return [(s.score1, s.read_begin1, s.read_end1, s.ref_begin1, s.ref_end1,
             s.cigar_string()) for s in results]


def many_path(torch, pt, tk, tw, dispatch, golden, stages, rng, blosum, card,
              sw_pairs) -> dict:
    """Phases 16-17: align_many and SSW, with their timings; returns the
    128 x 4,096 bp batch and its pairs."""
    from parasail_rs_tpu_torch.batch import merge_bins, plan_bins

    # -- 16. align_many ---------------------------------------------------------
    dna = pt.Matrix.create(DNA, 2, -3)
    mq = random_seqs(rng, DNA, 256, 100, 2000)         # cfg5
    mr = random_seqs(rng, DNA, 256, 100, 2000)
    mx = pt.Aligner.new().gap_open(5).gap_extend(2).local().build()
    sq = random_seqs(rng, PROTEIN, 512, 20, 400)
    sr = random_seqs(rng, PROTEIN, 512, 20, 400)
    st_al = (pt.Aligner.new().matrix(blosum).gap_open(11).gap_extend(1)
             .local().use_stats().build())
    tq = random_seqs(rng, DNA, 256, 50, 500)
    tr = random_seqs(rng, DNA, 256, 50, 500)
    tr_al = (pt.Aligner.new().matrix(dna).gap_open(5).gap_extend(2)
             .semi_global().use_trace().build())
    lq = random_seqs(rng, DNA, 128, LONG_LEN, LONG_LEN)   # cfg6 at a quarter
    lr = random_seqs(rng, DNA, 128, LONG_LEN, LONG_LEN)
    lg = pt.Aligner.new().gap_open(5).gap_extend(1).local().build()
    dispatch.ROUTE_COUNTS.clear()
    reset_launches(tk, tw)
    res5 = mx.align_many(mq, mr)
    # cfg5's bins: the short form up to 256 rows, the block kernel's
    # one-shot form past them (score_align's two one-shot forms; the
    # block kernel's score class on the packed form)
    packed5 = tk.SEGMENT16_LAUNCHES
    one_shot5 = tk.SHORT_LAUNCHES["score"] + tk.CHUNKED_LAUNCHES + packed5
    res_st = st_al.align_many(sq, sr)
    res_tr = tr_al.align_many(tq, tr)
    t0 = time.perf_counter()
    res_long = lg.align_many(lq, lr)
    long_s = time.perf_counter() - t0
    # the long pairs' segments: the packed form's, and the int32 form's
    launches = {"score": one_shot5, "stats": tk.SHORT_LAUNCHES["stats"],
                "trace": tk.SHORT_LAUNCHES["trace"],
                "segment": tk.SEGMENT_LAUNCHES + tk.SEGMENT16_LAUNCHES -
                packed5}
    routes = dict(dispatch.ROUTE_COUNTS)
    nbins = len(merge_bins(plan_bins([len(q) for q in mq],
                                     [len(r) for r in mr], max_cells=1 << 33,
                                     lane_quantum=128),
                           max_launches=8, max_cells=1 << 33))
    log(f"[16 align_many] launches={launches} (the packed form "
        f"{tk.SEGMENT16_LAUNCHES}, {packed5} of them cfg5's) routes={routes}"
        f"; cfg5 in {nbins} bins")
    # every bin is one launch of a one-shot form or, for long pairs, a
    # chain of the segment kernel's
    if min(launches.values()) < 1 or \
            launches["score"] + launches["segment"] < nbins + 1:
        raise AssertionError(f"align_many did not launch every kernel: "
                             f"{launches}")
    if set(routes) != {("cuda_kernel", ""), ("cuda_segments", "long pairs")}:
        raise AssertionError(f"align_many left the kernel routes: {routes}")
    check_fields("cfg5 align_many against align_batch", res5,
                 mx.align_batch(mq, mr))
    check_against_plain("cfg5 align_many", res5, plain_of(tk, mx, mq, mr))
    check_fields("stats align_many against align_batch", res_st,
                 st_al.align_batch(sq, sr))
    check_fields("trace align_many against align_batch", res_tr,
                 tr_al.align_batch(tq, tr))
    check_against_plain("128 x 4096 bp, first 16 pairs", res_long[:16],
                        plain_of(tk, lg, lq[:16], lr[:16]))
    log(f"[16 align_many] cfg5 (256 DNA pairs of 100-2,000 bp, SW 5/2) equal "
        f"to align_batch and to plain; use_stats (512 BLOSUM62 pairs of "
        f"20-400) and use_trace (256 SG DNA pairs of 50-500) equal to "
        f"align_batch; 128 x 4,096 bp SW 5/1 in {long_s} s, its first 16 "
        f"pairs equal to plain")

    # -- 17. SSW ----------------------------------------------------------------
    qs, rs = (x[:1024] for x in sw_pairs)

    def ssw_aligners(device):
        one = (pt.Aligner.new().matrix(blosum).gap_open(11).gap_extend(1)
               .device(device).build())
        profs = [pt.Aligner.new().profile(pt.Profile.new_ssw(qs[0], blosum,
                                                             size))
                 .gap_open(11).gap_extend(1).device(device).build()
                 for size in (0, 2)]
        return one, profs

    def ssw_runs(one, profs):
        return [ssw_view(one.ssw_batch(qs, rs)),
                ssw_view(one.ssw_batch(qs, rs, windowed=True)),
                *(ssw_view(p.ssw_batch(None, rs)) for p in profs)]

    card_al, card_profs = ssw_aligners("cuda")
    dispatch.ROUTE_COUNTS.clear()
    reset_launches(tk, tw)
    got = ssw_runs(card_al, card_profs)
    launches = {"score": tk.SHORT_LAUNCHES["score"],
                "trace": tk.SHORT_LAUNCHES["trace"],
                "walk": tw.LAUNCHES}
    routes = dict(dispatch.ROUTE_COUNTS)
    log(f"[17 ssw] launches={launches} routes={routes}")
    if min(launches.values()) < 1:
        raise AssertionError(f"SSW did not launch every kernel: {launches}")
    if set(routes) != {("cuda_kernel", "")}:
        raise AssertionError(f"SSW left the kernel route: {routes}")
    names = ("one pass", "windowed", "profile score_size 0",
             "profile score_size 2")
    for name, g, w in zip(names, got, ssw_runs(*ssw_aligners("cpu"))):
        if g != w:
            bad = next(b for b in range(len(g)) if g[b] != w[b])
            raise AssertionError(f"ssw {name} pair {bad}: card {g[bad]} != "
                                 f"cpu {w[bad]}")
    for b in rng.choice(len(qs), size=16, replace=False).tolist():
        g = golden.align_seqs(qs[b], rs[b], blosum, 11, 1, "sw")
        w = golden.walk_trace(g.trace_table, qs[b], rs[b], g.end_query,
                              g.end_ref, "sw")
        want = (g.score, w.beg_query, g.end_query, w.beg_ref, g.end_ref,
                merged_cigar(w.ops))
        if got[0][b] != want:
            raise AssertionError(f"ssw pair {b}: {got[0][b]} != golden "
                                 f"{want}")
        win = got[1][b]
        if (win[0], win[2], win[4]) != (want[0], want[2], want[4]):
            raise AssertionError(f"windowed ssw pair {b}: {win} != golden "
                                 f"{want}")
    capped = sum(s[0] == 255 for s in got[2])
    log(f"[17 ssw] {len(qs)} BLOSUM62 pairs, 11/1: one pass, windowed, and "
        f"a profile at score_size 0 ({capped} pairs capped at 255) and 2, "
        "all on cuda_kernel and equal to the CPU aligner; 16 sampled pairs "
        "equal to golden (windowed: score and ends)")

    # -- timings ------------------------------------------------------------------
    cells5 = sum(len(q) * len(r) for q, r in zip(mq, mr))
    m5_ms = time_host(lambda: mx.align_many(mq, mr), reps=3)
    with stages.measuring():
        for _ in range(3):
            mx.align_many(mq, mr)
        snap = stages.snapshot()
    per_call = {k: v["ms"] / 3 for k, v in snap.items() if "ms" in v}
    b5_ms = time_host(lambda: mx.align_batch(mq, mr), reps=3)
    c27_ms = time_host(lambda: mx.align_many(mq, mr, max_cells=1 << 27),
                       reps=3)
    nb27 = len(merge_bins(plan_bins([len(q) for q in mq],
                                    [len(r) for r in mr], max_cells=1 << 27,
                                    lane_quantum=128),
                          max_launches=8, max_cells=1 << 27))
    lb, _, _ = lg._pack(lq, lr)
    one_ms = time_host(lambda: card_al.ssw_batch(qs, rs), reps=3)
    win_ms = time_host(lambda: card_al.ssw_batch(qs, rs, windowed=True),
                       reps=3)
    log(f"[16 timing] card: {card}")
    log(f"[16 timing] cfg5 align_many ({nbins} bins) e2e median {m5_ms} ms "
        f"({cells5 / m5_ms / 1e6} GCUPS over {cells5} cells); stages, ms "
        f"per call: {json.dumps(per_call)}; align_batch of the same pairs "
        f"(one launch, Qp=Rp=2048) {b5_ms} ms; align_many max_cells=2^27 "
        f"({nb27} bins) {c27_ms} ms [{card}]")
    log(f"[16 timing] 128 x 4,096 bp SW 5/1: align_many (segment route) "
        f"once {long_s * 1e3} ms [{card}]")
    log(f"[17 timing] ssw_batch {len(qs)} BLOSUM62 pairs e2e median: one "
        f"pass {one_ms} ms, windowed {win_ms} ms [{card}]")
    return {"batch": lb, "pairs": (lq, lr)}


def chain_segments(torch, fn, args, seg, kw, bufs=None):
    """``fn`` (score_segment or its plain version) chained left to right
    over ``seg``-column segments of the batch; returns (out, state), the
    trace class's planes concatenated into ``trace_table`` unless ``bufs``
    (two reusable segment buffers) are given, which then receive them."""
    ridx, qlen, rlen = args
    Rp = ridx.shape[1]
    seg = min(seg, Rp)
    nseg = max(1, -(-Rp // seg))
    if nseg * seg != Rp:
        ridx = torch.nn.functional.pad(ridx, (0, nseg * seg - Rp))
    state = out = None
    planes = []
    for si in range(nseg):
        extra = {} if bufs is None else {"trace_out": bufs[si % 2]}
        out, state = fn(ridx[:, si * seg:(si + 1) * seg].contiguous(), qlen,
                        rlen, state, col_offset=si * seg, resume=si > 0,
                        **kw, **extra)
        if "trace_table_seg" in out:
            plane = out.pop("trace_table_seg")
            if bufs is None:
                planes.append(plane)
    if planes:
        out["trace_table"] = torch.cat(planes, dim=2)[:, :, :Rp]
    return out, state


def segment_path(torch, pt, tk, tw, dispatch, golden, stages, rng, card,
                 headline, long_k1) -> dict:
    """Phases 18-20, the segment kernel and the long-pair path; returns
    each class's launches, error and times."""
    dev = torch.device("cuda")
    classes = ("score", "stats", "trace")
    errs = dict.fromkeys(classes, 0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    # -- 18. segment kernel vs plain ---------------------------------------------
    t18 = time.perf_counter()
    B, Qp, Rp, A = 64, 100, 200, 5
    modes = ([("nw", F4)] + [("sg", f) for f in SG_FREE] +
             [("sw", (True,) * 4)])
    n = 0
    for mode, free in modes:
        for open_, ext in ((11, 1), (2, 2), (1, 3)):
            for cls in classes:
                seg = (48, 80, 128)[n % 3]          # 5, 3 and 2 segments
                warps = (0, 1, 2, 8)[n % 4]         # 0: the launcher's pick
                form = BLOCK_FORMS[n % len(BLOCK_FORMS)]
                n += 1
                ql = rng.integers(0, Qp + 1, size=B)
                rl = rng.integers(0, Rp + 1, size=B)
                ql[:7] = (0, 5, Qp, 32, 33, 64, 65)  # empty sides, stripes
                rl[:7] = (7, 0, Rp, seg, seg + 1, 64, 129)
                kw = dict(open_=open_, ext=ext, mode=mode, free=free,
                          outputs=cls, width="sat",
                          table=t(rng.integers(-4, 6, size=(A, A))),
                          qidx=t(rng.integers(0, A, size=(B, Qp))))
                args = (t(rng.integers(0, A, size=(B, Rp))), t(ql), t(rl))
                fname = force_form(tk, cls, warps, form)
                got, gst = chain_segments(torch, tk.score_segment, args, seg,
                                          kw)
                unforce(tk)
                want, wst = chain_segments(torch, tk.score_segment_plain,
                                           args, seg, kw)
                one = tk.score_align(*args, **kw)
                torch.cuda.synchronize()
                name = f"{cls} {mode}{tuple(int(x) for x in free)} " \
                    f"{open_}/{ext} seg {seg} {fname}"
                err = max(max_abs_diff(got, want), max_abs_diff(got, one))
                # the state rows of the pairs' own query rows
                rows = (torch.arange(Qp, device=dev)[None, :] <
                        args[1][:, None]) & (args[2] > 0)[:, None]
                for k in ("h", "f"):
                    err = max(err, int(((gst[k] - wst[k]) * rows).abs().max()))
                if cls == "stats":
                    err = max(err, int(((gst["stats"] - wst["stats"]) *
                                        rows[None]).abs().max()))
                errs[cls] = max(errs[cls], err)
                if err != 0:
                    raise AssertionError(f"segment kernel != plain or "
                                         f"one-shot on {name}: max |diff| "
                                         f"{err}")
        log(f"[18 segment vs plain] {mode}{tuple(int(x) for x in free)}: "
            f"score, stats and trace at 11/1, 2/2, 1/3 in 2-5 segments, 1-8 "
            f"warps a block, 2-8 rows a lane, 1-8 blocks a pair, equal to "
            f"plain and to the one-shot kernel")
    log(f"[18 segment vs plain] {time.perf_counter() - t18:.1f} s")

    # -- 19. the long-pair path through the public API ---------------------------
    q6 = random_seqs(rng, DNA, 128, CFG6_LEN, CFG6_LEN)  # cfg6, full width
    r6 = random_seqs(rng, DNA, 128, CFG6_LEN, CFG6_LEN)
    def mixed():                      # 120 long and 8 short sequences
        lens = np.concatenate([rng.integers(LONG_LEN // 4, LONG_LEN + 1,
                                            size=120),
                               rng.integers(50, 201, size=8)])
        lens[0] = LONG_LEN            # pair 0 sets the padded shape
        return [random_seqs(rng, DNA, 1, n, n)[0] for n in lens.tolist()]

    mq, mr = mixed(), mixed()
    short = list(range(120, 128))

    def sw51():
        return pt.Aligner.new().gap_open(5).gap_extend(1).local()

    al = {"score": sw51().build(), "stats": sw51().use_stats().build(),
          "trace": sw51().use_trace().build()}
    dispatch.ROUTE_COUNTS.clear()
    reset_launches(tk, tw)
    # int32 segment launches by class, and the packed form's ("score16")
    launches = dict.fromkeys(("score16",) + classes, 0)

    def counted(cls, fn):
        before = (tk.SEGMENT_LAUNCHES, tk.SEGMENT16_LAUNCHES)
        out = fn()
        launches[cls] += tk.SEGMENT_LAUNCHES - before[0]
        launches["score16"] += tk.SEGMENT16_LAUNCHES - before[1]
        return out

    res6 = counted("score", lambda: al["score"].align_batch(q6, r6))
    res = {cls: counted(cls, lambda: al[cls].align_batch(mq, mr))
           for cls in classes}
    routes = dict(dispatch.ROUTE_COUNTS)
    log(f"[19 long pairs] segment launches={launches} (short form "
        f"{tk.SHORT_LAUNCHES}, chunked {tk.CHUNKED_LAUNCHES}) "
        f"routes={routes}")
    # the score class on the packed form, no pair flagged (no int32 score
    # launch); stats and trace on the int32 form
    if launches["score16"] < 1 or launches["score"] or \
            launches["stats"] < 1 or launches["trace"] < 1 or \
            sum(tk.SHORT_LAUNCHES.values()) or tk.CHUNKED_LAUNCHES:
        raise AssertionError(f"the long-pair path did not run on the "
                             f"segment kernel alone, score packed: "
                             f"{launches}")
    if {r for r, _ in routes} != {"cuda_segments"} or any(
            {r for r, _ in a.route_counter} != {"cuda_segments"}
            for a in al.values()):
        raise AssertionError(f"the long-pair path left the segment route: "
                             f"{routes}")
    check_against_plain("cfg6, first 4 pairs", res6[:4],
                        plain_of(tk, al["score"], q6[:4], r6[:4]))
    if not all(0 < a.get_score() <= CFG6_LEN and
               0 <= a.get_end_query() < CFG6_LEN and
               0 <= a.get_end_ref() < CFG6_LEN for a in res6):
        raise AssertionError("cfg6: a score or end cell is out of range")
    batch, _, _ = al["score"]._pack(mq, mr)
    margs = (batch.ridx, batch.qlen_t, batch.rlen_t)
    mkw = dict(open_=5, ext=1, mode="sw", free=(True,) * 4, width="sat",
               table=batch.table, qidx=batch.qidx)
    for cls in classes:
        one = tk.score_align(*margs, **mkw, outputs=cls)
        plane = one.pop("trace_table", None)
        one = {k: v.cpu().numpy() for k, v in one.items()}
        for b, a in enumerate(res[cls]):
            for k, v in one.items():
                if a.fields[k] != v[b]:
                    raise AssertionError(f"long pairs {cls}: pair {b} {k} "
                                         f"{a.fields[k]} != one-shot {v[b]}")
        if plane is not None:
            # pair 0 fills the padded shape: its view's base is the plane
            host = res[cls][0].fields["trace_table"].base
            if host.shape != tuple(plane.shape):
                raise AssertionError(f"trace plane of shape {host.shape}")
            for b in range(0, 128, 16):          # 16 pairs at a time
                if not torch.equal(torch.from_numpy(host[b:b + 16]).to(dev),
                                   plane[b:b + 16]):
                    raise AssertionError(f"long pairs trace: planes of "
                                         f"pairs {b}-{b + 15} differ from "
                                         f"the one-shot kernel's")
            del plane, host
    m = pt.Matrix.default()
    for b in short:
        g = golden.align_seqs(mq[b], mr[b], m, 5, 1, "sw")
        w = golden.walk_trace(g.trace_table, mq[b], mr[b], g.end_query,
                              g.end_ref, "sw")
        for cls in classes:
            a = res[cls][b]
            if (a.get_score(), a.get_end_query(), a.get_end_ref()) != \
                    (g.score, g.end_query, g.end_ref):
                raise AssertionError(f"long pairs {cls}: pair {b} differs "
                                     f"from golden")
        a = res["stats"][b]
        if (a.get_matches(), a.get_similar(), a.get_length()) != \
                (g.matches, g.similar, g.length):
            raise AssertionError(f"long pairs stats: pair {b} differs from "
                                 f"golden")
        a = res["trace"][b]
        if not np.array_equal(a.fields["trace_table"], g.trace_table) or \
                a.get_cigar(mq[b], mr[b]) != w.cigar_string():
            raise AssertionError(f"long pairs trace: pair {b} differs from "
                                 f"golden")
    log(f"[19 long pairs] cfg6 (128 x 16,384 bp SW 5/1) on cuda_segments, "
        f"its first 4 pairs equal to plain; 128 pairs of 50-4,096 bp "
        f"(Qp=Rp={batch.qp}) score (the packed form), use_stats and "
        f"use_trace on cuda_segments, equal to the one-shot kernel; "
        f"{len(short)} short "
        f"pairs equal to golden (score, end cell, stats, flags, CIGAR)")
    del res

    # -- 20. timings -----------------------------------------------------------------
    def host_once(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    def peak_of(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = host_once(fn)
        return ms, torch.cuda.max_memory_allocated() / 2 ** 20

    cells6 = 128 * CFG6_LEN * CFG6_LEN
    e2e6, peak6 = peak_of(lambda: al["score"].align_batch(q6, r6))
    b6, _, _ = al["score"]._pack(q6, r6)
    args6 = (b6.ridx, b6.qlen_t, b6.rlen_t)
    kw6 = dict(open_=5, ext=1, mode="sw", free=(True,) * 4, width="sat",
               table=b6.table, qidx=b6.qidx, outputs="score")
    seg_cols = dispatch.SEGMENT_COLS
    k6 = time_cuda(torch, lambda: chain_segments(
        torch, tk.score_segment, args6, seg_cols["score"], kw6), reps=1,
        warmup=0)
    plan6 = plan_note(tk, "score", 128, b6.qp, seg_cols["score"],
                      b6.table.shape[0])
    tk.SEGMENT_WARPS = 1
    k6_one = time_cuda(torch, lambda: chain_segments(
        torch, tk.score_segment, args6, seg_cols["score"], kw6), reps=1,
        warmup=0)
    tk.SEGMENT_WARPS = 0
    log(f"[20 timing] card: {card}")
    log(f"[20 timing] cfg6 128 x 16,384 bp SW 5/1: align_batch e2e, one "
        f"call, {e2e6} ms ({cells6 / e2e6 / 1e6} GCUPS), peak device memory "
        f"{peak6} MiB; its two segment launches alone {k6} ms "
        f"({cells6 / k6 / 1e6} GCUPS, {k6 * 1e6 / CFG6_LEN ** 2} ns per "
        f"cell per pair; {plan6}), with one warp a block {k6_one} ms "
        f"[{card}]")
    del b6, args6, kw6

    # one-shot against segment kernel, 128 pairs of 1,024 and 4,096 bp
    lb = long_k1["batch"]
    a4 = (lb.ridx, lb.qlen_t, lb.rlen_t)
    kw4 = dict(open_=5, ext=1, mode="sw", free=(True,) * 4, width="sat",
               table=lb.table, qidx=lb.qidx)
    a1 = (lb.ridx[:, :MID_LEN].contiguous(), lb.qlen_t.clamp(max=MID_LEN),
          lb.rlen_t.clamp(max=MID_LEN))
    kw1 = {**kw4, "qidx": lb.qidx[:, :MID_LEN].contiguous()}
    times, plain_out = {}, {}
    for cls in ("score", "stats"):
        k1_1024 = time_cuda(torch, lambda: tk.score_align(
            *a1, **kw1, outputs=cls), reps=3, warmup=1)
        k2_1024 = time_cuda(torch, lambda: chain_segments(
            torch, tk.score_segment, a1, MID_LEN, {**kw1, "outputs": cls}),
            reps=5)
        kept = {}
        k2_4096 = time_cuda(torch, lambda: kept.update(got=chain_segments(
            torch, tk.score_segment, a4, seg_cols[cls],
            {**kw4, "outputs": cls})[0]), reps=5)
        tk.SEGMENT_WARPS = 1
        k2_one = time_cuda(torch, lambda: chain_segments(
            torch, tk.score_segment, a4, seg_cols[cls],
            {**kw4, "outputs": cls}), reps=3)
        tk.SEGMENT_WARPS = 0
        plain_4096 = time_cuda(torch, lambda: kept.update(want=chain_segments(
            torch, tk.score_segment_plain, a4, seg_cols[cls],
            {**kw4, "outputs": cls})[0]), reps=1, warmup=0)
        times[cls] = (k2_4096, plain_4096)
        plain_out[cls] = kept["want"]
        errs[cls] = max(errs[cls], max_abs_diff(kept["got"], kept["want"]))
        if errs[cls] != 0:
            raise AssertionError(f"segment kernel != plain on 128 x 4,096 bp "
                                 f"({cls}): max |diff| {errs[cls]}")
        log(f"[20 timing] {cls} class, 128 pairs SW 5/1: 1,024 bp the block "
            f"kernel's one-shot form {k1_1024} ms, segment kernel {k2_1024} "
            f"ms; 4,096 bp segment kernel {k2_4096} ms (the one-shot form: "
            f"phase 27) "
            f"({128 * LONG_LEN ** 2 / k2_4096 / 1e6} GCUPS; "
            f"{plan_note(tk, cls, 128, lb.qp, seg_cols[cls], lb.table.shape[0])}"
            f"); with one warp a block {k2_one} ms; its plain version "
            f"{plain_4096} ms [{card}]")
    # the packed score form on the same tensors, held to the same plain
    # version (the main path's form of the score class since phase 19)
    kw16 = {**kw4, "outputs": "score", "bound": lb.score_bound,
            "units": dispatch.packed_units(lb, "cuda_segments", "score", 5,
                                           1)}
    kept = {}
    k16_4096 = time_cuda(torch, lambda: kept.update(got=chain_segments(
        torch, tk.score_segment, a4, seg_cols["score"], kw16)[0]), reps=5)
    over = int(kept["got"].pop("over16").sum())
    err16 = max_abs_diff(kept["got"], plain_out["score"])
    if over or err16:
        raise AssertionError(f"packed segment form != plain on 128 x 4,096 "
                             f"bp (score): {over} pairs flagged, max |diff| "
                             f"{err16}")
    plan16 = tk.segment16_plan(-(-lb.size // 2), lb.qp, seg_cols["score"],
                               lb.table.shape[0])
    log(f"[20 timing] score class, 128 pairs SW 5/1, 4,096 bp: the packed "
        f"segment form {k16_4096} ms "
        f"({128 * LONG_LEN ** 2 / k16_4096 / 1e6} GCUPS; R {plan16[0]}, "
        f"{plan16[1]} warps, C {plan16[2]}, {-(-lb.size // 2)} units), the "
        f"int32 form {times['score'][0]} ms, its plain version "
        f"{times['score'][1]} ms; equal to plain, no pair flagged [{card}]")
    st_e2e, st_peak = peak_of(lambda: al["stats"].align_batch(mq, mr))
    log(f"[20 timing] use_stats align_batch of the 128 pairs of 50-4,096 bp "
        f"e2e, one call, {st_e2e} ms, peak device memory {st_peak} MiB "
        f"[{card}]")

    # the trace class: kernels alone (two buffers, no copy) and end to end
    tkw = {**kw4, "outputs": "trace"}
    bufs = [torch.empty((128, LONG_LEN, min(seg_cols["trace"], LONG_LEN)),
                        dtype=torch.int8, device=dev) for _ in range(2)]
    tr_k2 = time_cuda(torch, lambda: chain_segments(
        torch, tk.score_segment, a4, seg_cols["trace"], tkw, bufs=bufs),
        reps=3)
    del bufs
    kept = {}
    tr_plain = time_cuda(torch, lambda: kept.update(want=chain_segments(
        torch, tk.score_segment_plain, a4, seg_cols["trace"], tkw)[0]),
        reps=1, warmup=0)
    got = chain_segments(torch, tk.score_segment, a4, seg_cols["trace"],
                         tkw)[0]
    if not torch.equal(got.pop("trace_table"),
                       kept["want"].pop("trace_table")):
        raise AssertionError("segment kernel != plain on 128 x 4,096 bp: "
                             "the trace planes differ")
    errs["trace"] = max(errs["trace"], max_abs_diff(got, kept["want"]))
    if errs["trace"] != 0:
        raise AssertionError(f"segment kernel != plain on 128 x 4,096 bp "
                             f"(trace): max |diff| {errs['trace']}")
    del got, kept
    lq4, lr4 = long_k1["pairs"]
    tr_e2e, tr_peak = peak_of(lambda: al["trace"].align_batch(lq4, lr4))
    with stages.measuring():
        al["trace"].align_batch(lq4, lr4)
        snap = stages.snapshot()
    per_call = {k: v["ms"] for k, v in snap.items() if "ms" in v}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one_ms = time_cuda(torch, lambda: tk.score_align(*a4, **tkw), reps=1,
                       warmup=0)
    one_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    times["trace"] = (tr_k2, tr_plain)
    log(f"[20 timing] trace class, 128 x 4,096 bp SW 5/1 (a 2 GiB plane): "
        f"segment kernel, {-(-LONG_LEN // seg_cols['trace'])} launches into "
        f"two buffers ("
        f"{plan_note(tk, 'trace', 128, lb.qp, seg_cols['trace'], lb.table.shape[0])}"
        f"), {tr_k2} ms, its plain version {tr_plain} ms; use_trace "
        f"align_batch e2e, one call, {tr_e2e} "
        f"ms, peak device memory {tr_peak} MiB; stages, ms: "
        f"{json.dumps(per_call)}; the one-shot trace kernel on the same "
        f"batch, one call, {one_ms} ms with the plane on the card, peak "
        f"{one_peak} MiB [{card}]")

    # bench.py's headline batch through the segment kernel
    head_args, head_kw = headline
    hk = {**head_kw, "outputs": "score"}
    h_k2 = time_cuda(torch, lambda: chain_segments(
        torch, tk.score_segment, head_args, 160, hk))
    h_k1 = time_cuda(torch, lambda: tk.score_align(*head_args, **hk))
    h_plan = plan_note(tk, "score", head_args[0].shape[0],
                       hk["profile"].shape[1], 160, hk["profile"].shape[2],
                       profile=True)
    log(f"[20 timing] headline B=8192 Qp=Rp=160 SW 11/1: segment kernel "
        f"{h_k2} ms ({h_plan}), one-shot kernel {h_k1} ms [{card}]")
    out = {cls: {"launches": launches[cls], "max_abs_err": errs[cls],
                 "ms": times[cls][0], "plain_ms": times[cls][1],
                 "shape": "128 pairs, Qp=Rp=4096, SW 5/1",
                 "form": plan_note(tk, cls, 128, lb.qp, seg_cols[cls],
                                   lb.table.shape[0]),
                 # the state between segments is neither input nor output:
                 # a chain's bound is the one-shot sweep's
                 **sweep_bound(cls, a4, kw4)}
           for cls in classes}
    out["score16"] = {
        "launches": launches["score16"], "max_abs_err": err16,
        "ms": k16_4096, "plain_ms": times["score"][1],
        "shape": "128 pairs, Qp=Rp=4096, SW 5/1",
        "form": f"R {plan16[0]}, {plan16[1]} warps, C {plan16[2]}, "
                f"{-(-lb.size // 2)} units of two pairs",
        # 16x2 DPX: one operation computes a cell of each of two pairs
        **sweep_bound("score", a4, kw4, lanes=2)}
    # the sequence-parallel phases run the same pairs
    out["pairs"] = {"cfg6": (q6, r6), "mixed": (mq, mr), "short": short,
                    "aligners": al, "k6_ms": k6}
    return out


def chain_tiles(torch, tk, tile_fn, args, subs, D, qc, kw):
    """``tile_fn`` (score_rowseg or its plain version) over the S x D
    tiles of the batch, through ``dist.seqpar_scan.pipeline`` on D
    virtual shards (shard d runs row chunk t at superstep t + d, each
    tile's right-going state handed to the next shard and its down-state
    to the next row chunk).  Returns (out, records): the outputs read off
    the merged accumulator (+ ``trace_table``), and every tile's (state,
    down-state, trace tile, outputs so far)."""
    from parasail_rs_tpu_torch.dist import make_device_mesh
    from parasail_rs_tpu_torch.dist.seqpar_scan import pipeline

    ridx, qlen, rlen = args
    C = ridx.shape[1] // D
    Qp = (subs["profile"] if subs.get("profile") is not None
          else subs["qidx"]).shape[1]
    records = {}

    def recording(*a, **k):
        tout, state, down, tile = tile_fn(*a, **k)
        records[k["col_offset"] // C, k["row_offset"] // qc] = (
            dict(state), down, tile, tout)
        return tout, state, down, tile

    acc, plane = pipeline(recording, ridx, qlen, rlen,
                          mesh=make_device_mesh(D), q_chunk=qc, subs=subs,
                          kw=kw)
    out = tk.acc_outputs(acc, qlen, rlen, Qp, **kw)
    if plane is not None:
        out["trace_table"] = plane
    return out, records


def records_diff(torch, got, want) -> int:
    """max |difference| over every tile's state, down-state, flags and
    outputs."""
    err = 0
    for key, (ws, wd, wt, wo) in want.items():
        gs, gd, gt, go = got[key]
        err = max(err, max_abs_diff(gs, ws), max_abs_diff(go, wo),
                  int((gd.long() - wd.long()).abs().max().item()))
        if wt is not None:
            err = max(err, int((gt.long() - wt.long()).abs().max().item()))
    return err


def tile_bound(cls: str, cols, qlen, rlen, subs, r0, qc, j0) -> dict:
    """bound() of one tile: its real cells (each pair's rows in
    [r0, r0 + qc) by its columns in [j0, j0 + C)), the inputs it reads
    (letters, lengths, substitution scores and letters of its rows, the
    right-going state, the down-state, the corner and the accumulator)
    and what it writes (the same state again, the outputs and the trace
    tile)."""
    B, C = cols.shape
    rows = (qlen.long() - r0).clamp(0, qc)
    cells = int((rows * (rlen.long() - j0).clamp(0, C)).sum().item())
    stats = cls == "stats"
    state = ((2 + (6 if stats else 0)) * qc + 4 + 8 +
             (8 if stats else 2) * C) * B * 4
    nbytes = cols.numel() * 4 + 2 * B * 4 + 2 * state
    if subs.get("table") is not None:
        nbytes += subs["table"].numel() * 4 + subs["qidx"].shape[0] * qc * 4
    else:
        p = subs["profile"]
        nbytes += p.shape[0] * qc * p.shape[2] * 4
    nbytes += (8 if stats else 5) * B * 4
    if cls == "trace":
        nbytes += B * qc * C
    return bound(cells * OPS_PER_CELL[cls], nbytes)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_path(torch, pt, tk, dispatch, golden, rng, card, protein, sw,
              pairs) -> dict:
    """Phases 21-24, the tile kernel and the dist layer; returns each
    class's launches, error and times."""
    from parasail_rs_tpu_torch import dist
    from parasail_rs_tpu_torch.dist import multihost
    from parasail_rs_tpu_torch.dist.sharded import gather_scores

    dev = torch.device("cuda")
    classes = ("score", "stats", "trace")
    errs = dict.fromkeys(classes, 0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    # -- 21. tile kernel vs plain, segments and the one-shot kernel ---------------
    B, Qp, Rp, A = 64, 192, 192, 5
    modes = ([("nw", F4)] + [("sg", f) for f in SG_FREE] +
             [("sw", (True,) * 4)])
    n = 0
    for mi, (mode, free) in enumerate(modes):
        for pi, (open_, ext) in enumerate(((11, 1), (2, 2), (1, 3))):
            for ci, cls in enumerate(classes):
                D = (1, 3, 4)[n % 3]
                qc = (24, 32, 64)[(n // 3) % 3]
                warps = (0, 1, 2, 8)[n % 4]         # 0: the launcher's pick
                form = BLOCK_FORMS[n % len(BLOCK_FORMS)]
                n += 1
                ql = rng.integers(0, Qp + 1, size=B)
                rl = rng.integers(0, Rp + 1, size=B)
                # empty sides; queries that end above, inside and on a
                # tile's last row; references that end on a shard's edge
                ql[:8] = (0, 5, Qp, qc, qc + 1, 2 * qc - 1, 64, 65)
                rl[:8] = (7, 0, Rp, Rp // D, 65, 64, min(Rp, Rp // D + 1), 129)
                subs = dict(table=t(rng.integers(-4, 6, size=(A, A))),
                            qidx=t(rng.integers(0, A, size=(B, Qp))))
                kw = dict(open_=open_, ext=ext, mode=mode, free=free,
                          outputs=cls, width="sat")
                args = (t(rng.integers(0, A, size=(B, Rp))), t(ql), t(rl))
                fname = force_form(tk, cls, warps, form)
                got, recs = chain_tiles(torch, tk, tk.score_rowseg, args,
                                        subs, D, qc, kw)
                unforce(tk)
                segs, _ = chain_segments(torch, tk.score_segment, args,
                                         Rp // D, {**kw, **subs})
                one = tk.score_align(*args, **kw, **subs)
                err = max(max_abs_diff(got, segs), max_abs_diff(got, one))
                if (mi + ci) % 3 == pi:
                    want, wrecs = chain_tiles(torch, tk,
                                              tk.score_rowseg_plain, args,
                                              subs, D, qc, kw)
                    err = max(err, max_abs_diff(got, want),
                              records_diff(torch, recs, wrecs))
                torch.cuda.synchronize()
                errs[cls] = max(errs[cls], err)
                if err != 0:
                    raise AssertionError(
                        f"tile kernel != plain, segments or one-shot on "
                        f"{cls} {mode}{tuple(int(x) for x in free)} "
                        f"{open_}/{ext} D {D} q_chunk {qc} {fname}: "
                        f"max |diff| {err}")
        log(f"[21 tile vs plain] {mode}{tuple(int(x) for x in free)}: score, "
            f"stats and trace at 11/1, 2/2, 1/3 over 1-4 shards, row chunks "
            f"of 24-64, 1-8 warps a block, 2-8 rows a lane, 1-8 blocks a "
            f"pair, equal to the segment chain and the one-shot kernel; one penalty pair a class equal to plain in "
            f"every tile's state, down-state, flags and outputs")

    # -- 22. the sequence-parallel path on the card ----------------------------------
    al = pairs["aligners"]
    q6, r6 = pairs["cfg6"]
    mq, mr = pairs["mixed"]
    sw51 = dict(open_=5, ext=1, mode="sw", free=(True,) * 4, width="sat")
    b6, _, _ = al["score"]._pack(q6, r6)
    mesh = dist.make_device_mesh(4)

    def seqpar(batch, cls, qc):
        return dist.seqpar_align_scan(
            None, batch.ridx, batch.qlen_t, batch.rlen_t, batch.qidx,
            table=batch.table, mesh=mesh, q_chunk=qc, outputs=cls, **sw51)

    launches = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2 ** 20
    tk.ROWSEG_LAUNCHES = tk.SEGMENT_LAUNCHES = tk.CHUNKED_LAUNCHES = 0
    tk.SHORT_LAUNCHES = dict.fromkeys(tk.SHORT_LAUNCHES, 0)
    out6 = seqpar(b6, "score", CFG6_LEN // 8)
    torch.cuda.synchronize()
    launches["score"] = tk.ROWSEG_LAUNCHES
    peak6 = torch.cuda.max_memory_allocated() / 2 ** 20 - base_mib
    if launches["score"] != 32 or tk.SEGMENT_LAUNCHES or \
            tk.CHUNKED_LAUNCHES or sum(tk.SHORT_LAUNCHES.values()):
        raise AssertionError(
            f"cfg6 through seqpar_align_scan launched the tile kernel "
            f"{launches['score']} times (expected 4 shards x 8 row chunks = "
            f"32), the segment kernel {tk.SEGMENT_LAUNCHES} times, the "
            f"one-shot forms {tk.CHUNKED_LAUNCHES} and "
            f"{tk.SHORT_LAUNCHES} times")
    res6 = al["score"].align_batch(q6, r6)              # the segment kernel
    got6 = {k: v.cpu().numpy() for k, v in out6.items()}
    for b, a in enumerate(res6):
        for k in ("score", "end_query", "end_ref"):
            if a.fields[k] != got6[k][b]:
                raise AssertionError(f"cfg6 seqpar: pair {b} {k} "
                                     f"{got6[k][b]} != align_batch "
                                     f"{a.fields[k]}")
    plain4 = plain_of(tk, al["score"], q6[:4], r6[:4])
    for b in range(4):
        for k in ("score", "end_query", "end_ref"):
            if int(plain4[k][b]) != got6[k][b]:
                raise AssertionError(f"cfg6 seqpar: pair {b} {k} differs "
                                     f"from the plain column sweep")
    log(f"[22 seqpar] cfg6 (128 x {CFG6_LEN} bp SW 5/1) through "
        f"dist.seqpar_align_scan, 4 virtual shards of {CFG6_LEN // 4} "
        f"columns x 8 row chunks of {CFG6_LEN // 8}: tile launches="
        f"{launches['score']}, equal to align_batch (segment kernel), first 4 "
        f"pairs equal to plain; peak device memory above the inputs "
        f"{peak6} MiB [{card}]")
    del out6, res6

    mb, _, _ = al["score"]._pack(mq, mr)
    margs = (mb.ridx, mb.qlen_t, mb.rlen_t)
    mkw = dict(sw51, table=mb.table, qidx=mb.qidx)
    m = pt.Matrix.default()
    peaks = {}
    for cls in ("stats", "trace"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mib = torch.cuda.memory_allocated() / 2 ** 20
        tk.ROWSEG_LAUNCHES = 0
        out = seqpar(mb, cls, LONG_LEN // 4)
        torch.cuda.synchronize()
        launches[cls] = tk.ROWSEG_LAUNCHES
        peaks[cls] = torch.cuda.max_memory_allocated() / 2 ** 20 - base_mib
        if launches[cls] != 16:
            raise AssertionError(f"seqpar {cls}: {launches[cls]} tile "
                                 f"launches, expected 4 x 4 = 16")
        one = tk.score_align(*margs, **mkw, outputs=cls)
        if cls == "trace":
            plane, want_plane = out["trace_table"], one.pop("trace_table")
            for b in range(0, 128, 16):
                if not torch.equal(plane[b:b + 16], want_plane[b:b + 16]):
                    raise AssertionError(
                        f"seqpar trace: planes of pairs {b}-{b + 15} differ "
                        f"from the one-shot kernel's")
            del want_plane
            scal = {k: v for k, v in out.items() if k != "trace_table"}
        else:
            scal = out
        err = max_abs_diff(scal, one)
        errs[cls] = max(errs[cls], err)
        if err != 0:
            raise AssertionError(f"seqpar {cls} != one-shot kernel: max "
                                 f"|diff| {err}")
        host = {k: v.cpu().numpy() for k, v in scal.items()}
        for b in pairs["short"]:
            g = golden.align_seqs(mq[b], mr[b], m, 5, 1, "sw")
            if (host["score"][b], host["end_query"][b],
                    host["end_ref"][b]) != (g.score, g.end_query, g.end_ref):
                raise AssertionError(f"seqpar {cls}: pair {b} differs from "
                                     f"golden")
            if cls == "stats" and (host["matches"][b], host["similar"][b],
                                   host["length"][b]) !=                     (g.matches, g.similar, g.length):
                raise AssertionError(f"seqpar stats: pair {b} differs from "
                                     f"golden")
            if cls == "trace" and not np.array_equal(
                    plane[b, :len(mq[b]), :len(mr[b])].cpu().numpy(),
                    g.trace_table):
                raise AssertionError(f"seqpar trace: pair {b}'s flags differ "
                                     f"from golden")
        if cls == "trace":
            cig = dist.seqpar_cigars(out, mq, mr, "sw")
            _, want_cig = al["score"].align_cigars(mq, mr)
            if cig != list(want_cig):
                bad = [b for b in range(128) if cig[b] != want_cig[b]]
                raise AssertionError(f"seqpar_cigars != align_cigars on "
                                     f"pairs {bad[:8]}")
            del plane
        del out, one, scal
    log(f"[22 seqpar] 128 pairs of 50-{LONG_LEN} bp over 4 shards x 4 row "
        f"chunks of {LONG_LEN // 4}: stats and trace, tile launches="
        f"{launches['stats']} and {launches['trace']}, equal to the one-shot "
        f"kernel (outputs and every flag), seqpar_cigars equal to "
        f"align_cigars, short pairs equal to golden; peak device memory "
        f"above the inputs: stats {peaks['stats']} MiB, trace "
        f"{peaks['trace']} MiB [{card}]")

    # -- 23. data parallelism, a group of one rank -------------------------------------
    import torch.distributed as td

    qs, rs = protein
    batch, _, _ = sw._pack(qs, rs)
    rows = tk._substitution_rows(batch.table, batch.qidx, None).contiguous()
    arrays = (rows, batch.qidx, batch.ridx, batch.qlen, batch.rlen)
    multihost.initialize(f"localhost:{free_port()}", 1, 0)
    try:
        if td.get_backend() != "nccl" or td.get_world_size() != 1:
            raise AssertionError("expected a NCCL group of one rank")
        gmesh = multihost.global_mesh()
        for cls, aligner in (("score", sw),
                             ("stats", pt.Aligner.new().matrix(
                                 sw.matrix).gap_open(11).gap_extend(1)
                                 .local().use_stats().build())):
            want = aligner.align_batch(qs, rs)
            kw = dict(open_=11, ext=1, mode="sw", free=(True,) * 4,
                      outputs=cls, width="sat")
            tk.SHORT_LAUNCHES = dict.fromkeys(tk.SHORT_LAUNCHES, 0)
            res = dist.sharded_align(gmesh, *arrays, **kw)
            whole = multihost.align_global(gmesh, *arrays, **kw)
            ran = tk.SHORT_LAUNCHES[cls]
            if res.route != "cuda_kernel" or ran != 2:
                raise AssertionError(f"sharded_align {cls}: route "
                                     f"{res.route}, {ran} launches")
            keys = ("score", "end_query", "end_ref") +                 (("matches", "similar", "length") if cls == "stats" else ())
            for name, got in (("sharded_align", gather_scores(res)),
                              ("align_global", whole)):
                for k in keys:
                    if got[k].tolist() != [a.fields[k] for a in want]:
                        raise AssertionError(f"{name} {cls}: {k} differs "
                                             f"from align_batch")
    finally:
        td.destroy_process_group()
    del rows, arrays
    log("[23 data parallel] sharded_align and align_global of the 8,192 SW "
        "BLOSUM62 pairs in a NCCL group of one rank, score and stats: on "
        "cuda_kernel, equal to align_batch (one rank shows that the layer "
        "is correct, not that it scales)")

    # -- 24. timings -------------------------------------------------------------------
    def host_once(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    cells6 = 128 * CFG6_LEN * CFG6_LEN
    chain6 = time_cuda(torch, lambda: seqpar(b6, "score", CFG6_LEN // 8),
                       reps=3, warmup=1)
    e2e6 = statistics.median(
        host_once(lambda: seqpar(b6, "score", CFG6_LEN // 8))
        for _ in range(3))
    args6 = (b6.ridx, b6.qlen_t, b6.rlen_t)
    kw6 = dict(sw51, table=b6.table, qidx=b6.qidx, outputs="score")
    k2 = time_cuda(torch, lambda: chain_segments(
        torch, tk.score_segment, args6, dispatch.SEGMENT_COLS["score"], kw6),
        reps=1, warmup=0)
    log(f"[24 timing] card: {card}")
    log(f"[24 timing] cfg6 128 x {CFG6_LEN} bp SW 5/1 through "
        f"seqpar_align_scan, 32 tiles of {CFG6_LEN // 8} rows x "
        f"{CFG6_LEN // 4} columns on one card: {chain6} ms by CUDA events "
        f"({cells6 / chain6 / 1e6} GCUPS, {chain6 * 1e6 / CFG6_LEN ** 2} ns "
        f"per cell per pair; a tile "
        f"{plan_note(tk, 'score', 128, CFG6_LEN // 8, CFG6_LEN // 4, b6.table.shape[0])}"
        f"), {e2e6} ms end to end on the host clock; the "
        f"segment kernel's two launches on the same pairs {k2} ms (phase 20: "
        f"{pairs['k6_ms']} ms) [{card}]")

    # one tile of each class at the main path's shape, beside its plain
    # version on the same inputs
    out = {}
    for cls, batch, qc in (("score", b6, CFG6_LEN // 8),
                           ("stats", mb, LONG_LEN // 4),
                           ("trace", mb, LONG_LEN // 4)):
        Bn, C = batch.size, batch.rp // 4
        subs = dict(table=batch.table, qidx=batch.qidx)
        kw = dict(sw51, outputs=cls)
        bkw = dict(open_=5, ext=1, mode="sw", free=(True,) * 4, outputs=cls,
                   device=dev)
        state = tk.rowseg_left_border(Bn, 0, qc, **bkw)
        state["acc"] = tk.acc_init(Bn, batch.qp, "sw", dev)
        down = tk.rowseg_top_border(Bn, 0, C, **bkw)
        cols = batch.ridx[:, :C].contiguous()
        call = (cols, batch.qlen_t, batch.rlen_t, state, down)
        ckw = dict(kw, row_offset=0, q_chunk=qc, col_offset=0, **subs)
        kept = {}
        ms = time_cuda(torch, lambda: kept.update(
            got=tk.score_rowseg(*call, **ckw)), reps=5)
        form = plan_note(tk, cls, Bn, qc, C, batch.table.shape[0])
        plain_ms = time_cuda(torch, lambda: kept.update(
            want=tk.score_rowseg_plain(*call, **ckw)), reps=1, warmup=0)
        rec = {0: (kept["got"][1], kept["got"][2], kept["got"][3],
                   kept["got"][0])}
        wrec = {0: (kept["want"][1], kept["want"][2], kept["want"][3],
                    kept["want"][0])}
        errs[cls] = max(errs[cls], records_diff(torch, rec, wrec))
        if errs[cls] != 0:
            raise AssertionError(f"tile kernel != plain on one {cls} tile of "
                                 f"{qc} x {C}: max |diff| {errs[cls]}")
        del kept, rec, wrec
        path_ms = None
        if cls != "score":
            path_ms = time_cuda(torch, lambda: seqpar(mb, cls, qc), reps=3,
                                warmup=1)
        b = tile_bound(cls, cols, batch.qlen_t, batch.rlen_t, subs, 0, qc, 0)
        log(f"[24 timing] {cls} class, one tile of {qc} rows x {C} columns, "
            f"{Bn} pairs SW 5/1: kernel {ms} ms ({form}), its plain version "
            f"{plain_ms} ms, bound {b['bound_ms']} ms ({b['bound_by']})"
            + (f"; the 16 tiles of the 128 pairs of 50-{LONG_LEN} bp through "
               f"seqpar_align_scan {path_ms} ms" if path_ms else "")
            + f" [{card}]")
        out[cls] = {"launches": launches[cls], "max_abs_err": errs[cls],
                    "ms": ms, "plain_ms": plain_ms,
                    "shape": f"one tile, {Bn} pairs, {qc} rows x {C} "
                             f"columns, SW 5/1",
                    "form": f"the block kernel's tile form, {form}",
                    "path_ms": chain6 if cls == "score" else path_ms, **b}
    return out


def check_planes(name, alignments, want, keys) -> None:
    """Each alignment's ``keys`` fields (host slices of its planes, rows,
    columns and scalars) against pair b of ``want`` (a score_align dict on
    the card), over the pair's cells."""
    host = {k: want[k].cpu().numpy() for k in keys}
    for b, a in enumerate(alignments):
        ql, rl = a.query_len, a.ref_len
        for k in keys:
            v = host[k][b]
            if k.endswith("_table"):
                v = v[:ql, :rl]
            elif k.endswith("_row"):
                v = v[:rl]
            elif k.endswith("_col"):
                v = v[:ql]
            if not np.array_equal(np.asarray(a.fields[k]), v):
                raise AssertionError(f"{name}: pair {b} {k} differs from the "
                                     "plain version")


def plain_every_class(torch, tk, args, kw, trace=True) -> dict:
    """The plain version's outputs of every class on one input, class ->
    dict, from two plain calls: stats_table (the wavefront: the scalars,
    the payloads and every plane; the rowcol classes' rows and columns
    are its planes' last row and last column, zero beyond the lengths)
    and, with ``trace``, trace (the column sweep)."""
    _, qlen, rlen = args
    st = tk.score_align_plain(*args, **dict(kw, outputs="stats_table"))
    B, Qp, Rp = st["score_table"].shape
    dev = qlen.device
    b = torch.arange(B, device=dev)
    qi, ri = (qlen.long() - 1).clamp(min=0), (rlen.long() - 1).clamp(min=0)
    on_row = (torch.arange(Rp, device=dev)[None] < rlen[:, None]) & \
        (qlen > 0)[:, None]
    on_col = (torch.arange(Qp, device=dev)[None] < qlen[:, None]) & \
        (rlen > 0)[:, None]
    names = ("score", "matches", "similar", "length")
    rows = {n: torch.where(on_row, st[f"{n}_table"][b, qi], 0) for n in names}
    cols = {n: torch.where(on_col, st[f"{n}_table"][b, :, ri], 0)
            for n in names}
    stats = {k: v for k, v in st.items() if not k.endswith("_table")}
    base = {k: v for k, v in stats.items()
            if k not in ("matches", "similar", "length")}
    out = {"score": base, "stats": stats, "stats_table": st,
           "table": {**base, "score_table": st["score_table"]},
           "rowcol": {**base, "score_row": rows["score"],
                      "score_col": cols["score"]},
           "stats_rowcol": {**stats, **{f"{n}_row": rows[n] for n in names},
                            **{f"{n}_col": cols[n] for n in names}}}
    if trace:
        out["trace"] = tk.score_align_plain(*args, **dict(kw,
                                                          outputs="trace"))
    return out


def chunked_path(torch, pt, tk, tw, dispatch, golden, stages, rng, card,
                 pairs, head) -> dict:
    """Phases 25-27, the chunked sweep (kernel K1f) and the long one-shot
    path; ``head`` is the headline batch's (args, kwargs).  Returns its
    entry of the kernels line."""
    from parasail_rs_tpu_torch.ops import _build

    dev = torch.device("cuda")
    classes = tk.OUTPUTS
    err = 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    # -- 25. chunked sweep vs plain ---------------------------------------------
    t25 = time.perf_counter()
    B, Qp, Rp, A = 64, 608, 200, 5
    modes = ([("nw", F4)] + [("sg", f) for f in SG_FREE] +
             [("sw", (True,) * 4)])
    n = 0
    for mi, (mode, free) in enumerate(modes):
        for pi, (open_, ext) in enumerate(((11, 1), (2, 2), (1, 3))):
            ql = rng.integers(0, 601, size=B)
            rl = rng.integers(0, Rp + 1, size=B)
            # empty sides; the last row in the first, second and third
            # group of 256 rows, on a stripe's edge and inside one
            ql[:8] = (0, 5, 600, 255, 256, 257, 513, 300)
            rl[:8] = (7, 0, Rp, 64, 65, Rp, 1, 129)
            kw = dict(open_=open_, ext=ext, mode=mode, free=free,
                      width="sat", table=t(rng.integers(-4, 6, size=(A, A))),
                      qidx=t(rng.integers(0, A, size=(B, Qp))))
            args = (t(rng.integers(0, A, size=(B, Rp))), t(ql), t(rl))
            # every class against the plain version (score_align at Qp =
            # 608 is this very sweep); the plain outputs of the seven
            # classes come from two plain calls, and at the first input
            # each class's own plain call holds that derivation
            want = plain_every_class(torch, tk, args, kw)
            for ci, cls in enumerate(classes):
                warps = (1, 3, 8, 0)[n % 4]         # 0: the launcher's pick
                form = BLOCK_FORMS[n % len(BLOCK_FORMS)]
                n += 1
                fname = force_form(tk, cls, warps, form)
                got = tk.score_chunked(*args, **kw, outputs=cls)
                unforce(tk)
                e = max_abs_diff(got, want[cls])
                if mi == pi == 0:
                    e = max(e, max_abs_diff(want[cls], tk.score_align_plain(
                        *args, **kw, outputs=cls)))
                torch.cuda.synchronize()
                if e != 0:
                    raise AssertionError(
                        f"chunked sweep != plain on {cls} "
                        f"{mode}{tuple(int(x) for x in free)} {open_}/{ext} "
                        f"{fname}: max |diff| {e}")
        log(f"[25 chunked vs plain] {mode}{tuple(int(x) for x in free)}: the "
            f"seven classes at 11/1, 2/2, 1/3, {B} pairs of 0-600 x 0-{Rp} "
            f"(Qp={Qp}: one to five groups of rows), 1-8 warps a block, "
            f"2-8 rows a lane, 1-8 blocks a pair: equal to plain at every "
            f"penalty pair")
    tall_q = [int(x) for x in rng.integers(2049, 3073, size=12)] + \
        [0, 1, 33, 100]
    tall_q[0] = 3072
    tall_r = [int(x) for x in rng.integers(1, 97, size=16)]
    tall_r[0], tall_r[13] = 96, 0
    m = pt.Matrix.default()
    tall = (random_seqs_of(rng, DNA, tall_q), random_seqs_of(rng, DNA,
                                                             tall_r))
    targs, tsubs = pack_table(torch, dev, m, *tall, 3072)
    targs = (targs[0][:, :96].contiguous(), *targs[1:])
    tkw = dict(open_=5, ext=1, mode="sw", free=(True,) * 4, width="sat",
               **tsubs)
    want = plain_every_class(torch, tk, targs, tkw)
    for cls in classes:
        e = max_abs_diff(tk.score_chunked(*targs, **tkw, outputs=cls),
                         want[cls])
        torch.cuda.synchronize()
        if e != 0:
            raise AssertionError(f"chunked sweep != plain on 16 pairs of "
                                 f"3,072 x 96 ({cls}): max |diff| {e}")
    log("[25 chunked vs plain] 16 pairs padded to 3,072 x 96 (queries of "
        "2,049-3,072 letters and short ones, an empty reference), SW 5/1, "
        "every class: equal to plain")

    log(f"[25 chunked vs plain] {time.perf_counter() - t25:.1f} s")

    # -- 26. the long one-shot path through the public API ------------------------
    mq, mr = pairs["mixed"]
    short = pairs["short"]

    def sw51():
        return pt.Aligner.new().gap_open(5).gap_extend(1).local()

    sg111 = pt.Aligner.new().gap_open(11).gap_extend(1).semi_global().build()
    al = {"sw": sw51().build(), "sg": sg111,
          "rowcol": sw51().use_last_rowcol().build(),
          "stats_rowcol": sw51().use_stats().use_last_rowcol().build(),
          "table": sw51().use_table().build(),
          "stats_table": sw51().use_stats().use_table().build()}
    sel = list(range(8)) + short                  # 16 pairs: pair 0 is 4,096
    tq, tr = [mq[b] for b in sel], [mr[b] for b in sel]
    q2, r2 = [q[:LONG_LEN // 2] for q in mq], [r[:LONG_LEN // 2] for r in mr]
    k1_shapes = []
    real_k1 = dispatch.score_align

    def recording_k1(ridx, qlen, rlen, **kw):
        subs = kw.get("profile")
        subs = kw["qidx"] if subs is None else subs
        k1_shapes.append((int(subs.shape[1]), int(ridx.shape[1])))
        return real_k1(ridx, qlen, rlen, **kw)

    dispatch.ROUTE_COUNTS.clear()
    reset_launches(tk, tw)
    dispatch.score_align = recording_k1
    try:
        cig_sw = al["sw"].align_cigars(mq, mr)
        per_cigars = tk.CHUNKED_LAUNCHES
        cig_sg = al["sg"].align_cigars(mq, mr)
        ssw = al["sw"].ssw_batch(mq, mr)
        res = {"rowcol": al["rowcol"].align_batch(mq, mr),
               "stats_rowcol": al["stats_rowcol"].align_batch(mq, mr),
               "stats_rowcol_2048": al["stats_rowcol"].align_batch(q2, r2),
               "table": al["table"].align_batch(tq, tr),
               "stats_table": al["stats_table"].align_batch(tq, tr),
               "stats_table_2048": al["stats_table"].align_batch(
                   [q[:LONG_LEN // 2] for q in tq],
                   [r[:LONG_LEN // 2] for r in tr])}
    finally:
        dispatch.score_align = real_k1
    torch.cuda.synchronize()
    routes = dict(dispatch.ROUTE_COUNTS)
    chunked = tk.CHUNKED_LAUNCHES
    log(f"[26 long one-shot path] chunked launches={chunked} (one "
        f"align_cigars: {per_cigars}; walk {tw.LAUNCHES}, segment "
        f"{tk.SEGMENT_LAUNCHES}, cuda_kernel launches on the padded "
        f"shapes {sorted(set(k1_shapes))}) routes={routes}")
    long_k1 = [s for s in k1_shapes
               if s[0] * s[1] >= dispatch.SEGMENT_MIN_CELLS or
               s[0] > dispatch.CHUNK_ROWS]
    if chunked < 1 or per_cigars < 1 or tw.LAUNCHES < 1 or long_k1 or \
            tk.SEGMENT_LAUNCHES:
        raise AssertionError(
            f"the long one-shot path left the chunked sweep: {chunked} "
            f"chunked launches, cuda_kernel launches on long shapes "
            f"{long_k1}, {tk.SEGMENT_LAUNCHES} segment launches")
    if set(routes) - {("cuda_chunked", "long pairs, one launch"),
                      ("cuda_kernel", "")} or \
            routes.get(("cuda_kernel", ""), 0) != len(k1_shapes):
        raise AssertionError(f"the long one-shot path left the chunked "
                             f"route: {routes}")
    # CIGARs and scalars against use_trace() + cigars() on the segment route
    keys = ("score", "end_query", "end_ref")
    for name, (alns, cigs), builder in (
            ("SW 5/1", cig_sw, sw51()),
            ("SG 11/1", cig_sg, pt.Aligner.new().gap_open(11).gap_extend(1)
             .semi_global())):
        tr_al = builder.use_trace().build()
        t_alns = tr_al.align_batch(mq, mr)
        if {r for r, _ in tr_al.route_counter} != {"cuda_segments"}:
            raise AssertionError(f"use_trace() {name}: routes "
                                 f"{tr_al.route_counter}")
        if tr_al.cigars(t_alns, mq, mr) != list(cigs):
            raise AssertionError(f"align_cigars {name} != use_trace() + "
                                 "cigars() on the segment route")
        for b, (a, w) in enumerate(zip(alns, t_alns)):
            if any(a.fields[k] != w.fields[k] for k in keys):
                raise AssertionError(f"align_cigars {name}: pair {b} "
                                     "scalars differ from the segment route")
        del t_alns
    for b, (s, a, c) in enumerate(zip(ssw, cig_sw[0], cig_sw[1])):
        if (s.score1, s.read_end1, s.ref_end1, s.cigar_string()) != (
                min(a.get_score(), 0xFFFF), a.get_end_query(),
                a.get_end_ref(), merged_cigar(
                    (int(n), op) for n, op in re.findall(r"(\d+)(\D)", c))):
            raise AssertionError(f"ssw_batch pair {b} differs from "
                                 "align_cigars")
    # planes, rows and columns against the plain version on 4 of the pairs
    # (score_align is this very sweep at these Qp): the four classes at
    # 4,096 bp (pair 0 is 4,096 x 4,096) and the stats classes at 2,048,
    # each length from one plain stats_table call (plain_every_class)
    kw = dict(open_=5, ext=1, mode="sw", free=(True,) * 4, width="sat")
    for bp, (qs4, rs4) in ((LONG_LEN, (mq[:4], mr[:4])),
                           (LONG_LEN // 2, (q2[:4], r2[:4]))):
        batch, _, _ = al["rowcol"]._pack(qs4, rs4)
        args = (batch.ridx, batch.qlen_t, batch.rlen_t)
        if (args[0].shape[1], batch.qidx.shape[1]) != (bp, bp):
            raise AssertionError(f"plain on 4 pairs: padded to "
                                 f"{tuple(batch.qidx.shape)} x "
                                 f"{tuple(args[0].shape)}")
        want = plain_every_class(torch, tk, args, dict(
            kw, table=batch.table, qidx=batch.qidx), trace=False)
        suffix = "" if bp == LONG_LEN else "_2048"
        for cls in (("rowcol", "table", "stats_rowcol", "stats_table")
                    if bp == LONG_LEN else ("stats_rowcol", "stats_table")):
            check_planes(f"{cls} through align_batch at {bp} bp",
                         res[cls + suffix][:4], want[cls],
                         [k for k in want[cls]
                          if k not in ("saturated", "promoted")])
        if bp == LONG_LEN:
            # the sweep itself on the padded batch: every cell, row and
            # column, zeros beyond the pairs' lengths included
            e = max_abs_diff(tk.score_chunked(*args, **kw, outputs="rowcol",
                                              table=batch.table,
                                              qidx=batch.qidx),
                             want["rowcol"])
            if e != 0:
                raise AssertionError(f"chunked sweep != plain on rowcol, 4 "
                                     f"pairs at {LONG_LEN} x {LONG_LEN}: max "
                                     f"|diff| {e}")
            err = max(err, e)
        del want
    # the stats classes' scalars at 4,096 bp against the segment route
    st = pairs["aligners"]["stats"].align_batch(mq, mr)
    for b, (a, w) in enumerate(zip(res["stats_rowcol"], st)):
        if any(a.fields[k] != w.fields[k]
               for k in keys + ("matches", "similar", "length")):
            raise AssertionError(f"use_stats().use_last_rowcol() pair {b} "
                                 "differs from the segment route's stats")
    del st
    for b in short:
        g = golden.align_seqs(mq[b], mr[b], m, 5, 1, "sw")
        w = golden.walk_trace(g.trace_table, mq[b], mr[b], g.end_query,
                              g.end_ref, "sw")
        gg = golden.align_seqs(mq[b], mr[b], m, 11, 1, "sg")
        wg = golden.walk_trace(gg.trace_table, mq[b], mr[b], gg.end_query,
                               gg.end_ref, "sg")
        s = ssw[b]
        if cig_sw[1][b] != w.cigar_string() or \
                cig_sg[1][b] != wg.cigar_string() or \
                (s.score1, s.read_begin1, s.ref_begin1) != (
                    g.score, w.beg_query, w.beg_ref):
            raise AssertionError(f"short pair {b}: CIGAR or SSW differs from "
                                 "golden")
        for cls in ("rowcol", "stats_rowcol"):
            a = res[cls][b]
            for k in a.fields:
                if k.endswith(("_row", "_col")) and not np.array_equal(
                        a.fields[k], getattr(g, k)):
                    raise AssertionError(f"short pair {b}: {cls} {k} differs "
                                         "from golden")
        for cls in ("table", "stats_table"):
            a = res[cls][sel.index(b)]
            for k in a.fields:
                if k.endswith("_table") and not np.array_equal(
                        a.fields[k], getattr(g, k)):
                    raise AssertionError(f"short pair {b}: {cls} {k} differs "
                                         "from golden")
    del res, ssw
    log(f"[26 long one-shot path] the long mixed batch (120 DNA pairs of "
        f"1,024-4,096 bp and 8 of 50-200, Qp=Rp={LONG_LEN}): align_cigars "
        f"(SW 5/1, SG 11/1), ssw_batch, use_last_rowcol() with and without "
        f"stats, use_table() with and without stats on 16 pairs, every long "
        f"batch on cuda_chunked; CIGARs and scalars equal use_trace() + "
        f"cigars() on the segment route, SSW equal align_cigars, the planes, "
        f"rows and columns of 4 pairs equal to plain at {LONG_LEN} and "
        f"{LONG_LEN // 2} bp, the short pairs equal golden")

    # -- 27. timings ------------------------------------------------------------------
    b4, _, _ = al["sw"]._pack(mq, mr)
    b16, _, _ = al["sw"]._pack(tq, tr)
    shapes = {
        "4096": ((b4.ridx, b4.qlen_t, b4.rlen_t),
                 dict(table=b4.table, qidx=b4.qidx)),
        "16x4096": ((b16.ridx, b16.qlen_t, b16.rlen_t),
                    dict(table=b16.table, qidx=b16.qidx)),
        "1024": ((b4.ridx[:, :MID_LEN].contiguous(),
                  b4.qlen_t.clamp(max=MID_LEN), b4.rlen_t.clamp(max=MID_LEN)),
                 dict(table=b4.table,
                      qidx=b4.qidx[:, :MID_LEN].contiguous())),
    }
    tq128 = [int(x) for x in rng.integers(2049, 3073, size=128)]
    tr128 = [int(x) for x in rng.integers(48, 97, size=128)]
    tq128[0], tr128[0] = 3072, 96
    ta, ts = pack_table(torch, dev, m, random_seqs_of(rng, DNA, tq128),
                        random_seqs_of(rng, DNA, tr128), 3072)
    shapes["3072x96"] = ((ta[0][:, :96].contiguous(), *ta[1:]), ts)
    # below the route's thresholds: Qp * Rp < SEGMENT_MIN_CELLS, Qp <=
    # CHUNK_ROWS
    shapes["2048x96"] = ((shapes["3072x96"][0][0], ta[1].clamp(max=2048),
                          ta[2]),
                         dict(ts, qidx=ts["qidx"][:, :2048].contiguous()))
    shapes["512"] = ((b4.ridx[:, :512].contiguous(), b4.qlen_t.clamp(max=512),
                      b4.rlen_t.clamp(max=512)),
                     dict(table=b4.table, qidx=b4.qidx[:, :512].contiguous()))
    sw_kw = dict(open_=5, ext=1, mode="sw", free=(True,) * 4, width="sat")
    times, peaks = {}, {}
    for cls in classes:
        big = "16x4096" if cls in ("table", "stats_table") else "4096"
        for shape in (big, "1024", "3072x96", "2048x96", "512"):
            args, subs = shapes[shape]
            kw = dict(sw_kw, outputs=cls, **subs)
            if shape == big:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                tk.score_chunked(*args, **kw)
                torch.cuda.synchronize()
                peaks[cls] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            k_ms = time_cuda(torch, lambda: tk.score_chunked(*args, **kw),
                             reps=3, warmup=1)
            times[cls, shape] = k_ms
            B_, Qs, Rs = args[0].shape[0], subs["qidx"].shape[1], \
                args[0].shape[1]
            b = sweep_bound(cls, args, kw)
            log(f"[27 timing] {cls}, {B_} pairs padded to {Qs} x {Rs}, SW "
                f"5/1: chunked sweep {k_ms} ms "
                f"({plan_note(tk, cls, B_, Qs, Rs, subs['table'].shape[0])})"
                f", bound {b['bound_ms']} ms "
                f"({b['bound_by']})"
                + (f"; peak device memory of one chunked call above its "
                   f"inputs {peaks[cls]} MiB" if shape == big else "")
                + f" [{card}]")
    # the headline batch (8,192 pairs of 150 padded to 160), score class
    h_args, h_kw = head
    head_ms = (time_cuda(torch, lambda: tk.score_chunked(*h_args, **h_kw)),
               time_cuda(torch, lambda: tk.score_align(*h_args, **h_kw)))
    h_plan = plan_note(tk, "score", h_args[0].shape[0],
                       h_kw["profile"].shape[1], h_args[0].shape[1],
                       h_kw["profile"].shape[2], profile=True)
    log(f"[27 timing] score, the headline batch (8,192 pairs padded to 160 x "
        f"160, SW 11/1): chunked sweep {head_ms[0]} ms ({h_plan}), the "
        f"short form (score_align) {head_ms[1]} ms ({head_ms[1] / head_ms[0]}"
        f"x) [{card}]")
    # the main path's shape: the trace class on the long mixed batch, with
    # its plain version (a column sweep) on the same inputs
    args, subs = shapes["4096"]
    kw = dict(sw_kw, outputs="trace", **subs)
    kept = {}
    plain_ms = time_cuda(torch, lambda: kept.update(
        want=tk.score_align_plain(*args, **kw)), reps=1, warmup=0)
    e = max_abs_diff(tk.score_chunked(*args, **kw), kept.pop("want"))
    if e != 0:
        raise AssertionError(f"chunked sweep != plain on the long mixed "
                             f"batch (trace): max |diff| {e}")
    err = max(err, e)
    del kept
    trace_ms = times["trace", "4096"]
    bnd = sweep_bound("trace", args, kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    e2e_ms = time_host(lambda: al["sw"].align_cigars(mq, mr), reps=3)
    cig_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    bins = chunked_bins(torch, tk, dispatch, lambda: al["sw"].align_cigars(
        mq, mr))
    if bins["launches"] != per_cigars:
        raise AssertionError(f"align_cigars made {bins['launches']} chunked "
                             f"launches, phase 26 counted {per_cigars}")
    with stages.measuring():
        al["sw"].align_cigars(mq, mr)
        snap = stages.snapshot()
    per_call = {k: v["ms"] for k, v in snap.items() if "ms" in v}
    cells = sum(len(q) * len(r) for q, r in zip(mq, mr))
    log(f"[27 timing] card: {card}")
    log(f"[27 timing] trace class on the long mixed batch (128 pairs, "
        f"Qp=Rp={LONG_LEN}): chunked sweep {trace_ms} ms, its plain version "
        f"{plain_ms} ms, bound {bnd['bound_ms']} ms ({bnd['bound_by']}) "
        f"[{card}]")
    log(f"[27 timing] align_cigars SW 5/1 of the long mixed batch e2e median "
        f"{e2e_ms} ms ({cells / e2e_ms / 1e6} GCUPS over {cells} cells), "
        f"{per_cigars} chunked launches a call, peak device memory above the "
        f"inputs {cig_peak} MiB; stages, ms: {json.dumps(per_call)} "
        f"[{card}]")
    log(f"[27 timing] align_cigars' chunked launches (the bins' own, CUDA "
        f"events around each, its plane's zero fill included): "
        f"{bins['launches']} launches, {bins['ms']} ms in all, bound "
        f"{bins['bound_ms']} ms; each (pairs, Qp, Rp, ms, form): "
        f"{json.dumps(bins['each'])} [{card}]")
    form_sweep(torch, tk, card, b4, b16, sw_kw, (h_args, h_kw))
    regs = block_registers(_build.BUILD_LOG, classes)
    log(f"[27 timing] registers and spill bytes of the block kernel's forms "
        f"(nvcc {'ran' if _build.BUILD_LOG else 'cached'}): {regs}")
    spilled = {k: v for k, v in regs.items() if v[1]}
    if spilled:
        raise AssertionError(f"block kernel forms spill: {spilled}")
    return {"launches": per_cigars, "max_abs_err": err, "ms": trace_ms,
            "plain_ms": plain_ms,
            "shape": f"trace class, the long mixed batch (128 pairs, "
                     f"Qp=Rp={LONG_LEN}), SW 5/1",
            "form": "the block kernel over all columns, "
                    + plan_note(tk, "trace", 128, LONG_LEN, LONG_LEN,
                                b4.table.shape[0]),
            "e2e_ms": e2e_ms,
            "bins_launches": bins["launches"], "bins_ms": bins["ms"],
            "bins_bound_ms": bins["bound_ms"], **bnd}


def form_sweep(torch, tk, card, b4, b16, sw_kw, head) -> None:
    """The block kernel at five main-path shapes in the launcher's form
    and in others beside it (rows a lane, warps a block, blocks a pair),
    CUDA-event medians: what the rule (csrc/score_cell.cuh, seg_plan)
    chose against what it passed over."""
    a4 = (b4.ridx, b4.qlen_t, b4.rlen_t)
    k4 = dict(sw_kw, table=b4.table, qidx=b4.qidx)
    a16 = (b16.ridx, b16.qlen_t, b16.rlen_t)
    k16 = dict(sw_kw, table=b16.table, qidx=b16.qidx)
    a512 = (b4.ridx[:, :512].contiguous(), b4.qlen_t.clamp(max=512),
            b4.rlen_t.clamp(max=512))
    k512 = dict(sw_kw, table=b4.table, qidx=b4.qidx[:, :512].contiguous())
    pen = {k: sw_kw[k] for k in ("open_", "ext", "mode", "free")}
    dev = b4.ridx.device
    state = tk.rowseg_left_border(128, 0, LONG_LEN // 2, outputs="score",
                                  device=dev, **pen)
    state["acc"] = tk.acc_init(128, LONG_LEN, "sw", dev)
    down = tk.rowseg_top_border(128, 0, LONG_LEN, outputs="score",
                                device=dev, **pen)
    h_args, h_kw = head
    A = b4.table.shape[0]
    prof = h_kw["profile"]
    cases = (
        ("K2 score, 128 x 4,096 bp, one segment",
         ("score", 128, LONG_LEN, LONG_LEN, A),
         lambda: tk.score_segment(*a4, **k4, outputs="score"),
         ((8, 8, 1), (4, 8, 1), (8, 4, 1), (8, 8, 2))),
        ("K3 score tile, 128 pairs, 2,048 rows x 4,096 columns",
         ("score", 128, LONG_LEN // 2, LONG_LEN, A),
         lambda: tk.score_rowseg(*a4, state, down, **k4, outputs="score",
                                 row_offset=0, q_chunk=LONG_LEN // 2,
                                 col_offset=0),
         ((8, 8, 1), (4, 8, 1), (8, 4, 1))),
        ("K1f trace, 16 pairs of the long mixed batch",
         ("trace", 16, LONG_LEN, LONG_LEN, A),
         lambda: tk.score_chunked(*a16, **k16, outputs="trace"),
         ((4, 4, 8), (2, 8, 8), (4, 8, 2), (4, 8, 1))),
        ("K1f stats_table, 128 pairs of the long mixed batch at 512 x 512",
         ("stats_table", 128, 512, 512, A),
         lambda: tk.score_chunked(*a512, **k512, outputs="stats_table"),
         ((2, 8, 1), (4, 8, 1), (2, 4, 1))),
        ("K2 score, the headline batch",
         ("score", prof.shape[0], prof.shape[1], h_args[0].shape[1],
          prof.shape[2], True),
         lambda: tk.score_segment(*h_args, **h_kw, outputs="score"),
         ((8, 1, 1), (4, 1, 1), (2, 1, 1), (4, 2, 1))),
    )
    for name, plan, fn, forms in cases:
        times = {f"launcher ({plan_note(tk, *plan)})":
                 time_cuda(torch, fn, reps=3, warmup=1)}
        for rows, warps, cluster in forms:
            tk._LANE_ROWS, tk.SEGMENT_WARPS, tk._CLUSTER = rows, warps, cluster
            try:
                times[f"R {rows}, {warps} warps, C {cluster}"] = time_cuda(
                    torch, fn, reps=3, warmup=1)
            finally:
                unforce(tk)
        log(f"[27 forms] {name}: ms by form {json.dumps(times)} [{card}]")


def chunked_bins(torch, tk, dispatch, call) -> dict:
    """Run ``call`` (an align_cigars) with CUDA events around each chunked
    launch it makes: {"launches", "ms" (their sum), "bound_ms" (the sum of
    sweep_bound over the launches' inputs), "each": [(pairs, Qp, Rp, ms,
    form)]}."""
    real = dispatch.score_chunked
    marks = []

    def timed(ridx, qlen, rlen, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(ridx, qlen, rlen, **kw)
        end.record()
        marks.append((start, end, (ridx, qlen, rlen), kw))
        return out

    dispatch.score_chunked = timed
    try:
        call()
    finally:
        dispatch.score_chunked = real
    torch.cuda.synchronize()
    each, total, bound_ms = [], 0.0, 0.0
    for start, end, args, kw in marks:
        ms = start.elapsed_time(end)
        total += ms
        bound_ms += sweep_bound(kw["outputs"], args, kw)["bound_ms"]
        subs = kw["qidx"] if kw.get("profile") is None else kw["profile"]
        shape = (int(args[0].shape[0]), int(subs.shape[1]),
                 int(args[0].shape[1]))
        A = (kw["table"] if kw.get("table") is not None
             else kw["profile"]).shape[-1]
        each.append((*shape, ms, plan_note(
            tk, kw["outputs"], *shape, A, kw.get("profile") is not None)))
    return {"launches": len(marks), "ms": total, "bound_ms": bound_ms,
            "each": each}


def block_registers(build_log: str, classes) -> dict:
    """Registers and spill-store bytes of each segment_kernel form from
    ``-Xptxas -v``'s log: {"<class> R<rows>[ tile| banded]": (registers,
    spill bytes)}."""
    out, form, spill = {}, None, 0
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            form, spill = None, 0
            if "ptsegblock14segment_kernelILi" in line:
                k, tile, rows, band = re.match(
                    r"(\d+)ELb(\d)ELi(\d+)ELb(\d)E",
                    line.split("ptsegblock14segment_kernelILi")[1]).groups()
                form = f"{classes[int(k)]} R{rows}" + (
                    " tile" if tile == "1" else "") + (
                    " banded" if band == "1" else "")
        elif "spill stores" in line and form is not None:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "registers" in line and form is not None:
            out[form] = (int(line.split("Used")[1].split("registers")[0]),
                         spill)
    return out


def device_ms(torch, fn, name: str, n: int = 10) -> float:
    """Milliseconds a launch of the device kernel whose name holds
    ``name`` takes in fn(), which launches it once: torch.profiler's
    device time over n calls after a warm-up, averaged over the launches
    the profiler recorded, the wrapper's host work and other kernels (a
    plane's zero fill) left out.  Raises where the profiler saw no such
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if name in e.key:
            t = (getattr(e, "device_time_total", None) or
                 getattr(e, "cuda_time_total", 0) or 0)
            if t > 0:
                total += t
                count += e.count
    if total <= 0 or count <= 0:
        raise AssertionError(f"the profiler saw no device time of {name}")
    return total / 1e3 / count


def short_registers(build_log: str, classes) -> dict:
    """Registers and spill-store bytes of each short_kernel form from
    ``-Xptxas -v``'s log: {"<class> R<rows> <payload ops>[ banded]":
    (registers, spill bytes)}; ``classes`` names the classes in OutClass
    order."""
    out, form, spill = {}, None, 0
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            form, spill = None, 0
            m = re.search(r"short_kernel(?:_one)?ILi(\d)ELi(\d)ELb(\d)E"
                          r"N7ptscore\d+(\w+?)E", line)
            if m:
                form = (f"{classes[int(m.group(1))]} R{m.group(2)} "
                        f"{m.group(4)}" +
                        (" banded" if m.group(3) == "1" else ""))
        elif "spill stores" in line and form is not None:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "registers" in line and form is not None:
            out[form] = (int(line.split("Used")[1].split("registers")[0]),
                         spill)
    return out


def short_path(torch, pt, tk, tw, dispatch, stages, rng, blosum, card,
               sw_pairs, cfg4b, tab, head) -> dict:
    """Phases 28-29, the short form (kernels K1a-K1d, csrc/scan_short.cu:
    one warp a pair), every class; returns the trace and stats classes'
    yardstick and kernel times for the kernels line, and every class's
    error."""
    from parasail_rs_tpu_torch.ops import _build

    dev = torch.device("cuda")
    errs = dict.fromkeys(tk.OUTPUTS, 0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def check(cls, name, args, kw, qsym=None):
        """score_align of class cls against its plain version (and, for
        trace, the walk of its plane), with the form the rule picks,
        which the counters must show ran."""
        ridx = args[0]
        subs = kw["profile"] if kw.get("profile") is not None else kw["qidx"]
        A = (kw["profile"] if kw.get("profile") is not None
             else kw["table"]).shape[-1]
        plan = tk.short_plan(cls, ridx.shape[0], subs.shape[0],
                             subs.shape[1], ridx.shape[1], A,
                             kw.get("profile") is not None)
        before = (tk.SHORT_LAUNCHES[cls], tk.CHUNKED_LAUNCHES)
        got = tk.score_align(*args, **kw, outputs=cls)
        ran = (tk.SHORT_LAUNCHES[cls] - before[0],
               tk.CHUNKED_LAUNCHES - before[1])
        if ran != ((1, 0) if plan[0] else (0, 1)):
            raise AssertionError(f"{cls} {name}: plan {plan} but short / "
                                 f"block launches {ran}")
        want = tk.score_align_plain(*args, **kw, outputs=cls)
        torch.cuda.synchronize()
        e = max_abs_diff(got, want)
        if cls == "trace" and qsym is not None:
            walk = (got["trace_table"], qsym, ridx, got["end_query"],
                    got["end_ref"], kw["mode"], kw["free"])
            e = max(e, max_abs_diff(
                dict(zip("obr", tw.device_walk(*walk))),
                dict(zip("obr", tw.device_walk_plain(*walk)))))
        if e != 0:
            raise AssertionError(f"short form != plain on {cls} {name} "
                                 f"(plan {plan}): max |diff| {e}")
        errs[cls] = max(errs[cls], e)
        return plan

    def batch(B, Qp, Rp, A=20, full=2):
        """B random table-form pairs of 0-Qp by 0-Rp letters, the first
        ``full`` of them Qp by Rp."""
        ql = rng.integers(0, Qp + 1, size=B)
        rl = rng.integers(0, Rp + 1, size=B)
        ql[:full], rl[:full] = Qp, Rp
        qidx = rng.integers(0, A, size=(B, Qp))
        qidx[np.arange(Qp)[None, :] >= ql[:, None]] = -1
        ridx = rng.integers(0, A, size=(B, Rp))
        args = (t(ridx), t(ql), t(rl))
        return args, {"table": t(rng.integers(-4, 8, size=(A, A))),
                      "qidx": t(qidx)}

    # -- 28. the short form vs plain, and its main paths -----------------------
    for cls in ("trace", "stats"):
        for name, (args, subs), kw in small_cases(rng, torch, dev):
            check(cls, name, args, {**kw, **with_letters(torch, rng, subs,
                                                         cls)},
                  subs.get("qidx"))
        for name, (args, subs), kw, _want in empty_side_cases(torch, dev):
            check(cls, name, args, {**kw, **subs}, subs["qidx"])
        log(f"[28 short form vs plain] {cls}: phase 2's small batches and "
            f"the empty-side pairs equal, walks included")
    modes = (("nw", F4, 2, 2), ("sg", (True, False, False, True), 1, 3),
             ("sw", (True,) * 4, 11, 1))
    forms = {}
    # both payload layouts; the rows bounds (4 rows a lane up to Qp = 128,
    # 5 to 160, 6 to 192, 8 past it); the flags 16 columns a store (Rp a
    # multiple of 16) or 4 (24); past 256 rows, the block kernel's
    # one-shot form.  Trace and stats in three modes on the first eight
    # shapes; the score and plane classes in one mode in turn, on the
    # shapes that set their rows and their stores' width: a 16-byte
    # vector (Qp 24, 16, 128, 256), 8 bytes (186, 192) or word by word
    # (129, 130, 193, 250)
    shapes = ((24, 24), (16, 1100), (128, 96), (129, 96), (192, 64),
              (193, 64), (256, 64), (300, 64), (130, 64), (186, 64),
              (250, 64))
    for si, (Qp, Rp) in enumerate(shapes):
        args, subs = batch(256, Qp, Rp)
        for ci, cls in enumerate(tk.OUTPUTS):
            for mi, (mode, free, o, e) in enumerate(modes):
                if cls in ("trace", "stats"):
                    if si >= 8:
                        continue
                elif (si + ci) % 3 != mi or (Qp, Rp) == (16, 1100) and \
                        cls not in STATS_CLASSES:
                    continue
                forms[cls, Qp, Rp] = check(
                    cls, f"{Qp} x {Rp} {mode} {o}/{e}", args,
                    dict(subs, open_=o, ext=e, mode=mode, free=free,
                         width="sat"), subs["qidx"])
    log(f"[28 short form vs plain] 256 pairs at Qp x Rp = "
        f"{', '.join(f'{q} x {r}' for q, r in shapes)}: trace and stats in NW "
        f"2/2, SG 1/3 and SW 11/1 on the first eight, the other five classes "
        f"in one mode in turn: equal, walks included; (rows, pairs a block, "
        f"layout) "
        f"{dict((f'{c} {q}x{r}', v) for (c, q, r), v in forms.items())}")
    if forms["stats", 24, 24][2] != 1 or forms["stats", 16, 1100][2] != 2 \
            or forms["stats_table", 16, 1100][2] != 2 \
            or any([forms[c, q, r][0] for q, r in (
                (128, 96), (129, 96), (192, 64), (193, 64))] != [4, 5, 6, 8]
                for c in tk.OUTPUTS) \
            or [forms["table", q, 64][0] for q in (130, 186, 250)] != [5, 6, 8] \
            or any(forms[c, 300, 64][0] for c in tk.OUTPUTS):
        raise AssertionError(f"the short form's rule picked {forms}")
    # one pair (Aligner.align's launch): one warp on the card
    args, subs = batch(1, 192, 192, full=1)
    for cls in tk.OUTPUTS:
        plan = check(cls, "one pair of 192 x 192 SW 11/1", args,
                     dict(subs, open_=11, ext=1, mode="sw", free=(True,) * 4,
                          width="sat"), subs["qidx"])
        if plan[:2] != (6, 1):
            raise AssertionError(f"one pair: the rule picked {plan}")
    log("[28 short form vs plain] one pair of 192 x 192, every class: equal, "
        "one warp")
    q4b, r4b = cfg4b
    cig_al = (pt.Aligner.new().matrix(blosum).gap_open(11).gap_extend(1)
              .semi_global().build())
    b4b, _, _ = cig_al._pack(q4b, r4b)
    chunk = (b4b.ridx[:512], b4b.qlen_t[:512], b4b.rlen_t[:512])
    chunk_kw = dict(open_=11, ext=1, mode="sg", free=(True,) * 4,
                    width="sat", table=b4b.table, qidx=b4b.qidx[:512])
    check("trace", "cfg4b's first 512 pairs", chunk, chunk_kw,
          b4b.qbytes[:512])
    qs, rs = sw_pairs
    ssw_al = (pt.Aligner.new().matrix(blosum).gap_open(11).gap_extend(1)
              .build())
    sb, _, _ = ssw_al._pack(qs[:1024], rs[:1024])
    ssw_args = (sb.ridx, sb.qlen_t, sb.rlen_t)
    ssw_kw = dict(chunk_kw, mode="sw", table=sb.table, qidx=sb.qidx)
    check("trace", "ssw_batch's 1,024 SW pairs", ssw_args, ssw_kw, sb.qbytes)
    head_args, head_kw = headline_inputs(torch, dev)
    hb, hq, ha = head_kw["profile"].shape
    head_kw["qidx"] = t(np.random.default_rng(3).integers(
        0, ha, size=(hb, hq)))                        # bench.py:621-624
    check("stats", "the headline's first 1,024 pairs",
          tuple(a[:1024] for a in head_args),
          dict(head_kw, profile=head_kw["profile"][:1024],
               qidx=head_kw["qidx"][:1024]))
    log("[28 short form vs plain] align_cigars' 512-pair chunk of cfg4b "
        "and ssw_batch's 1,024 SW pairs (trace, walk), 1,024 pairs of the "
        "stats headline: equal")

    # the main paths on the short form, and no banded form
    def sw():
        return pt.Aligner.new().matrix(blosum).gap_open(11).gap_extend(1) \
            .local()

    st_al = sw().use_stats().build()
    one = pt.Aligner.new().gap_open(5).gap_extend(2).build()
    q150, r150 = random_seqs(rng, DNA, 2, 150, 150)
    launches = {}
    for name, call, cls in (
            ("align_cigars", lambda: cig_al.align_cigars(q4b, r4b), "trace"),
            ("ssw_batch", lambda: ssw_al.ssw_batch(qs[:1024], rs[:1024]),
             "trace"),
            ("use_stats align_batch", lambda: st_al.align_batch(qs, rs),
             "stats"),
            ("align_batch", lambda: sw().build().align_batch(qs, rs),
             "score"),
            ("Aligner.align 150 bp", lambda: one.align(q150, r150), "score"),
            ("use_last_rowcol align_batch",
             lambda: sw().use_last_rowcol().build().align_batch(qs, rs),
             "rowcol"),
            ("use_table + use_stats align_batch of 512",
             lambda: sw().use_table().use_stats().build().align_batch(
                 qs[:512], rs[:512]), "stats_table")):
        reset_launches(tk, tw)
        call()
        torch.cuda.synchronize()
        launches[name] = {"short": tk.SHORT_LAUNCHES[cls],
                          "block": tk.CHUNKED_LAUNCHES,
                          "banded": banded_launches(tk)[cls],
                          "walk": tw.LAUNCHES}
    log(f"[28 short form main paths] launches {launches}")
    if any(v["short"] < 1 or v["block"] or v["banded"]
           for v in launches.values()):
        raise AssertionError(f"a main path left the short form: {launches}")

    # -- 29. timings ---------------------------------------------------------------
    chunk_kw = dict(chunk_kw, outputs="trace")
    head_kw = dict(head_kw, outputs="stats")
    # the trace class also at the whole of cfg4b (use_trace() align_batch's
    # one launch) and at ssw_batch's 1,024 SW pairs: more pairs a launch
    # than align_cigars' chunk; K1a at the score headline, K1d at phase
    # 13's 512-pair batch
    tab_args, tab_kw = tab
    shapes = (("K1b chunk", chunk, chunk_kw),
              ("K1b cfg4b 4,096", (b4b.ridx, b4b.qlen_t, b4b.rlen_t),
               dict(chunk_kw, qidx=b4b.qidx)),
              ("K1b ssw_batch 1,024", ssw_args, dict(ssw_kw, outputs="trace")),
              ("K1c headline", head_args, head_kw),
              ("K1a headline", head[0], dict(head[1], outputs="score"))) + \
        tuple((f"K1d {cls} 512", tab_args, dict(tab_kw, outputs=cls))
              for cls in PLANE_CLASSES[1:]) + \
        tuple((f"{k} at K1d's 512", tab_args, dict(tab_kw, outputs=cls))
              for k, cls in (("K1a", "score"), ("K1c", "stats")))
    times = {}
    for name, args, kw in shapes:
        short = time_cuda(torch, lambda: tk.score_align(*args, **kw))
        block = time_cuda(torch, lambda: tk.score_chunked(*args, **kw))
        short_k = device_ms(torch, lambda: tk.score_align(*args, **kw),
                            "short_kernel")
        block_k = device_ms(torch, lambda: tk.score_chunked(*args, **kw),
                            "segment_kernel")
        times[name] = (short, block, short_k, block_k)
        B, Rp = args[0].shape
        Qp = (kw["qidx"] if kw.get("profile") is None
              else kw["profile"]).shape[1]
        log(f"[29 timing] {name} ({B} pairs padded to {Qp} x {Rp}): short "
            f"form {short} ms a call, kernel {short_k} ms; the block "
            f"kernel's one-shot form {block} ms a call, kernel {block_k} ms "
            f"[{card}]")
    e2e = {}
    for name, call in (("align_cigars cfg4b",
                        lambda: cig_al.align_cigars(q4b, r4b)),
                       ("use_stats align_batch SW 8192",
                        lambda: st_al.align_batch(qs, rs))):
        ms = time_host(call)
        with stages.measuring():
            for _ in range(5):
                call()
            snap = stages.snapshot()
        e2e[name] = ms
        per_call = {k: v["ms"] / 5 for k, v in snap.items() if "ms" in v}
        log(f"[29 timing] {name} e2e median {ms} ms; stages, ms per call "
            f"summed over its launches: {json.dumps(per_call)} [{card}]")
    regs = short_registers(_build.BUILD_LOG, tk.OUTPUTS)
    log(f"[29 timing] registers and spill bytes of the short form (nvcc "
        f"{'ran' if _build.BUILD_LOG else 'cached'}): {regs}")
    spilled = {k: v for k, v in regs.items() if v[1]}
    if spilled:
        raise AssertionError(f"short forms spill: {spilled}")
    return {"trace": {"max_abs_err": errs["trace"],
                      "chunk_ms": times["K1b chunk"][0],
                      "chunk_kernel_ms": times["K1b chunk"][2],
                      "block_chunk_ms": times["K1b chunk"][1],
                      "block_chunk_kernel_ms": times["K1b chunk"][3],
                      "kernel_ms_beside_block": {
                          k: {"short": v[2], "block": v[3]}
                          for k, v in times.items() if k.startswith("K1b")},
                      "e2e_ms": e2e["align_cigars cfg4b"]},
            "stats": {"max_abs_err": errs["stats"],
                      "kernel_ms": times["K1c headline"][2],
                      "block_ms": times["K1c headline"][1],
                      "block_kernel_ms": times["K1c headline"][3],
                      "e2e_ms": e2e["use_stats align_batch SW 8192"]},
            **{cls: {"max_abs_err": errs[cls],
                     "kernel_ms": times[name][2],
                     "block_kernel_ms": times[name][3]}
               for cls, name in [("score", "K1a headline")] + [
                   (c, f"K1d {c} 512") for c in PLANE_CLASSES[1:]]}}


def kernel_times(torch, tk, tw, card, band_inputs, walk_inputs) -> dict:
    """Phase 29's kernel times of the banded mode and the walk, by
    torch.profiler (which this script uses only from phase 29 on): the
    banded warp form and the score class's masked full sweep (forced) on
    cfg2 and on the long banded batch (phase 15's inputs), the block
    kernel's masked sweep on the bw 200 batch, each other banded class
    (NW) on cfg2 on the short form's masked sweep, and the tiled walk on
    cfg4b's 4,096 pairs and a 512-pair chunk of them (phase 9's planes).
    Returns them by kernel."""
    out = {"band": {}, "masked": {}, "classes": {}, "walk": {}}
    masked_kernel = {"cfg2": "short_kernel", "long": "segment_kernel"}
    for name in ("cfg2", "long"):
        args, kw = band_inputs[name]
        out["band"][name] = device_ms(
            torch, lambda: tk.score_align(*args, **kw), "band_kernel", n=5)
        out["masked"][name] = banded_masked(tk, lambda: device_ms(
            torch, lambda: tk.score_align(*args, **kw), masked_kernel[name],
            n=3))
        log(f"[29 timing] banded {name}: the warp form's kernel "
            f"{out['band'][name]} ms, the masked sweep's (score class, "
            f"{masked_kernel[name]}) {out['masked'][name]} ms [{card}]")
    args, kw = band_inputs["wide"]
    out["wide"] = device_ms(torch, lambda: tk.score_align(*args, **kw),
                            "segment_kernel", n=3)
    log(f"[29 timing] the bw 200 batch: the block kernel's masked sweep "
        f"{out['wide']} ms of kernel [{card}]")
    args, kw = band_inputs["cfg2"]
    for cls in tk.OUTPUTS[1:]:
        ckw = dict(kw, outputs=cls)
        out["classes"][cls] = device_ms(
            torch, lambda: tk.score_align(*args, **ckw), "short_kernel",
            n=3)
    log(f"[29 timing] banded classes on cfg2 (NW 11/1, bw 16), the short "
        f"form's masked sweep, ms of kernel: {out['classes']} [{card}]")
    for name, walk in walk_inputs.items():
        out["walk"][name] = device_ms(torch, lambda: tw.device_walk(*walk),
                                      "trace_walk_kernel")
        log(f"[29 timing] the tiled walk on {name}: {out['walk'][name]} ms "
            f"of kernel [{card}]")
    return out


def long_walk(torch, pt, tk, tw, card) -> dict:
    """Phase 30: the walk on long global paths.  16 DNA pairs of 4,096 bp,
    each query its reference with 10% of the letters redrawn (numpy seed
    30, a generator of its own), NW 5/1: the chunked sweep's trace class
    (K1f), counted from zero, then the tiled walk; 2 pairs held to the
    plain walk, all 16 to golden's CIGAR rule through the runs; the walk
    timed by CUDA events and torch.profiler.  Returns its row's numbers."""
    rng = np.random.default_rng(30)
    alpha = np.frombuffer(DNA, np.uint8)
    refs = rng.integers(0, 4, size=(16, LONG_LEN))
    qrys = np.where(rng.random(refs.shape) < 0.1,
                    rng.integers(0, 4, size=refs.shape), refs)
    qs = [alpha[q].tobytes() for q in qrys]
    rs = [alpha[r].tobytes() for r in refs]
    al = (pt.Aligner.new().matrix(pt.Matrix.create(DNA, 2, -3)).gap_open(5)
          .gap_extend(1).build())
    batch, _, _ = al._pack(qs, rs)
    args = (batch.ridx, batch.qlen_t, batch.rlen_t)
    kw = dict(open_=5, ext=1, mode="nw", free=F4, width="32",
              table=batch.table, qidx=batch.qidx, outputs="trace")
    reset_launches(tk, tw)
    out = tk.score_align(*args, **kw)
    walk = (out["trace_table"], batch.qbytes, batch.rbytes,
            out["end_query"], out["end_ref"], "nw", F4)
    ops, bq, br = tw.device_walk(*walk)
    torch.cuda.synchronize()
    launches = (tk.CHUNKED_LAUNCHES, tw.LAUNCHES)
    if launches != (1, 1):
        raise AssertionError(f"the long walk launched (chunked, walk) "
                             f"{launches}")
    n = 2
    want = tw.device_walk_plain(*(a[:n] for a in walk[:5]), "nw", F4)
    err = max_abs_diff(dict(zip("obr", (ops[:n], bq[:n], br[:n]))),
                       dict(zip("obr", want)))
    if err:
        raise AssertionError(f"long walk != plain, max |diff| {err}")
    if (bq != 0).any() or (br != 0).any():
        raise AssertionError("a global walk did not begin at (0, 0)")
    steps = int((ops != 0).sum().item())
    ms = time_cuda(torch, lambda: tw.device_walk(*walk))
    kernel_ms = device_ms(torch, lambda: tw.device_walk(*walk),
                          "trace_walk_kernel", n=5)
    log(f"[30 long walk] 16 DNA pairs of {LONG_LEN} bp, 10% redrawn, NW 5/1: "
        f"the chunked sweep's trace, then the tiled walk ({steps} steps, "
        f"{steps / 16} a pair); {n} pairs equal to the plain walk, every "
        f"walk begins at (0, 0); {ms} ms a call, {kernel_ms} ms of kernel, "
        f"{kernel_ms * 1e6 / (steps / 16)} ns a step [{card}]")
    return {"long_ms": ms, "long_kernel_ms": kernel_ms,
            "long_steps": steps}


CFG7_PAIRS = 16384
# device activity in a Chrome trace of torch.profiler
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def check_stream(name, got, want) -> None:
    """A stream's results: as many as align_batch's, every field equal."""
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} results, {len(want)} "
                             f"wanted")
    check_fields(name, got, want)


def busy_share(events, window) -> dict:
    """The card's share of busy time inside a window of a Chrome trace:
    the union of its kernels, copies and fills, clipped to the window's
    [ts, ts + dur], over dur.  Also the kernels' count inside."""
    lo, hi = window["ts"], window["ts"] + window["dur"]
    spans = sorted((max(lo, e["ts"]), min(hi, e["ts"] + e.get("dur", 0)))
                   for e in events if e.get("cat") in DEVICE_CATS
                   and e["ts"] < hi and e["ts"] + e.get("dur", 0) > lo)
    busy, end = 0.0, lo
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    kernels = sum(1 for e in events if e.get("cat") == "kernel"
                  and lo <= e["ts"] < hi)
    return {"window_ms": window["dur"] / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / window["dur"], "kernels": kernels}


def stream_path(torch, pt, tk, tw, dispatch, golden, stages, blosum,
                card) -> dict:
    """Phase 31: ``StreamingAligner`` on the card, and a captured trace.
    cfg7 (bench.py's stream: 16,384 SW BLOSUM62 11/1 protein pairs of
    140-160 residues at flush 8,192, numpy seed 31, a generator of its
    own) counted from zero and held to ``align_batch`` and golden, then
    timed beside ``align_batch`` of the same pairs; a mixed stream of
    single submissions; the stats, trace and table classes and a long
    DNA bucket on the segment route; and ``utils.profiling.capture``
    around ``align_batch`` and a cfg7 run, with the card's busy share of
    each.  Returns the numbers for the kernels line."""
    from parasail_rs_tpu_torch.engine import StreamingAligner
    from parasail_rs_tpu_torch.utils import profiling
    from parasail_rs_tpu_torch.utils.shapes import length_bucket

    rng = np.random.default_rng(31)
    qs = random_seqs(rng, PROTEIN, CFG7_PAIRS, 140, 160)
    rs = random_seqs(rng, PROTEIN, CFG7_PAIRS, 140, 160)

    def build(*setters, matrix=blosum, open_=11, ext=1):
        b = (pt.Aligner.new().matrix(matrix).gap_open(open_)
             .gap_extend(ext).local())
        for name in setters:
            b = getattr(b, name)()
        return b.build()

    def stream(aligner, q, r, flush_size=2048):
        with StreamingAligner(aligner, flush_size=flush_size) as st:
            handles = st.submit_many(q, r)
            st.flush()
            return [h.result(timeout=120) for h in handles]

    def stream_run():
        # bench.py's cfg7 run: the results are read inside the window
        with StreamingAligner(sw, flush_size=8192) as st:
            handles = st.submit_many(qs, rs)
            st.flush()
            return sum(h.result().get_score() for h in handles)

    # -- cfg7, counted from zero ---------------------------------------------
    sw = build()
    # the stream's cap of 2^28 cells a launch (the reference's) holds a
    # (192, 192) bucket to 7,281 pairs, below the flush size
    cap = min(8192, (1 << 28) // (192 * 192))
    want_launches = -(-CFG7_PAIRS // cap)
    reset_launches(tk, tw)
    got = stream(sw, qs, rs, 8192)
    short = dict(tk.SHORT_LAUNCHES)
    others = (tk.CHUNKED_LAUNCHES, tk.SEGMENT_LAUNCHES, tk.ROWSEG_LAUNCHES,
              tk.BANDED_WARP_LAUNCHES, sum(tk.BANDED_CLASS_LAUNCHES.values()),
              tw.LAUNCHES)
    launches = short["score"]
    if launches != want_launches or sum(short.values()) != launches or \
            any(others):
        raise AssertionError(
            f"cfg7 stream launched the short form {short} and (chunked, "
            f"segment, tile, banded warp, banded masked sweep, walk) "
            f"{others}; expected {want_launches} score launches "
            f"and nothing else")
    if sw.route_counter != {("cuda_kernel", ""): want_launches}:
        raise AssertionError(f"cfg7 stream routes {sw.route_counter}")
    check_stream("cfg7 stream", got, sw.align_batch(qs, rs))
    for b in rng.choice(CFG7_PAIRS, size=16, replace=False).tolist():
        g = golden.align_seqs(qs[b], rs[b], blosum, 11, 1, "sw")
        if (got[b].get_score(), got[b].get_end_query(),
                got[b].get_end_ref()) != (g.score, g.end_query, g.end_ref):
            raise AssertionError(f"cfg7 stream pair {b} != golden")
    log(f"[31 stream] cfg7: {CFG7_PAIRS} pairs at flush 8192 in "
        f"{launches} launches of the short form's score class (buckets of "
        f"at most {cap} pairs by the 2^28-cell cap), nothing else, all on "
        f"cuda_kernel; scores and end cells equal to align_batch, 16 "
        f"sampled pairs equal to golden")

    stream_ms = time_host(stream_run)
    batch_ms = time_host(
        lambda: sum(a.get_score() for a in sw.align_batch(qs, rs)))
    with stages.measuring():
        stream_run()
        snap = stages.snapshot()
    log(f"[31 timing] cfg7 stream e2e median {stream_ms} ms "
        f"({CFG7_PAIRS / stream_ms * 1e3} aln/s); align_batch of the same "
        f"{CFG7_PAIRS} pairs (one launch) {batch_ms} ms "
        f"({CFG7_PAIRS / batch_ms * 1e3} aln/s); the stream's stages, ms "
        f"in one run (the threads overlap): {json.dumps(snap)} [{card}]")

    # -- a mixed stream of single submissions ---------------------------------
    alpha = list(PROTEIN)

    def draw():
        return rng.choice(alpha, size=rng.integers(50, 250)).astype(
            "uint8").tobytes()

    mq = [draw() for _ in range(2000)]
    mr = [draw() for _ in range(2000)]
    keys = [(length_bucket(len(q)), length_bucket(len(r)))
            for q, r in zip(mq, mr)]
    st = StreamingAligner(sw, flush_size=1024)
    try:
        hs = [st.submit(q, r) for q, r in zip(mq, mr)]
        if any(h.done() for h in hs):
            raise AssertionError("a bucket of the mixed stream resolved "
                                 "before it filled")
        # no bucket of 2,000 such pairs holds 1,024: top the (192, 192)
        # bucket up with cfg7 pairs until it launches
        top = 1024 - keys.count((192, 192))
        tq, tr = qs[:top], rs[:top]
        hs += [st.submit(q, r) for q, r in zip(tq, tr)]
        keys += [(192, 192)] * top
        full = [h for h, k in zip(hs, keys) if k == (192, 192)]
        deadline = time.perf_counter() + 60
        while not all(h.done() for h in full) and \
                time.perf_counter() < deadline:
            time.sleep(0.002)
        counts = collections.Counter(keys)
        small = min(counts, key=counts.get)
        part = [h for h, k in zip(hs, keys) if k == small]
        rest = [h for h, k in zip(hs, keys) if k not in (small, (192, 192))]
        if not all(h.done() for h in full) or \
                any(h.done() for h in part + rest):
            raise AssertionError(
                "mixed stream: the full (192, 192) bucket did not resolve "
                "alone without flush()")
        reset_launches(tk, tw)
        part[0].result(timeout=60)
        if tk.SHORT_LAUNCHES["score"] != 1 or \
                not all(h.done() for h in part) or \
                any(h.done() for h in rest):
            raise AssertionError(
                f"mixed stream: result() of a {small} handle launched "
                f"{tk.SHORT_LAUNCHES} and did not resolve its bucket alone")
        st.flush()
        check_stream("mixed stream", [h.result(timeout=60) for h in hs],
                   sw.align_batch(mq + tq, mr + tr))
    finally:
        st.close()
    log(f"[31 stream] mixed: 2000 pairs of 50-250 residues in "
        f"{len(counts)} buckets, then {top} cfg7 pairs, submitted one at a "
        f"time at flush 1024: the (192, 192) bucket resolved without "
        f"flush() while the others waited; result() of a {small} handle "
        f"({counts[small]} pairs) launched that bucket alone; all equal "
        f"to align_batch")

    # -- the other classes ----------------------------------------------------
    stats = build("use_stats")
    got = stream(stats, qs[:4096], rs[:4096])
    want = stats.align_batch(qs[:4096], rs[:4096])
    check_stream("stats stream", got, want)
    tr = build("use_trace")
    q5, r5 = qs[:512], rs[:512]
    got = stream(tr, q5, r5, 256)
    want = tr.align_batch(q5, r5)
    check_stream("trace stream", got, want)
    cigars = tr.cigars(got, q5, r5)
    if cigars != tr.cigars(want, q5, r5) or \
            cigars != tr.align_cigars(q5, r5)[1]:
        raise AssertionError("trace stream: CIGARs differ from align_batch "
                             "+ cigars() or align_cigars")
    tab = build("use_table")
    got = stream(tab, qs[:64], rs[:64])
    want = tab.align_batch(qs[:64], rs[:64])
    check_stream("table stream", got, want)
    dq = random_seqs(rng, DNA, 8, LONG_LEN, LONG_LEN)
    dr = random_seqs(rng, DNA, 8, LONG_LEN, LONG_LEN)
    dna = build(matrix=pt.Matrix.create(DNA, 2, -3), open_=5, ext=1)
    reset_launches(tk, tw)
    got = stream(dna, dq, dr)
    # the score class's segments on the packed form, none flagged
    seg = tk.SEGMENT16_LAUNCHES
    if dna.route_counter != {("cuda_segments", "long pairs"): 1} or \
            not seg or tk.SEGMENT_LAUNCHES:
        raise AssertionError(f"long DNA bucket: routes {dna.route_counter}, "
                             f"packed segment launches {seg}, int32 "
                             f"{tk.SEGMENT_LAUNCHES}")
    check_stream("long DNA stream", got, dna.align_batch(dq, dr))
    # pairs that leave the packed form's band (SW of identical 3 kbp
    # sequences at 12 a match): the fetch thread reruns them under the
    # stream's lock; scores and ends are the int32 form's, every field
    # align_batch's
    base = random_seqs(rng, DNA, 1, 3000, 3000)[0]
    bq = [base] * 3 + random_seqs(rng, DNA, 5, 1500, 3000)
    br = [base] * 3 + random_seqs(rng, DNA, 5, 1500, 3000)
    big = build(matrix=pt.Matrix.create(DNA, 12, -3), open_=14, ext=1)
    reran = dispatch.RERUN16["pairs"]
    got = stream(big, bq, br)
    reran = dispatch.RERUN16["pairs"] - reran
    batch, _, _ = big._pack(bq, br)
    want = dispatch.execute_segments(batch, gap_open=14, gap_extend=1,
                                     mode="sw", free=(True,) * 4,
                                     outputs="score", width="sat")
    want = {k: v.cpu().numpy() for k, v in want.items()}
    for b, a in enumerate(got):
        if (a.get_score(), a.get_end_query(), a.get_end_ref()) != (
                want["score"][b], want["end_query"][b], want["end_ref"][b]):
            raise AssertionError(f"band-crossing stream: pair {b} differs "
                                 f"from the int32 form")
    check_stream("band-crossing stream", got, big.align_batch(bq, br))
    if reran < 3:
        raise AssertionError(f"band-crossing stream: {reran} pairs rerun, "
                             f"3 or more wanted")
    log(f"[31 stream] use_stats() 4096 pairs, use_trace() 512 (CIGARs), "
        f"use_table() 64: equal to align_batch; 8 DNA pairs of {LONG_LEN} "
        f"bp SW 5/1: one bucket on cuda_segments ({seg} packed segment "
        f"launches), equal to align_batch; 8 SW pairs of 1.5-3 kbp, three "
        f"identical (36,000): {reran} rerun on the fetch thread, equal to "
        f"the int32 form and to align_batch")

    # -- a captured trace -----------------------------------------------------
    log_dir = os.path.join(HERE, "chiprun_out", "phase31_trace")
    q8, r8 = qs[:8192], rs[:8192]
    sw.align_batch(q8, r8)
    torch.cuda.synchronize()
    with profiling.capture(log_dir):
        with profiling.trace_region("smoke.align_batch"):
            sum(a.get_score() for a in sw.align_batch(q8, r8))
        with profiling.trace_region("smoke.stream"):
            stream_run()
        torch.cuda.synchronize()
    files = profiling.trace_files(log_dir)
    if not files:
        raise AssertionError(f"capture wrote no trace under {log_dir}")
    with open(files[-1]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    names = collections.Counter(e.get("name") for e in events)
    if not names["pt.execute.sw.score"]:
        raise AssertionError("the captured trace holds no "
                             "pt.execute.sw.score region")
    windows = {}
    for name in ("smoke.align_batch", "smoke.stream"):
        w = next(e for e in events if e.get("name") == name
                 and e.get("cat") == "user_annotation")
        windows[name] = busy_share(events, w)
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if not kernels:
        for w in windows.values():
            w["busy_ms"] = w["busy_share"] = None
    log(f"[31 trace] {os.path.relpath(files[-1], HERE)}: "
        f"{names['pt.execute.sw.score']} pt.execute.sw.score regions, "
        f"{kernels} kernel events"
        + ("" if kernels else " (the profiler recorded no kernel: the "
           "busy shares below are not measured)")
        + f"; the card's busy share of each window: {json.dumps(windows)} "
        f"[{card}]")
    return {"stream_ms": stream_ms, "batch_ms": batch_ms, "stages": snap,
            "launches": launches, "windows": windows, "kernels": kernels}


# Phase 32's run: the cover schedule (9 API checks and about 150 aimed
# draws) and random draws up to this budget
FUZZ_SEED = 32
FUZZ_DRAWS = 170


def load_fuzzer():
    """``tools/fuzz_torch.py`` (``tools/`` is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "fuzz_torch", os.path.join(HERE, "tools", "fuzz_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fuzz_path(torch, tk, tw, card, device="cuda") -> dict:
    """Phase 32: the fuzzer's cover run on the card, then the port's
    entry points (``entry()`` and ``dryrun_multichip(1)`` over NCCL).
    Returns the run's summary."""
    from parasail_rs_tpu_torch import entry as pt_entry

    fuzz = load_fuzzer()
    reset_launches(tk, tw)
    try:
        res = fuzz.run(device, draws=FUZZ_DRAWS, seed=FUZZ_SEED, cover=True,
                       log=log)
    except fuzz.Mismatch as e:
        out = os.path.join(HERE, "chiprun_out", "phase32_repro.json")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(e.repro, f, indent=1)
        log(f"[32 fuzz] MISMATCH (repro in {os.path.relpath(out, HERE)}): "
            f"{json.dumps(e.repro)[:4000]}")
        raise
    ran = dict(fuzz.launches())
    families = collections.Counter(k.split()[0] for k in res["reached"])
    compiled = collections.Counter(k.split()[0] for k in res["compiled"])
    log(f"[32 fuzz] seed {FUZZ_SEED}: {res['draws']} draws ({res['api']} "
        f"API, {res['ops']} ops), forms reached {len(res['reached'])} of "
        f"{len(res['compiled'])} compiled ("
        + ", ".join(f"{k} {families[k]}/{compiled[k]}" for k in compiled)
        + f"), plan axes {len(fuzz.AXES) - len(res['unreached_axes'])}/"
        f"{len(fuzz.AXES)}, mismatches {res['mismatches']}, "
        f"{res['seconds']:.1f} s ({res['draws'] / res['seconds']:.2f} "
        f"draws/s) [{card}]")
    log(f"[32 fuzz] draws and seconds by check: "
        f"{json.dumps(res['checks'])} "
        f"{json.dumps({k: round(v, 2) for k, v in res['seconds_by'].items()})}"
        f" [{card}]")
    log(f"[32 fuzz] launches of the run by kernel family: {json.dumps(ran)}")
    if res["unreached"] or res["unreached_axes"] or not all(ran.values()):
        raise AssertionError(f"phase 32 left forms unreached: "
                             f"{res['unreached']} {res['unreached_axes']}")

    reset_launches(tk, tw)
    fn, args = pt_entry.entry()
    out = fn(*args)
    launched = dict(tk.SHORT_LAUNCHES)
    profile, qidx, ridx, qlen, rlen = args
    want = tk.score_align_plain(ridx, qlen, rlen, profile=profile, qidx=qidx,
                                **fn.keywords)
    if launched != {**dict.fromkeys(launched, 0), "score": 1} or \
            tk.CHUNKED_LAUNCHES or max_abs_diff(out, want):
        raise AssertionError(f"entry(): short form launches {launched}, "
                             f"block {tk.CHUNKED_LAUNCHES}, "
                             f"error {max_abs_diff(out, want)}")
    log("[32 entry] entry(): 32 pairs of 64 x 64 on the short form's score "
        "class, equal to plain")
    t0 = time.perf_counter()
    pt_entry.dryrun_multichip(1, timeout=300)
    log(f"[32 entry] dryrun_multichip(1) over NCCL: ok in "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    return res


def packed_registers(build_log: str) -> dict:
    """Registers and spill-store bytes of each ptseg16::segment_kernel form
    (the packed score form) from
    ``-Xptxas -v``'s log: {"R<rows> <sw|nw> <pair|rows>": (registers,
    spill bytes)}."""
    out, form, spill = {}, None, 0
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            form, spill = None, 0
            m = re.search(r"ptseg1614segment_kernelILi(\d)ELb(\d)ELb(\d)E",
                          line)
            if m:
                form = (f"R{m.group(1)} {'sw' if m.group(2) == '1' else 'nw'}"
                        f" {'pair' if m.group(3) == '1' else 'rows'}")
        elif "spill stores" in line and form is not None:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "registers" in line and form is not None:
            out[form] = (int(line.split("Used")[1].split("registers")[0]),
                         spill)
    return out


def wfa_pairs(rng, n: int, length: int, err: float = 0.05):
    """n random ACGT sequences of ``length`` and each a partner with
    err * length edits (mismatch, insertion, deletion alike)."""
    alpha = np.frombuffer(DNA, np.uint8)
    qs, rs = [], []
    for _ in range(n):
        q = alpha[rng.integers(0, 4, size=length)]
        r = list(q)
        for _ in range(int(err * length)):
            at = int(rng.integers(0, len(r)))
            kind = int(rng.integers(0, 3))
            if kind == 0:
                r[at] = alpha[(list(alpha).index(r[at]) + 1 +
                               int(rng.integers(0, 3))) % 4]
            elif kind == 1:
                r.insert(at, alpha[int(rng.integers(0, 4))])
            else:
                del r[at]
        qs.append(q.tobytes())
        rs.append(bytes(r))
    return qs, rs


def packed_path(torch, pt, tk, dispatch, stages, card, build_log) -> dict:
    """Phase 33, the packed score form against the int32 form; returns
    its times and registers."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(33)
    t33 = time.perf_counter()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    modes = ([("nw", F4)] + [("sg", f) for f in SG_FREE] +
             [("sw", (True,) * 4)])
    forms = ((0, 0), (2, 1), (4, 2), (8, 1), (2, 4), (8, 2))
    n = 0
    for mode, free in modes:
        for subs in ("pair", "table", "profile"):
            B, Qp, Rp = (37, 100, 200) if n % 2 else (20, 300, 260)
            A = 4 if subs == "pair" else 20
            seg = (48, 80, 128, 260)[n % 4]
            rows, cluster = forms[n % len(forms)]
            warps = (0, 1, 2, 8)[n % 4]
            open_, ext = ((11, 1), (2, 2), (1, 3), (6, 2))[n % 4]
            n += 1
            ql = rng.integers(0, Qp + 1, size=B)
            rl = rng.integers(0, Rp + 1, size=B)
            ql[:7] = (0, 5, Qp, 32, 33, 64, 65)
            rl[:7] = (7, 0, Rp, seg, seg + 1, 64, 129)
            table = rng.integers(-4, 8, size=(A, A))
            qidx = rng.integers(0, A, size=(1 if subs == "profile" else B,
                                            Qp))
            if subs == "profile":
                ql[:] = Qp - 3
                kw = dict(profile=t(table[qidx]))
            else:
                kw = dict(table=t(table), qidx=t(qidx))
            kw.update(open_=open_, ext=ext, mode=mode, free=free,
                      outputs="score", width="sat")
            args = (t(rng.integers(0, A, size=(B, Rp))), t(ql), t(rl))
            units = t(tk.pair_units(ql, rl))
            tk.SEGMENT_WARPS, tk._LANE_ROWS, tk._CLUSTER = warps, rows, \
                cluster
            got, gst = chain_segments(torch, tk.score_segment, args, seg,
                                      {**kw, "units": units})
            unforce(tk)
            want, wst = chain_segments(torch, tk.score_segment, args, seg,
                                       kw)
            name = (f"{mode}{tuple(int(x) for x in free)} {subs} "
                    f"{open_}/{ext} B {B} seg {seg} warps {warps} R {rows} "
                    f"C {cluster}")
            over = got.pop("over16")
            if bool(over.any()):
                raise AssertionError(f"packed form flagged {int(over.sum())}"
                                     f" pairs of {name}")
            err = max_abs_diff(got, want)
            rows_in = (torch.arange(Qp, device=dev)[None, :] <
                       args[1][:, None]) & (args[2] > 0)[:, None]
            for k in ("h", "f"):
                err = max(err, int(((gst[k] - wst[k]) * rows_in).abs().max()))
            err = max(err, int((gst["acc"][:, :5] - wst["acc"][:, :5])
                               .abs().max()))
            if err:
                raise AssertionError(f"packed form != int32 form on {name}: "
                                     f"max |diff| {err}")
        log(f"[33 packed vs int32] {mode}{tuple(int(x) for x in free)}: "
            "pair table, table and profile, odd and even B, 1-5 segments, "
            "equal to the int32 form, no pair flagged")
    unforce(tk)

    # pairs that leave the band, beside pairs that do not, through the API
    def band_case(mode, free, qs, rs, open_, ext, matrix):
        al = pt.Aligner.new().matrix(matrix).gap_open(open_) \
            .gap_extend(ext)
        al = {"sw": al.local(), "nw": al.global_()}[mode].build() \
            if mode in ("sw", "nw") else al.build()
        batch, _, _ = al._pack(qs, rs)
        stages.reset()
        stages.enable(True)
        try:
            got = dispatch.execute(batch, gap_open=open_, gap_extend=ext,
                                   mode=mode, free=free, outputs="score",
                                   width="sat")
            snap = stages.snapshot()
        finally:
            stages.enable(False)
        want = dispatch.execute_segments(batch, gap_open=open_,
                                         gap_extend=ext, mode=mode,
                                         free=free, outputs="score",
                                         width="sat")
        want = {k: v.cpu().numpy() for k, v in want.items()}
        for k in want:
            if not np.array_equal(np.asarray(got[k]), want[k]):
                raise AssertionError(f"band case {mode}: {k} differs from "
                                     f"the int32 form")
        return (snap.get("count.score16_pairs", {}).get("n", 0),
                snap.get("count.score16_reruns", {}).get("n", 0),
                int(np.asarray(want["promoted"]).sum()))

    dna = pt.Matrix.create("ACGT", 12, -3)
    base = random_seqs(rng, DNA, 1, 3000, 3000)[0]
    qs = [base] * 3 + random_seqs(rng, DNA, 5, 1500, 3000)
    rs = [base] * 3 + random_seqs(rng, DNA, 5, 1500, 3000)
    got = band_case("sw", (True,) * 4, qs, rs, 14, 1, dna)
    if got[0] != 8 or got[1] < 3 or got[2] < 3:
        raise AssertionError(f"SW band case: packed pairs, reruns, sat16 "
                             f"{got}")
    log(f"[33 packed band] SW of identical 3 kbp sequences (36,000): "
        f"{got[1]} of {got[0]} pairs recomputed by the int32 form, every "
        f"output equal to it")
    long_q = random_seqs(rng, DNA, 4, 17000, 17000)
    long_r = random_seqs(rng, DNA, 4, 17000, 17000)
    nw = pt.Matrix.create("ACGT", 0, -4)
    got = band_case("nw", F4, long_q + qs[3:], long_r + rs[3:], 8, 2, nw)
    if got[1] < 4:
        raise AssertionError(f"NW band case: packed pairs, reruns, sat16 "
                             f"{got}")
    log(f"[33 packed band] NW of 17 kbp (borders past -32,768): {got[1]} "
        f"of {got[0]} pairs recomputed, every output equal to the int32 "
        f"form")

    # timings: the WFA pairs' score cell shape, both forms
    times = {}
    wfa = pt.Aligner.new().matrix(nw).gap_open(8).gap_extend(2).global_() \
        .build()
    for length in (4096, 10000):
        qs, rs = wfa_pairs(rng, 128, length)
        batch, _, _ = wfa._pack(qs, rs)
        kw = dict(gap_open=8, gap_extend=2, mode="nw", free=F4,
                  outputs="score", width="sat")
        units = dispatch.packed_units(batch, "cuda_segments", "score", 8, 2)
        cells = float(np.dot(batch.qlen.astype(np.int64),
                             batch.rlen.astype(np.int64)))
        r16 = dispatch.execute_segments(batch, units=units, **kw)
        r32 = dispatch.execute_segments(batch, **kw)
        if bool(r16.pop("over16").any()) or max_abs_diff(r16, r32):
            raise AssertionError(f"128 x {length}: packed != int32")
        ms16 = time_cuda(torch, lambda: dispatch.execute_segments(
            batch, units=units, **kw))
        ms32 = time_cuda(torch, lambda: dispatch.execute_segments(batch,
                                                                  **kw))
        k16 = device_ms(torch, lambda: dispatch.execute_segments(
            batch, units=units, **kw), "ptseg16::segment_kernel", n=3)
        k32 = device_ms(torch, lambda: dispatch.execute_segments(batch,
                                                                 **kw),
                        "ptsegblock::segment_kernel<0", n=3)
        plan16 = tk.segment16_plan(-(-batch.size // 2), batch.qp,
                                   dispatch.SEGMENT_COLS["score"], 4)
        plan32 = tk.block_plan("score", batch.size, batch.qp,
                               dispatch.SEGMENT_COLS["score"], 4)
        times[length] = dict(packed_ms=ms16, int32_ms=ms32,
                             packed_kernel_ms=k16, int32_kernel_ms=k32,
                             packed_gcups=cells / ms16 / 1e6,
                             int32_gcups=cells / ms32 / 1e6,
                             packed_plan=plan16, int32_plan=plan32)
        log(f"[33 packed time] 128 x {length} bp NW 8/2: packed "
            f"{ms16:.3f} ms a call ({cells / ms16 / 1e6:.1f} GCUPS; a "
            f"segment's kernel {k16:.3f} ms, plan {plan16}), int32 "
            f"{ms32:.3f} ms ({cells / ms32 / 1e6:.1f} GCUPS; kernel "
            f"{k32:.3f} ms, plan {plan32}) [{card}]")
    regs = packed_registers(build_log)
    spills = {k: v for k, v in regs.items() if v[1]}
    log(f"[33 packed registers] {regs}")
    if len(regs) != 12 or spills:
        raise AssertionError(f"packed forms: {len(regs)} compiled, spills "
                             f"{spills}")
    log(f"[33 packed] {time.perf_counter() - t33:.1f} s")
    return {"times": times, "registers": regs}


def random_seqs_of(rng, alphabet: bytes, lens) -> list:
    """Sequences of the given lengths, letters drawn uniformly."""
    alpha = np.frombuffer(alphabet, np.uint8)
    return [alpha[rng.integers(0, len(alpha), size=n)].tobytes()
            for n in lens]


if __name__ == "__main__":
    sys.exit(main())
