#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the score kernel from ``parasail_rs_tpu_torch/csrc`` with nvcc and
runs five phases on ``cuda``; any failure raises and the script exits
non-zero without printing a result:

1. build: the library's path and build time;
2. kernel vs plain: the CUDA kernel against its plain PyTorch version on
   the same device tensors, at the headline shape (8,192 pairs of 150
   residues padded to 160, a seeded (B, 160, 25) profile, SW 11/1, width
   sat) and on small seeded ragged batches covering NW, the nine SG
   free-end sets, SW, every width, both substitution forms, open < ext,
   open == ext, BLOSUM62, a PSSM and scores beyond int8: exact equality;
3. golden: 16 sampled pairs of the 8,192-pair BLOSUM62 batch against the
   scalar golden oracle;
4. the main path through the public API on the default device: SW
   BLOSUM62 on 8,192 protein pairs of 140-160 residues, one profile
   against 16,384 references, one 150 bp NW DNA pair, and 128 DNA pairs
   of 2,000 bp.  Kernel launches are counted from zero over this phase
   only; every launch must route to "cuda_kernel", and the scores must
   equal the plain version's on the same batches;
5. timings: kernel and plain medians at the headline shape (CUDA events,
   after warm-up) and the end-to-end ``align_batch`` time of the 8,192
   pairs, beside the card's name and power limit.

The line before the last is a JSON summary of every kernel; the last line
is ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
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


def small_cases(rng, torch, dev):
    """Seeded ragged batches (128 pairs, lengths < 32), as
    (name, args, kwargs) for score_align."""
    from parasail_rs_tpu.matrices import Matrix

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


def main() -> int:
    import torch

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
    from parasail_rs_tpu.golden import model as golden
    from parasail_rs_tpu.utils import stages
    from parasail_rs_tpu_torch.engine import dispatch
    from parasail_rs_tpu_torch.ops import _build
    from parasail_rs_tpu_torch.ops import scan_kernel as tk

    dev = torch.device("cuda")
    card = card_info()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"[1 build] ok: {os.path.relpath(path, HERE)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        f"{'ran' if _build.BUILD_SECONDS is not None else 'cached'})")

    # -- 2. kernel vs plain --------------------------------------------------
    rng = np.random.default_rng(1)
    head_args, head_kw = headline_inputs(torch, dev)
    max_err = compare(torch, tk, "headline", head_args, head_kw)
    log("[2 kernel vs plain] headline B=8192 Qp=Rp=160 A=25 SW 11/1 sat: "
        "equal")
    for name, (args, subs), kw in small_cases(rng, torch, dev):
        max_err = max(max_err, compare(torch, tk, name, args, {**kw, **subs}))
        log(f"[2 kernel vs plain] {name}: equal")

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
    tk.LAUNCHES = 0
    res_sw = sw.align_batch(qs, rs)
    res_prof = pa.align_batch(None, refs)
    res_nw = nw.align(q150, r150)
    res_long = lng.align_batch(lq, lr)
    launches = tk.LAUNCHES
    routes = dict(dispatch.ROUTE_COUNTS)
    log(f"[4 main path] launches={launches} routes={routes}")
    if launches < 4:
        raise AssertionError(f"main path launched the kernel {launches} "
                             "times, expected 4")
    if set(routes) != {("cuda_kernel", "")}:
        raise AssertionError(f"main path left the kernel route: {routes}")
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
        "pair, 128 x 2000 bp: all on cuda_kernel, equal to plain")

    # -- 5. timings -----------------------------------------------------------
    ms = time_cuda(torch, lambda: tk.score_align(*head_args, **head_kw))
    plain_ms = time_cuda(
        torch, lambda: tk.score_align_plain(*head_args, **head_kw), reps=5,
        warmup=1)
    table_ms = time_cuda(torch, lambda: tk.score_align(
        batch.ridx, batch.qlen_t, batch.rlen_t, open_=11, ext=1, mode="sw",
        free=(True,) * 4, width="sat", table=batch.table, qidx=batch.qidx))
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
    per_call = {k: v["ms"] / v["calls"] for k, v in snap.items()}
    log(f"[5 timing] card: {card}")
    log(f"[5 timing] headline kernel median {ms} ms "
        f"({8192 / ms * 1e3} aln/s, {8192 * 150 * 150 / ms / 1e6} GCUPS); "
        f"plain median {plain_ms} ms [{card}]")
    log(f"[5 timing] kernel on the SW BLOSUM62 8192-pair batch (table "
        f"form) median {table_ms} ms [{card}]")
    log(f"[5 timing] align_batch SW BLOSUM62 8192 pairs e2e median "
        f"{e2e_ms} ms ({8192 / e2e_ms * 1e3} aln/s), peak device memory "
        f"{peak_mib} MiB [{card}]")
    log(f"[5 timing] align_batch stages, ms per call (stage clocks on): "
        f"{json.dumps(per_call)} [{card}]")
    log(f"[5 timing] profile vs 16384 refs e2e median {prof_ms} ms; "
        f"NW 150 bp single pair median {nw_ms} ms [{card}]")

    print(json.dumps({"kernels": [{
        "name": "scan_score_align",
        "route": "cuda",
        "source": "parasail_rs_tpu_torch/csrc/scan_score.cu",
        "replaces": "parasail_rs_tpu/ops/scan_kernel.py:1453",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
