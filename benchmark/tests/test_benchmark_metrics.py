"""Metric arithmetic on synthetic readings, profiler events and stage
snapshots."""

from __future__ import annotations

import math

import numpy as np
import pytest

from benchmark import harness, roofline, stats, tracing
from benchmark.traffic.request import Request


def _reader(name):
    return harness.load_module("metrics", name)


def test_gcups_is_cells_over_window():
    r = harness.Reading(window_s=2.0, cells=6_000_000_000)
    assert _reader("gcups").read(r) == pytest.approx(3.0)
    assert _reader("gcups").read(harness.Reading()) is None


def test_p95_by_nearest_rank_over_every_call():
    lat = [i / 1000 for i in range(1, 101)]          # 1..100 ms
    r = harness.Reading(latencies_s=lat[::-1])
    assert _reader("p95_ms").read(r) == pytest.approx(95.0)
    assert _reader("call.p50_ms.single").read(r) == pytest.approx(50.0)
    assert stats.nearest_rank([5.0], 95) == 5.0
    assert stats.nearest_rank([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], 95) == 11
    assert _reader("p95_ms").read(harness.Reading()) is None


def test_spread_is_iqr_over_median():
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx(
        (4.5 - 1.5) / 3)


def test_stage_readers():
    st = {"pack": {"ms": 30.0, "calls": 3}, "build": {"ms": 10.0, "calls": 3},
          "encode": {"ms": 5.0, "calls": 3}, "fetch": {"ms": 99, "calls": 3}}
    r = harness.Reading(stages=st, alignments=1000)
    assert _reader("host.pack_us_per_pair").read(r) == pytest.approx(30.0)
    assert _reader("host.build_us_per_pair").read(r) == pytest.approx(15.0)
    none = harness.Reading(stages={}, alignments=10)
    assert _reader("host.pack_us_per_pair").read(none) is None
    assert _reader("host.build_us_per_pair").read(none) is None


def _ev(name, a, b, kind):
    return tracing.Event(name, a, b, kind)


def test_union_gaps_and_idle_share():
    events = [
        _ev("bench.window", 0.0, 10.0, "host"),
        _ev("bench.call", 0.0, 4.0, "host"),
        _ev("stage.pack", 0.5, 1.5, "host"),
        _ev("bench.call", 5.5, 10.0, "host"),
        _ev("k1", 1.0, 3.0, "kernel"),
        _ev("k2", 2.0, 4.0, "kernel"),          # overlaps k1
        _ev("Memcpy HtoD", 6.0, 7.0, "memcpy"),
        _ev("k1", 9.5, 11.0, "kernel"),         # past the window
        _ev("k0", -1.0, -0.5, "kernel"),        # before it
    ]
    d = tracing.reduce(events)
    assert d["window_s"] == 10.0
    assert d["busy_s"] == pytest.approx(3.0 + 1.0 + 0.5)
    assert d["kernel_s"] == pytest.approx(2.0 + 2.0 + 0.5)
    assert d["device_ops"][0] == ["k1", pytest.approx(2.5)]
    gaps = dict(map(tuple, d["idle_gaps"]))
    # idle: [0,1] in stage.pack, [4,6] between calls (midpoint 5),
    # [7,9.5] in the second call
    assert gaps["stage.pack"] == pytest.approx(1.0)
    assert gaps["host"] == pytest.approx(2.0)
    assert gaps["bench.call"] == pytest.approx(2.5)
    r = harness.Reading(device=d, least_s=0.45)
    assert _reader("device.idle_share").read(r) == pytest.approx(55.0)
    assert _reader("device.idle_share.single").read(r) == pytest.approx(55.0)
    assert _reader("kernels_roofline").read(r) == pytest.approx(10.0)


def test_no_device_events_reads_nothing():
    assert tracing.reduce([_ev("bench.window", 0, 1, "host")]) is None
    r = harness.Reading(device=None)
    for m in ("device.idle_share", "kernels_roofline"):
        assert _reader(m).read(r) is None


def test_kind_of():
    assert tracing.kind_of("Memcpy DtoH (Device -> Pinned)") == "memcpy"
    assert tracing.kind_of("Memset (Device)") == "memset"
    assert tracing.kind_of("void segment_kernel<8, 64, 4, false>") == "kernel"


def test_roofline_counts():
    search = Request(refs=[b"A" * 10, b"A" * 30], rlens=np.array([10, 30]),
                     qlens=100, query=b"A" * 100)
    ops, nbytes = roofline.count(search, {"mode": "sw"}, False)
    assert ops == 6 * 100 * 40
    assert nbytes == 40 + 100 + 12 * 2
    pairs = Request(refs=[b"A" * 10, b"A" * 30], rlens=np.array([10, 30]),
                    qlens=np.array([20, 5]), queries=[b"A" * 20, b"A" * 5])
    ops, nbytes = roofline.count(pairs, {"mode": "nw"}, True)
    steps = 20 + 30
    assert ops == 5 * (200 + 150) + steps
    assert nbytes == 40 + 25 + 24 + steps
    assert roofline.least_seconds(ops, nbytes) == pytest.approx(
        max(ops / (2 * 64 * 132 * 1.98e9), nbytes / 3.35e12))
    assert math.isclose(roofline.INT_OPS_PER_S, 16.727e12, rel_tol=1e-3)


def test_sample_holds_the_longest_and_its_planted_share():
    kept = [harness.Kept(b"", b"", (i,), planted=i % 4 == 0, cells=i)
            for i in range(400)]
    got = harness.sample(np.random.default_rng(1), kept,
                         {"size": 40, "planted_share": 0.5})
    assert len(got) == 40 and kept[-1] in got
    assert sum(k.planted for k in got) == 20 + (kept[-1].planted)
    assert harness.sample(np.random.default_rng(1), kept[:30],
                          {"size": 40}) == kept[:30]
    few = [harness.Kept(b"", b"", (i,), planted=i < 35, cells=i)
           for i in range(50)]
    assert len(harness.sample(np.random.default_rng(2), few,
                              {"size": 40, "planted_share": 0.25})) == 40
