"""A deployment's cell is added with new files only: in a copy of the
benchmark, a banded cell (WFA's scoring with a band of 16) joins with
its configuration, its traffic and its small file, and an entry in
``BENCHMARK.json``'s lists, and the copy's manifest, check and
program-metrics tests pass with no file of the benchmark edited."""

from __future__ import annotations

import filecmp
import importlib.util
import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

CONFIG = "wfa_nw_x4_o6_e2_band16"
CELL = "wfa.1k_e5.band16"
MIX = "wfa_1k_x1024_band16"
NEW_FILES = {
    f"configs/{CONFIG}.json": None,            # the WFA scoring, banded
    f"traffic/{MIX}.json": {
        "generator": "pairs", "entry": "banded_nw_batch", "length": 1000,
        "partner": "errors", "pool": 20480, "per_call": 1024,
        "keep_random": 1, "sample": {"size": 64}},
    f"tests/small/{CELL}.json": {
        "traffic": {"length": 600, "pool": 8, "per_call": 4,
                    "sample": {"size": 4}},
        "control": "saturate8"},
}
TESTS = ["test_benchmark_manifest.py", "test_benchmark_check.py",
         "test_benchmark_program_metrics.py"]
TIME_LIMIT_S = 1200
# tests that have to have run the new cell, and passed, in the copy
CELL_TESTS = ["test_benchmark_manifest.py::test_every_cell_has_a_small_file",
              "test_benchmark_manifest.py::test_workloads",
              "test_benchmark_check.py::test_sound_run_is_correct",
              "test_benchmark_check.py::test_control_is_not_correct",
              "test_benchmark_check.py::test_gap_control_is_not_correct",
              "test_benchmark_check.py::test_answer_altered_where_produced",
              "test_benchmark_check.py::test_half_of_the_batch_left_out",
              "test_benchmark_check.py::test_traced_run_reads_its_layers",
              "test_benchmark_program_metrics.py::"
              "test_traced_batch_cell_reads_the_program"]


def _files(top):
    out = set()
    for dirpath, dirnames, files in os.walk(top):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".pytest_cache")]
        out.update(os.path.relpath(os.path.join(dirpath, f), top)
                   for f in files if not f.endswith(".pyc"))
    return out


def _write(path, data):
    with open(path, "w") as f:
        json.dump(data, f, indent=2)
        f.write("\n")


def test_a_banded_cell_needs_only_new_files(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    # the port is reached where the copy's harness looks for it
    os.symlink(os.path.join(harness.ROOT, "parasail_rs_tpu_torch"),
               tmp_path / "parasail_rs_tpu_torch")

    bench_dir = tmp_path / "benchmark"
    base = harness.load_json(harness.HERE, "configs", "wfa_nw_x4_o6_e2.json")
    config = dict(base, name=CONFIG,
                  scoring=dict(base["scoring"], bandwidth=16))
    for rel, data in NEW_FILES.items():
        _write(bench_dir / rel, config if data is None else data)

    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    wfa = next(c for c in bench["configs"] if c["name"] == base["name"])
    bench["configs"].append(dict(
        wfa, name=CONFIG, file=f"benchmark/configs/{CONFIG}.json",
        why="WFA's pair sets through a band of 16 on nw, score only"))
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": MIX, "chips": 1,
        "why": "closed loop, banded_nw_batch of 1,024 pairs of 1 kbp a "
               "call, band 16: K1e's ring"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("gcups", "kernels_roofline", "device.idle_share"):
            m["workloads"].append(CELL)
    _write(tmp_path / "BENCHMARK.json", bench)

    env = dict(os.environ, PYTHONPATH=str(tmp_path),
               PYTHONDONTWRITEBYTECODE="1")
    workers = []
    if importlib.util.find_spec("xdist"):     # four workers, two threads each
        workers = ["-n", "4"]
        env["OMP_NUM_THREADS"] = "2"
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", *workers,
         "-p", "no:cacheprovider", "--rootdir", str(tmp_path),
         "-W", "ignore::pytest.PytestWarning",
         *[f"benchmark/tests/{t}" for t in TESTS]],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=TIME_LIMIT_S)
    assert p.returncode == 0, p.stdout[-6000:] + p.stderr[-3000:]
    for t in CELL_TESTS:
        assert f"PASSED benchmark/tests/{t}[{CELL}]" in p.stdout, t

    # nothing of the benchmark edited: its files alike, the new ones added
    tree, copy = _files(harness.HERE), _files(bench_dir)
    assert copy - tree == set(NEW_FILES)
    assert tree <= copy
    _, differ, errors = filecmp.cmpfiles(harness.HERE, bench_dir,
                                         sorted(tree), shallow=False)
    assert not differ and not errors
