"""Shared pieces of the benchmark's tests: every cell's small size and
control, read from ``small/<cell>.json``, and the card fixture of the
``cuda`` tests.

A small file holds the overrides merged into the cell's configuration
(``"config"``) and mix (``"traffic"``) so that the CPU's plain versions
run the cell in seconds, and the control its check is shown to fail
(``"control"``: ``saturate8`` where scores still pass 8 bits at that
size, ``gap`` where they cannot; the gap control fails at every length).
A cell added to ``BENCHMARK.json`` brings its small file, and every
parametrised test of the cells takes it up from there.
"""

from __future__ import annotations

import os

import pytest

from benchmark import harness

SMALL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "small")
BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
_FILES = {c: harness.load_json(SMALL_DIR, c + ".json") for c in CELLS
          if os.path.exists(os.path.join(SMALL_DIR, c + ".json"))}
SMALL = {c: {k: f[k] for k in ("config", "traffic") if k in f}
         for c, f in _FILES.items()}
CONTROL = {c: f["control"] for c, f in _FILES.items()}


@pytest.fixture
def cuda_device():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
