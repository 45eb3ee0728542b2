"""No module a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``parasail_rs_tpu`` (the port, ``parasail_rs_tpu_torch``,
is compared by its whole top-level name); the reference loads nothing of
the port."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmark import harness

SCRIPT = r"""
import json, sys
sys.path.insert(0, {root!r})
from benchmark.tests.conftest import SMALL
from benchmark import harness, roofline, tracing, stats
from benchmark.traffic import pairs, search, sequences
from benchmark.reference import sweep
for cell in SMALL:
    harness.run(cell, 5, 0.2, False, device="cpu", overrides=SMALL[cell])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF_ONLY = r"""
import json, sys
sys.path.insert(0, {root!r})
from benchmark.reference import sweep
sweep.align([(b"ACGT", b"AGT")], {{"mode": "nw", "matrix": {{"alphabet":
    "ACGT", "match": 0, "mismatch": -4}}, "gap_open": 8, "gap_extend": 2}},
    cigar=True)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c",
                        script.format(root=harness.ROOT)],
                       capture_output=True, text=True, env=env,
                       cwd=harness.ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_not_the_jax_package():
    tops = _modules(SCRIPT)
    assert "parasail_rs_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "parasail_rs_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    tops = _modules(REF_ONLY)
    assert "torch" in tops
    assert not tops & {"parasail_rs_tpu_torch", "parasail_rs_tpu", "jax"}


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["parasail_rs_tpu_torch", "parasail_rs_tpu_torch.engine.aligner",
         "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(
        ["parasail_rs_tpu.engine", "jaxlib.xla_client", "jax", "flax.core",
         "torch"]) == ["flax", "jax", "jaxlib", "parasail_rs_tpu"]


def test_run_without_a_card_fails_and_prints_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: there this is a normal run")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "wfa.1k_e5.single", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=harness.ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr
