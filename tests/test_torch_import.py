"""The port stands apart from JAX, and its copied modules stay copies.

The import check runs in a subprocess: this test session has imported
jax already (tests/conftest.py).
"""

import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import parasail_rs_tpu_torch as pt
from parasail_rs_tpu.golden import model as golden
from parasail_rs_tpu_torch import convert
from parasail_rs_tpu_torch.engine import dispatch
from parasail_rs_tpu_torch.ops import _build, scan_kernel

m = pt.Matrix.from_name("blosum62")
a = (pt.Aligner.new().matrix(m).gap_open(11).gap_extend(1).local()
     .device("cpu").build())
qs, rs = [b"HEAGAWGHEE", b"MKVLAT"], [b"PAWHEAE", b"MKVINLAT"]
got = [r.get_score() for r in a.align_batch(qs, rs)]
want = [golden.align_seqs(q, r, m, 11, 1, "sw").score for q, r in zip(qs, rs)]
assert got == want, (got, want)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "triton")))
print("BAD", bad)
"""


def test_port_runs_without_jax_or_triton():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def _without_imports(path: str) -> list[str]:
    """Source lines of a module with every import statement set aside."""
    with open(path) as f:
        src = f.read()
    drop = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            drop.update(range(node.lineno, node.end_lineno + 1))
    return [ln for n, ln in enumerate(src.splitlines(), 1) if n not in drop]


@pytest.mark.parametrize("rel", ["ops/specs.py", "engine/profile.py",
                                 "engine/result.py"])
def test_copied_module_matches_original(rel):
    got = _without_imports(os.path.join(ROOT, "parasail_rs_tpu_torch", rel))
    want = _without_imports(os.path.join(ROOT, "parasail_rs_tpu", rel))
    assert got == want


@pytest.mark.parametrize("rel", ["ops/specs.py", "engine/profile.py",
                                 "engine/result.py"])
def test_copied_module_imports_are_absolute(rel):
    # the copies reach the reference only through modules that load no jax
    with open(os.path.join(ROOT, "parasail_rs_tpu_torch", rel)) as f:
        tree = ast.parse(f.read())
    allowed = ("parasail_rs_tpu.constants", "parasail_rs_tpu.errors",
               "parasail_rs_tpu.matrices", "parasail_rs_tpu.golden",
               "parasail_rs_tpu.native")
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("parasail_rs_tpu"):
            assert node.level == 0 and node.module.startswith(allowed), \
                ast.unparse(node)
        if isinstance(node, ast.ImportFrom):
            assert node.level == 0, ast.unparse(node)
