"""The port stands apart from JAX and from the JAX package, and its
copied modules stay copies.

The import check runs in a subprocess: this test session has imported
jax and ``parasail_rs_tpu`` already (tests/conftest.py, the other test
files).
"""

import ast
import glob
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import parasail_rs_tpu_torch as pt
from parasail_rs_tpu_torch import convert
from parasail_rs_tpu_torch.golden import model as golden
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
             if k in ("jax", "parasail_rs_tpu")
             or k.startswith(("jax.", "jaxlib", "triton", "parasail_rs_tpu.")))
print("BAD", bad)
"""


def test_port_runs_without_jax_or_triton():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


PORT = os.path.join(ROOT, "parasail_rs_tpu_torch")

# every module the port copied from the reference, verbatim apart from its
# import lines (and, in the two native loaders, where the build is cached)
COPIED = ["constants.py", "errors.py",
          *(f"matrices/{m}.py" for m in ("__init__", "data", "matrix",
                                         "ncbi")),
          "golden/__init__.py", "golden/model.py",
          *(f"native/{m}.py" for m in ("__init__", "packer", "walker")),
          "batch/__init__.py", "batch/scheduler.py",
          *(f"utils/{m}.py" for m in ("__init__", "stages", "gcpause",
                                      "shapes")),
          "ops/specs.py", "engine/profile.py", "engine/result.py"]


def _without_imports(path: str) -> list[str]:
    """Source lines of a module with every import statement set aside,
    and the native loaders' ``_lib_dir`` (the build's cache directory, the
    one thing the port's copies set for themselves)."""
    with open(path) as f:
        src = f.read()
    drop = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)) or (
                isinstance(node, ast.FunctionDef)
                and node.name == "_lib_dir"
                and os.path.basename(os.path.dirname(path)) == "native"):
            drop.update(range(node.lineno, node.end_lineno + 1))
    return [ln for n, ln in enumerate(src.splitlines(), 1) if n not in drop]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_original(rel):
    got = _without_imports(os.path.join(PORT, rel))
    want = _without_imports(os.path.join(ROOT, "parasail_rs_tpu", rel))
    assert got == want


@pytest.mark.parametrize("rel", ["native/ptpack.cc", "native/ptwalk.cc"])
def test_copied_source_matches_original(rel):
    with open(os.path.join(PORT, rel), "rb") as f:
        got = f.read()
    with open(os.path.join(ROOT, "parasail_rs_tpu", rel), "rb") as f:
        assert got == f.read()


def test_native_builds_cache_under_the_port():
    from parasail_rs_tpu_torch.native import packer, walker

    for mod in (packer, walker):
        assert mod._lib_dir() == os.path.join(PORT, "_build")
        assert os.path.dirname(mod._SRC) == os.path.join(PORT, "native")


PORT_FILES = sorted(
    os.path.relpath(p, PORT)
    for p in glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True))


@pytest.mark.parametrize("rel", PORT_FILES + ["../chip_smoke.py"])
def test_copied_module_imports_are_absolute(rel):
    # the name is older than the rule: no file of the port, copied or
    # not, and not chip_smoke.py, imports jax or anything of
    # parasail_rs_tpu, not even a module there that loads no jax; the
    # port reaches its own copies by relative imports
    with open(os.path.join(PORT, rel)) as f:
        tree = ast.parse(f.read())
    banned = ("parasail_rs_tpu", "jax", "jaxlib")
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in banned, ast.unparse(node)
