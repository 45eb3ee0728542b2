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

# the dist layer: virtual shards of one CPU device, and a mesh of one rank
import numpy as np
from parasail_rs_tpu_torch import dist, prelude
from parasail_rs_tpu_torch.dist import multihost, sharded
from parasail_rs_tpu_torch.engine.profile import profile_rows

B, Qp, Rp = 2, 16, 16
prof = np.zeros((B, Qp, m.size), np.int32)
qidx = np.full((B, Qp), -1, np.int32)
ridx = np.zeros((B, Rp), np.int32)
for b, (q, r) in enumerate(zip(qs, rs)):
    qi, ri = m.encode(q), m.encode(r)
    prof[b, :len(qi)], qidx[b, :len(qi)] = profile_rows(m, qi), qi
    ridx[b, :len(ri)] = ri
lens = (np.array([len(q) for q in qs], np.int32),
        np.array([len(r) for r in rs], np.int32))
kw = dict(open_=11, ext=1, mode="sw", free=(True,) * 4, device="cpu")
mesh = dist.make_device_mesh(2)
out = dist.seqpar_align_scan(prof, ridx, *lens, qidx, mesh=mesh, q_chunk=8,
                             outputs="stats", **kw)
assert out["score"].tolist() == want, out["score"]
out = dist.seqpar_align(prof.transpose(1, 2, 0), ridx.T, *lens, mesh=mesh,
                        q_chunk=4, **kw)
assert out["score"].tolist() == want, out["score"]
res = sharded.gather_scores(dist.sharded_align(
    mesh, prof, qidx, ridx, *lens, outputs="score", **kw))
assert res["score"].tolist() == want and prelude.Aligner is pt.Aligner

# the entry points and the fuzzer
from parasail_rs_tpu_torch import entry
fn, args = entry.entry("cpu")
assert fn(*args)["score"].shape == (32,)
sys.path.insert(0, "tools")
import fuzz_torch
assert fuzz_torch.run("cpu", draws=2, seed=1)["draws"] == 2
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
# import lines and the definitions it owns (OWN)
COPIED = ["constants.py", "errors.py",
          *(f"matrices/{m}.py" for m in ("__init__", "data", "matrix",
                                         "ncbi")),
          "golden/__init__.py", "golden/model.py",
          *(f"native/{m}.py" for m in ("__init__", "packer", "walker")),
          "batch/__init__.py", "batch/scheduler.py",
          *(f"utils/{m}.py" for m in ("__init__", "stages", "gcpause",
                                      "shapes")),
          "ops/specs.py", "engine/profile.py", "engine/result.py"]


# what the port's two native loaders set for themselves: where the build
# is cached (``_lib_dir``), and a ``_load`` that runs g++ with no lock held
# and starts over after a fork (``_reset_after_fork`` and its registration)
NATIVE_OWN = ("_lib_dir", "_load", "_reset_after_fork")

# the definitions the port owns in a copied module, by module: in the
# native loaders NATIVE_OWN; in the stage clocks the spans on the trace and
# the counters (and the module's docstring, "__doc__"); in the results the
# host walk's span (``Alignment._walk``) and the batch's results, one
# two-slot ``Alignment`` a pair over a shared ``BatchRecord``
OWN = {"native/packer.py": NATIVE_OWN, "native/walker.py": NATIVE_OWN,
       "utils/stages.py": ("__doc__", "count", "snapshot", "_Off", "_OFF",
                           "_Span", "stage"),
       "engine/result.py": ("_walk", "Alignment", "PairFields",
                            "BatchRecord")}


def _is_native_loader(path: str) -> bool:
    return (os.path.basename(os.path.dirname(path)) == "native"
            and os.path.basename(path) in ("packer.py", "walker.py"))


def _is_fork_hook(node) -> bool:
    return (isinstance(node, ast.Expr)
            and ast.unparse(node.value).startswith("os.register_at_fork("))


def _own_name(node) -> str | None:
    """The name a definition or a module-level assignment binds."""
    if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
        return node.name
    if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
            isinstance(node.targets[0], ast.Name):
        return node.targets[0].id
    return None


def _without_imports(path: str, own=()) -> list[str]:
    """Source lines of a module with every import statement set aside,
    and the definitions named in ``own`` (``"__doc__"``: the module's
    docstring)."""
    with open(path) as f:
        src = f.read()
    tree = ast.parse(src)
    native = _is_native_loader(path)
    drop = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)) or (
                _own_name(node) in own):
            first = min([node.lineno] + [d.lineno for d in getattr(
                node, "decorator_list", [])])
            drop.update(range(first, node.end_lineno + 1))
    if "__doc__" in own and ast.get_docstring(tree) is not None:
        drop.update(range(tree.body[0].lineno, tree.body[0].end_lineno + 1))
    if native:
        for node in tree.body:
            if _is_fork_hook(node):
                drop.update(range(node.lineno, node.end_lineno + 1))
    lines = [ln for n, ln in enumerate(src.splitlines(), 1) if n not in drop]
    # blank lines around a dropped definition are not a difference
    return [ln for ln in lines if ln.strip()] if own else lines


def _load_declarations(path: str) -> list[str]:
    """The C signatures a native loader's ``_load`` declares."""
    with open(path) as f:
        tree = ast.parse(f.read())
    load = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "_load")
    return [ast.unparse(n) for n in ast.walk(load)
            if isinstance(n, ast.Assign)
            and ast.unparse(n.targets[0]).startswith("lib.")]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_original(rel):
    own = OWN.get(rel, ())
    got = _without_imports(os.path.join(PORT, rel), own)
    want = _without_imports(os.path.join(ROOT, "parasail_rs_tpu", rel), own)
    assert got == want
    if _is_native_loader(os.path.join(PORT, rel)):
        # the loaders differ in how _load locks, not in what it declares
        decl = _load_declarations(os.path.join(PORT, rel))
        assert decl and decl == _load_declarations(
            os.path.join(ROOT, "parasail_rs_tpu", rel))


@pytest.mark.parametrize("mod", ["packer", "walker"])
def test_native_loader_builds_outside_its_lock(mod):
    # the compiler runs with no lock held, and a forked child starts over
    import importlib

    m = importlib.import_module(f"parasail_rs_tpu_torch.native.{mod}")
    with open(m.__file__) as f:
        tree = ast.parse(f.read())
    load = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "_load")
    for node in ast.walk(load):
        if isinstance(node, ast.With):
            assert "_build" not in ast.unparse(node)
    assert any(_is_fork_hook(n) for n in tree.body)
    held = m._lock
    held.acquire()
    try:
        m._reset_after_fork()
        assert m._lock is not held and not m._lock.locked()
        assert m._lib is None and m._tried is False
        assert m.available() in (True, False)      # loads again, no deadlock
    finally:
        held.release()


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


# the port's own sources; `_build/` holds what was built, not the package
PORT_FILES = sorted(
    rel for rel in (os.path.relpath(p, PORT) for p in glob.glob(
        os.path.join(PORT, "**", "*.py"), recursive=True))
    if not rel.startswith("_build" + os.sep))


@pytest.mark.parametrize("rel", PORT_FILES + ["../chip_smoke.py",
                                 "../tools/fuzz_torch.py"])
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
