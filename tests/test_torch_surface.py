"""The port's public surface against the reference's, name by name.

Walks ``parasail_rs_tpu.__all__``, its lazily resolved names,
``engine.__all__``, ``dist.__all__`` and ``prelude.__all__`` and asserts
each on the port.  No name is missing: ``EXPECTED_MISSING`` is empty, and
a name the reference adds without a counterpart on the port fails here.
"""

import ast
import importlib
import os

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "parasail_rs_tpu", "parasail_rs_tpu_torch"

# names of the reference that the port does not have yet
EXPECTED_MISSING: set = set()


def _module_all(rel):
    """``__all__`` of a reference module, read from its source: importing
    ``dist`` or ``engine`` of the reference would load jax for nothing."""
    with open(os.path.join(ROOT, REF, rel)) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                ast.unparse(node.targets[0]) == "__all__":
            return list(ast.literal_eval(node.value))
    raise AssertionError(f"no __all__ in {rel}")


def _lazy_names():
    """The names the reference's top level resolves in ``__getattr__``."""
    with open(os.path.join(ROOT, REF, "__init__.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "__getattr__")
    names = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            right = node.comparators[0]
            vals = right.elts if isinstance(right, ast.Tuple) else [right]
            names += [v.value for v in vals if isinstance(v, ast.Constant)]
    return names


SURFACE = (
    [("", n) for n in _module_all("__init__.py") + _lazy_names()] +
    [("engine", n) for n in _module_all("engine/__init__.py")] +
    [("dist", n) for n in _module_all("dist/__init__.py")] +
    [("prelude", n) for n in _module_all("prelude.py")])


def test_the_walk_finds_the_reference_surface():
    assert ("", "SSWResult") in SURFACE and ("", "__version__") in SURFACE
    assert ("dist", "seqpar_align_scan") in SURFACE
    assert ("prelude", "Aligner") in SURFACE
    assert EXPECTED_MISSING <= set(SURFACE)
    assert len(SURFACE) >= 45


@pytest.mark.parametrize("sub,name", SURFACE,
                         ids=[f"{s or 'top'}.{n}" for s, n in SURFACE])
def test_reference_name_resolves_on_the_port(sub, name):
    mod = importlib.import_module(f"{PORT}.{sub}" if sub else PORT)
    if (sub, name) in EXPECTED_MISSING:
        assert not hasattr(mod, name), \
            f"{name} is ported: take it out of EXPECTED_MISSING"
        assert name not in getattr(mod, "__all__", ())
        return
    assert getattr(mod, name) is not None
    if sub:
        assert name in mod.__all__


def test_port_exports_are_the_reference_exports():
    for sub in ("", "engine", "dist", "prelude"):
        mod = importlib.import_module(f"{PORT}.{sub}" if sub else PORT)
        want = {n for s, n in SURFACE if s == sub
                and (s, n) not in EXPECTED_MISSING}
        if not sub:
            want -= set(_lazy_names())
        assert set(mod.__all__) == want, sub or "top"


def test_names_are_the_ports_own():
    import parasail_rs_tpu_torch as pt
    from parasail_rs_tpu_torch import prelude
    from parasail_rs_tpu_torch.engine import result

    assert pt.SSWResult is result.SSWResult is prelude.SSWResult
    assert pt.ParasailError is pt.errors.ParasailError
    assert pt.TraceFlags.__module__ == "parasail_rs_tpu_torch.constants"
    assert isinstance(pt.__version__, str) and pt.__version__
    with pytest.raises(AttributeError):
        pt.StreamingAligner
