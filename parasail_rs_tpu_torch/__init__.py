"""parasail_rs_tpu_torch: the PyTorch + CUDA port of ``parasail_rs_tpu``.

Same public surface and the same outputs, bit for bit, as the JAX
package, which stays beside it as the reference.  On a CUDA device ``align`` /
``align_batch`` and ``align_cigars`` run hand-written kernels
(``csrc/*.cu``, built with ``nvcc`` on first use); on the CPU they run
the kernels' plain PyTorch versions.  Every output class (score, stats,
table, rowcol, trace) is ported; ``align_many``, ``banded_nw*`` and
``ssw*`` are not yet (see ROADMAP.md).

The package imports ``torch`` and never ``jax``.
"""

from parasail_rs_tpu.matrices import Matrix

__all__ = [
    "Aligner",
    "AlignerBuilder",
    "Alignment",
    "Matrix",
    "Profile",
    "ProfileBuilder",
]


def __getattr__(name):
    # lazy: `import parasail_rs_tpu_torch` stays light until the engine
    # is used
    if name in ("Aligner", "AlignerBuilder"):
        from .engine.aligner import Aligner, AlignerBuilder

        return {"Aligner": Aligner, "AlignerBuilder": AlignerBuilder}[name]
    if name in ("Alignment", "Table", "TracebackTable", "Traceback"):
        from .engine import result as _r

        return getattr(_r, name)
    if name in ("Profile", "ProfileBuilder"):
        from .engine import profile as _p

        return getattr(_p, name)
    raise AttributeError(name)
