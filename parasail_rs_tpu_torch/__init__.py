"""parasail_rs_tpu_torch: the PyTorch + CUDA port of ``parasail_rs_tpu``.

Same public surface and the same outputs, bit for bit, as the JAX
package, which stays beside it as the reference.  On a CUDA device the
score-only path runs a hand-written kernel (``csrc/scan_score.cu``, built
with ``nvcc`` on first use); on the CPU it runs the kernel's plain
PyTorch version.  Only the score-only output class is ported so far
(see ROADMAP.md).

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
