"""parasail_rs_tpu_torch: the PyTorch + CUDA port of ``parasail_rs_tpu``.

Same public surface and the same outputs, bit for bit, as the JAX
package, which stays beside it as the reference.  On a CUDA device every
public ``Aligner`` method (``align`` / ``align_batch`` / ``align_many``,
``cigars`` / ``align_cigars``, ``banded_nw*``, ``ssw*``; every output
class: score, stats, table, rowcol, trace) runs hand-written kernels
(``csrc/*.cu``, built with ``nvcc`` on first use), long pairs through the
resumable segment kernel; on the CPU they run the kernels' plain PyTorch
versions.  The ``dist`` layer (sequence-parallel long pairs over the
tile kernel, data parallelism over ``torch.distributed``) is
``parasail_rs_tpu_torch.dist``; the streaming executor is
``parasail_rs_tpu_torch.engine.StreamingAligner``, and
``utils.profiling`` names every batch for torch's profiler.

The package imports ``torch``, never ``jax``, and nothing of
``parasail_rs_tpu``: ``constants``, ``errors``, ``matrices``, ``golden``,
``native``, ``batch`` and ``utils`` here are its own copies of the
reference's modules (``utils.profiling`` is rewritten on torch's
profiler).
"""

from .constants import InstructionSet, SolutionWidth, TraceFlags
from .errors import ParasailError
from .matrices import Matrix
from . import errors

# the port's own version; the reference package keeps its own
__version__ = "0.6.0"

__all__ = [
    "Matrix",
    "TraceFlags",
    "SolutionWidth",
    "InstructionSet",
    "ParasailError",
    "errors",
    "__version__",
]


def __getattr__(name):
    # lazy: `import parasail_rs_tpu_torch` stays light until the engine
    # is used
    if name in ("Aligner", "AlignerBuilder"):
        from .engine.aligner import Aligner, AlignerBuilder

        return {"Aligner": Aligner, "AlignerBuilder": AlignerBuilder}[name]
    if name in ("Alignment", "Table", "TracebackTable", "Traceback",
                "SSWResult"):
        from .engine import result as _r

        return getattr(_r, name)
    if name in ("Profile", "ProfileBuilder"):
        from .engine import profile as _p

        return getattr(_p, name)
    raise AttributeError(name)
