"""Pause the cyclic GC around large bulk host loops.

Batch paths allocate one ``Alignment`` (+ ``PairFields``) per pair.  At
64k pairs that is >100k gc-tracked allocations in a tight loop, which
trips the generation-0 threshold hundreds of times; the promoted
survivors then make every gen-1/2 pass rescan the whole result set.
Measured on a 65536-pair batch: result build 301ms -> 65ms and the C++
pack pass 86ms -> 8ms with collection deferred (the deferred pass runs
once afterwards instead of ~180 times mid-loop).

``gc_pause`` is reentrant and thread-safe (a counter under a lock), and
only kicks in for batches large enough to matter so small interactive
calls never touch global GC state.  Reference-counted collection is
unaffected; only the *cyclic* collector is deferred, so this changes
when garbage is found, never whether.
"""

import gc
import threading
from contextlib import contextmanager

_lock = threading.Lock()
_depth = 0
_reenable = False

#: below this many pairs the loop is too cheap for GC deferral to matter
MIN_PAIRS = 4096


@contextmanager
def gc_pause(n: int):
    """Defer cyclic GC while building ``n`` per-pair objects.

    No-op when ``n`` is small or GC is already disabled (including by an
    enclosing ``gc_pause``, which this nests under correctly).
    """
    global _depth, _reenable
    if n < MIN_PAIRS:
        yield
        return
    with _lock:
        if _depth == 0:
            _reenable = gc.isenabled()
            if _reenable:
                gc.disable()
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0 and _reenable:
                gc.enable()
