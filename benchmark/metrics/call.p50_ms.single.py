"""Median time of a call (``Aligner.align`` + ``Alignment.get_cigar``)
in the traced window, in ms: a steadier companion of ``p95_ms``."""

from benchmark.stats import nearest_rank


def read(run):
    if not run.latencies_s:
        return None
    return nearest_rank(run.latencies_s, 50) * 1e3
