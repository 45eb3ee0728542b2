"""95th percentile by nearest rank of the time from a call to its result
in hand, over every call of the window, in ms."""

from benchmark.stats import nearest_rank


def read(run):
    if not run.latencies_s:
        return None
    return nearest_rank(run.latencies_s, 95) * 1e3
