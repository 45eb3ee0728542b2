"""The program's own CUDA kernel launches (its ``launches`` counter) over
the window's calls."""


def read(run):
    st = run.stages or {}
    if "count.launches" not in st or not run.calls:
        return None
    return st["count.launches"]["n"] / run.calls
