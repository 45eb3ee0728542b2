"""The cyclic collector's runs that start inside a public call (the
program's ``gc_collections`` counter) over the window's calls."""


def read(run):
    st = run.stages or {}
    if "count.gc_collections" not in st or not run.calls:
        return None
    return st["count.gc_collections"]["n"] / run.calls
