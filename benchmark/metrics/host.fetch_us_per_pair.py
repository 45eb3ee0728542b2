"""The host's own work in the fetch of results: the program's
``fetch.start`` (a result block's stack, pinned buffer and copy's
enqueue) and ``fetch.copy`` (views, unpacking, the planes' copies)
stages, over the window's alignments, in us a pair.  The host's wait on
the card (``fetch.wait``) is left out."""

STAGES = ("fetch.start", "fetch.copy")


def read(run):
    st = run.stages or {}
    if not any(k in st for k in STAGES) or not run.alignments:
        return None
    return sum(st[k]["ms"] for k in STAGES if k in st) * 1e3 / run.alignments
