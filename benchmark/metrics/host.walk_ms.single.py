"""The program's ``walk.host`` stage (the host walker behind
``Alignment.get_cigar``) over the window's calls, in ms a call."""


def read(run):
    st = run.stages or {}
    if "walk.host" not in st or not run.calls:
        return None
    return st["walk.host"]["ms"] / run.calls
