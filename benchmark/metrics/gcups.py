"""Real DP cells (len(q) * len(r), every alignment completed in the
window) over the window's seconds, in billions."""


def read(run):
    if run.window_s <= 0 or not run.cells:
        return None
    return run.cells / run.window_s / 1e9
