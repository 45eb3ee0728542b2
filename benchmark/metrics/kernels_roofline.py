"""The least time for the window's alignments (``benchmark.roofline``)
over the summed device time of every kernel in the traced window, in
percent."""


def read(run):
    if not run.device or run.device["kernel_s"] <= 0:
        return None
    return 100.0 * run.least_s / run.device["kernel_s"]
