"""The share of the traced window in which no kernel, copy or set ran
on the card, in percent."""


def read(run):
    if not run.device:
        return None
    return 100.0 * (1.0 - run.device["busy_s"] / run.device["window_s"])
