"""Process start to the first timed call: imports, inputs, the system's
build (and, in a fresh checkout, its compilation) and warm-up."""


def read(run):
    return run.setup_s
