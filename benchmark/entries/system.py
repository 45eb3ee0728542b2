"""The system under test, built from a configuration's ``scoring``."""

from __future__ import annotations


def matrix(spec):
    import parasail_rs_tpu_torch as pt

    if spec == "blosum62":
        return pt.Matrix.from_name("blosum62")
    return pt.Matrix.create(spec["alphabet"], spec["match"], spec["mismatch"])


def builder(scoring: dict, device):
    """An ``AlignerBuilder`` with the configuration's mode, gaps, width
    and device; the caller adds the matrix or the profile."""
    from parasail_rs_tpu_torch.engine.aligner import Aligner

    b = Aligner.new()
    mode = scoring["mode"]
    if mode == "sw":
        b.local()
    elif mode == "nw":
        b.global_()
    else:
        raise ValueError(f"mode {mode!r}")
    return (b.gap_open(scoring["gap_open"])
            .gap_extend(scoring["gap_extend"])
            .solution_width(scoring["width"]).device(device))
