"""The system under test, built from a configuration's ``scoring``."""

from __future__ import annotations

from ..reference.sweep import bandwidth, free_ends


def matrix(spec):
    import parasail_rs_tpu_torch as pt

    if spec == "blosum62":
        return pt.Matrix.from_name("blosum62")
    return pt.Matrix.create(spec["alphabet"], spec["match"], spec["mismatch"])


def builder(scoring: dict, device):
    """An ``AlignerBuilder`` with the configuration's mode (and ``sg``'s
    free ends), band, gaps, width and device; the caller adds the matrix
    or the profile."""
    from parasail_rs_tpu_torch.engine.aligner import Aligner

    b = Aligner.new()
    mode = scoring["mode"]
    if mode == "sw":
        b.local()
    elif mode == "nw":
        b.global_()
    elif mode == "sg":
        b.semi_global()
        qb, qe, db, de = free_ends(scoring)
        if not all((qb, qe, db, de)):     # all four: plain sg, no lists
            b.allow_query_gaps([n for f, n in ((qb, "prefix"),
                                               (qe, "suffix")) if f])
            b.allow_ref_gaps([n for f, n in ((db, "prefix"),
                                             (de, "suffix")) if f])
    else:
        raise ValueError(f"mode {mode!r}")
    bw = bandwidth(scoring)
    if bw is not None:
        b.bandwidth(bw)
    return (b.gap_open(scoring["gap_open"])
            .gap_extend(scoring["gap_extend"])
            .solution_width(scoring["width"]).device(device))
