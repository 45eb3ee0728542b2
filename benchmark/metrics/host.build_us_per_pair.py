"""The program's ``build`` (result objects) and ``encode`` (CIGAR
strings) stages, host self-time over the window's alignments, in us a
pair."""


def read(run):
    if not run.stages or not run.alignments:
        return None
    ms = sum(run.stages[k]["ms"] for k in ("build", "encode")
             if k in run.stages)
    if not any(k in run.stages for k in ("build", "encode")):
        return None
    return ms * 1e3 / run.alignments
