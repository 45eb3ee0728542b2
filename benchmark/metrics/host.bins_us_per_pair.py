"""The program's ``bins`` stage (``Aligner.align_many`` /
``align_cigars``: the lengths, the shape bins, each bin's gather of its
sequences and the results put back in input order), host time over the
window's alignments, in us a pair."""


def read(run):
    if not run.stages or "bins" not in run.stages or not run.alignments:
        return None
    return run.stages["bins"]["ms"] * 1e3 / run.alignments
