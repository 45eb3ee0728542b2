"""The program's ``pack`` stage (``dispatch.pack_pairs``: sequences to
padded tensors and their upload), host self-time over the window's
alignments, in us a pair."""


def read(run):
    if not run.stages or "pack" not in run.stages or not run.alignments:
        return None
    return run.stages["pack"]["ms"] * 1e3 / run.alignments
