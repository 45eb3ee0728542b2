"""One pair a call, as a Python loop over pairs calls parasail:
``Aligner.align(q, r)`` on a ``use_trace()`` aligner, then
``Alignment.get_cigar(q, r)`` (the plane fetched, the walk on the
host)."""

from __future__ import annotations

from .system import builder, matrix

CIGAR = True


class AlignTrace:
    def __init__(self, config, traffic, device):
        scoring = config["scoring"]
        self.aligner = builder(scoring, device).matrix(
            matrix(scoring["matrix"])).use_trace().build()

    def call(self, req):
        out = []
        for q, r in zip(req.queries, req.refs):
            a = self.aligner.align(q, r)
            out.append((a.get_score(), a.get_end_query(), a.get_end_ref(),
                        a.get_cigar(q, r)))
        return out

    def answers(self, req, result, positions):
        return [result[p] for p in positions]


def build(config, traffic, device):
    return AlignTrace(config, traffic, device)
