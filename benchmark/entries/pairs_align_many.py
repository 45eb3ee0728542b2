"""A batch of pairs through the length bins, score only:
``Aligner.align_many(queries, refs)`` on a score aligner (bins, pack,
the route each bin plans, scalars fetched once every bin is launched;
no trace, no walk)."""

from __future__ import annotations

from .system import builder, matrix

CIGAR = False


class PairsAlignMany:
    def __init__(self, config, traffic, device):
        scoring = config["scoring"]
        self.aligner = builder(scoring, device).matrix(
            matrix(scoring["matrix"])).build()

    def call(self, req):
        return self.aligner.align_many(req.queries, req.refs)

    def answers(self, req, result, positions):
        return [(result[p].get_score(), result[p].get_end_query(),
                 result[p].get_end_ref(), None) for p in positions]


def build(config, traffic, device):
    return PairsAlignMany(config, traffic, device)
