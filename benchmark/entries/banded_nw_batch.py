"""A batch of pairs through the band, score only:
``Aligner.banded_nw_batch(queries, refs)`` on an aligner built with the
configuration's ``bandwidth`` (global; one launch of K1e's banded score
form over the whole batch, scores fetched once)."""

from __future__ import annotations

from .system import builder, matrix

CIGAR = False


class BandedNwBatch:
    def __init__(self, config, traffic, device):
        scoring = config["scoring"]
        if scoring.get("bandwidth") is None:
            raise ValueError("banded_nw_batch needs the scoring's bandwidth")
        self.aligner = builder(scoring, device).matrix(
            matrix(scoring["matrix"])).build()

    def call(self, req):
        return self.aligner.banded_nw_batch(req.queries, req.refs)

    def answers(self, req, result, positions):
        return [(result[p].get_score(), result[p].get_end_query(),
                 result[p].get_end_ref(), None) for p in positions]


def build(config, traffic, device):
    return BandedNwBatch(config, traffic, device)
