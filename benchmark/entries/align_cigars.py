"""A batch of pairs with their CIGARs:
``Aligner.align_cigars(queries, refs)`` (trace on the device, the walk
on the device, opcodes fetched)."""

from __future__ import annotations

from .system import builder, matrix

CIGAR = True


class AlignCigars:
    def __init__(self, config, traffic, device):
        scoring = config["scoring"]
        self.aligner = builder(scoring, device).matrix(
            matrix(scoring["matrix"])).build()

    def call(self, req):
        return self.aligner.align_cigars(req.queries, req.refs)

    def answers(self, req, result, positions):
        alns, cigars = result
        return [(alns[p].get_score(), alns[p].get_end_query(),
                 alns[p].get_end_ref(), cigars[p]) for p in positions]


def build(config, traffic, device):
    return AlignCigars(config, traffic, device)
