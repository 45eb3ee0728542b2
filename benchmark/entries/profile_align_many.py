"""One query's profile against a chunk of references:
``Aligner.align_many(None, refs)`` on an aligner built over
``Profile.new(query)``, one aligner a query, built in set-up."""

from __future__ import annotations

from .system import builder, matrix

CIGAR = False


class ProfileSearch:
    def __init__(self, config, traffic, device):
        from parasail_rs_tpu_torch.engine.profile import Profile

        scoring = config["scoring"]
        m = matrix(scoring["matrix"])
        self.aligners = [
            builder(scoring, device).profile(Profile.new(q, False, m)).build()
            for q in traffic.queries]

    def call(self, req):
        return self.aligners[req.tag].align_many(None, req.refs)

    def answers(self, req, result, positions):
        out = []
        for p in positions:
            a = result[p]
            out.append((a.get_score(), a.get_end_query(), a.get_end_ref(),
                        None))
        return out


def build(config, traffic, device):
    return ProfileSearch(config, traffic, device)
