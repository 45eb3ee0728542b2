"""Pairs: a pool of (sequence, partner) pairs built in set-up, cycled in
calls of ``per_call`` pairs.

The mix gives ``pool``, ``per_call``, ``length`` (a number of residues,
or ``"sequences"`` for the configuration's length model) and
``partner``: ``"errors"`` (the configuration's ``errors``: exactly
``rate * length`` edits a pair, each a substitution, an insertion or a
deletion with equal chance) or ``"homolog"`` (the configuration's
``homologs`` model, as :mod:`.search` plants them).
"""

from __future__ import annotations

import numpy as np

from .request import Request
from .search import homolog_rates
from .sequences import (
    Letters,
    apply_ops,
    lengths,
    offsets_of,
    ops_by_count,
    ops_by_rate,
    to_bytes,
)


class Pairs:
    def __init__(self, config: dict, mix: dict, seed: int):
        rng = np.random.default_rng([seed, 21])
        seqs = config["sequences"]
        letters = Letters.of(seqs["composition"])
        n, self.per_call = int(mix["pool"]), int(mix["per_call"])
        if n % self.per_call:
            raise ValueError("pool must be a whole number of calls")
        spec = (seqs["length"] if mix["length"] == "sequences"
                else {"distribution": "fixed", "length": mix["length"]})
        qlens = lengths(spec, n, rng)
        qoff = offsets_of(qlens)
        qidx = letters.draw(rng, int(qoff[-1]))
        if mix["partner"] == "errors":
            if spec["distribution"] != "fixed":
                raise ValueError("an exact error count needs a fixed length")
            L = int(spec["length"])
            errors = int(round(config["errors"]["rate"] * L))
            op = ops_by_count(rng, n, L, errors)
        elif mix["partner"] == "homolog":
            op = ops_by_rate(rng, qlens,
                             *homolog_rates(rng, n, config["homologs"]))
        else:
            raise ValueError(f"partner {mix['partner']!r}")
        ridx, roff = apply_ops(rng, letters, qidx, qoff, op)
        self.queries = to_bytes(letters, qidx, qoff)
        self.refs = to_bytes(letters, ridx, roff)
        self.qlens, self.rlens = qlens, np.diff(roff)

    def request(self, c: int) -> Request:
        k = self.per_call
        a = (c * k) % len(self.refs)
        return Request(refs=self.refs[a:a + k], rlens=self.rlens[a:a + k],
                       qlens=self.qlens[a:a + k],
                       queries=self.queries[a:a + k])

    def warmup(self) -> list[Request]:
        return [self.request(0)]


def make(config: dict, mix: dict, seed: int) -> Pairs:
    return Pairs(config, mix, seed)
