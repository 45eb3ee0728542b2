"""Database search: each call is one query against the next chunk of a
synthetic database, the queries in a seeded order, the chunk advancing
and wrapping.

The configuration gives the database (``database.entries``, the
``sequences`` model), the queries (``queries.lengths``) and the planted
homologs (``homologs``: a share of entries replaced by a mutated copy of
a query); the mix gives ``refs_per_call``.
"""

from __future__ import annotations

import numpy as np

from .request import Request
from .sequences import (
    Letters,
    apply_ops,
    lengths,
    offsets_of,
    ops_by_rate,
    to_bytes,
)


def homolog_rates(rng, n: int, spec: dict):
    """Per-entry substitution, insertion and deletion rates: identity
    uniform in ``spec["identity"]``, one indel for every
    ``1 / indels_per_substitution`` substitutions, half of them
    insertions."""
    lo, hi = spec["identity"]
    p_sub = (1.0 - rng.uniform(lo, hi, n)).astype(np.float32)
    p_indel = p_sub * np.float32(spec["indels_per_substitution"])
    return p_sub, p_indel / 2, p_indel / 2


class Search:
    def __init__(self, config: dict, mix: dict, seed: int):
        rng = np.random.default_rng([seed, 11])
        letters = Letters.of(config["sequences"]["composition"])
        qlens = np.array(config["queries"]["lengths"], np.int64)
        qoff = offsets_of(qlens)
        qidx = letters.draw(rng, int(qoff[-1]))
        self.queries = to_bytes(letters, qidx, qoff)

        n = int(config["database"]["entries"])
        lens = lengths(config["sequences"]["length"], n, rng)
        off = offsets_of(lens)
        db = to_bytes(letters, letters.draw(rng, int(off[-1])), off)

        hom = config["homologs"]
        planted = rng.choice(n, int(round(n * hom["share"])), replace=False)
        of_query = rng.integers(0, len(qlens), len(planted))
        src_lens = qlens[of_query]
        src_off = offsets_of(src_lens)
        src = np.concatenate([qidx[qoff[k]:qoff[k + 1]] for k in of_query])
        op = ops_by_rate(rng, src_lens, *homolog_rates(rng, len(planted), hom))
        mut, mut_off = apply_ops(rng, letters, src, src_off, op)
        for e, s in zip(planted.tolist(), to_bytes(letters, mut, mut_off)):
            db[e] = s
            lens[e] = len(s)
        self.homolog_of = np.full(n, -1, np.int16)
        self.homolog_of[planted] = of_query
        self.db, self.lens = db, lens
        self.per_call = int(mix["refs_per_call"])
        cap = mix.get("max_query")
        self.eligible = [qi for qi, q in enumerate(self.queries)
                         if cap is None or len(q) <= int(cap)]
        if not self.eligible:
            raise ValueError(f"no query of at most {cap} residues")
        self._order_rng = np.random.default_rng([seed, 12])
        self._order: list[int] = []

    def _query_of(self, c: int) -> int:
        while len(self._order) <= c:
            self._order.extend(
                self.eligible[i] for i in
                self._order_rng.permutation(len(self.eligible)).tolist())
        return self._order[c]

    def request(self, c: int) -> Request:
        n, k = len(self.db), self.per_call
        start = (c * k) % n
        idx = np.arange(start, start + k) % n
        if start + k <= n:
            refs = self.db[start:start + k]
        else:
            refs = self.db[start:] + self.db[:start + k - n]
        qi = self._query_of(c)
        return Request(
            refs=refs, rlens=self.lens[idx], qlens=len(self.queries[qi]),
            query=self.queries[qi], tag=qi,
            planted=np.nonzero(self.homolog_of[idx] == qi)[0])

    def warmup(self) -> list[Request]:
        """One call of each query that the calls take, on the first
        chunk."""
        out = []
        k = self.per_call
        for qi in self.eligible:
            q = self.queries[qi]
            out.append(Request(refs=self.db[:k], rlens=self.lens[:k],
                               qlens=len(q), query=q, tag=qi))
        return out


def make(config: dict, mix: dict, seed: int) -> Search:
    return Search(config, mix, seed)
