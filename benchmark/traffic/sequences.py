"""Sequence models the traffic generators share: residues drawn from a
composition, lengths from a distribution, and a partner made by
mutation.  Everything is vectorised over one flat array of letter
indices with segment offsets, so a pool of millions of residues takes
seconds.

Lengths come from a fixed stream (``LENGTH_SEED``) and only their order
from the run's seed, so every seed gets the same multiset of sizes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LENGTH_SEED = 20_110_000
LUT_BITS = 16


@dataclass
class Letters:
    """A composition: ``alphabet`` (ASCII) and a 2^16-entry table from a
    uniform draw to a letter index, each letter's share rounded to
    1/65,536."""

    alphabet: np.ndarray
    lut: np.ndarray

    @classmethod
    def of(cls, composition: dict) -> "Letters":
        letters = list(composition)
        p = np.array([composition[c] for c in letters], np.float64)
        edges = np.rint(np.cumsum(p / p.sum()) * (1 << LUT_BITS)).astype(int)
        lut = np.repeat(np.arange(len(letters), dtype=np.uint8),
                        np.diff(np.concatenate([[0], edges])))
        return cls(np.frombuffer("".join(letters).encode(), np.uint8), lut)

    @property
    def size(self) -> int:
        return len(self.alphabet)

    def draw(self, rng, n: int) -> np.ndarray:
        return self.lut[rng.integers(0, 1 << LUT_BITS, n, dtype=np.uint32)]

    def draw_other(self, rng, old: np.ndarray) -> np.ndarray:
        """A letter unlike each of ``old``: drawn from the composition,
        drawn again where equal, then shifted where still equal."""
        new = self.draw(rng, len(old))
        same = new == old
        new[same] = self.draw(rng, int(same.sum()))
        same = new == old
        shift = rng.integers(1, self.size, int(same.sum()))
        new[same] = ((old[same].astype(np.int64) + shift)
                     % self.size).astype(np.uint8)
        return new


def lengths(spec: dict, n: int, rng) -> np.ndarray:
    """``n`` lengths of a ``{"distribution": "lognormal", "mean",
    "sigma", "min", "max"}`` or ``{"distribution": "fixed", "length"}``
    spec: the fixed stream's multiset in the order of ``rng``."""
    if spec["distribution"] == "fixed":
        return np.full(n, int(spec["length"]), np.int64)
    if spec["distribution"] != "lognormal":
        raise ValueError(f"length distribution {spec['distribution']!r}")
    sigma = float(spec["sigma"])
    mu = np.log(float(spec["mean"])) - sigma * sigma / 2
    fixed = np.random.default_rng(LENGTH_SEED)
    out = np.rint(fixed.lognormal(mu, sigma, n)).astype(np.int64)
    np.clip(out, int(spec["min"]), int(spec["max"]), out=out)
    return rng.permutation(out)


def offsets_of(lens: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


# one edit at a position: keep, substitute, insert a letter before, delete
KEEP, SUB, INS, DEL = 0, 1, 2, 3


def ops_by_rate(rng, lens, p_sub, p_ins, p_del) -> np.ndarray:
    """An edit per position, each segment at its own rates."""
    seg = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
    u = rng.random(len(seg), dtype=np.float32)
    c1 = p_sub[seg]
    c2 = c1 + p_ins[seg]
    c3 = c2 + p_del[seg]
    op = np.full(len(seg), KEEP, np.uint8)
    op[u < c1] = SUB
    op[(u >= c1) & (u < c2)] = INS
    op[(u >= c2) & (u < c3)] = DEL
    return op


def ops_by_count(rng, n: int, length: int, errors: int) -> np.ndarray:
    """Exactly ``errors`` edits at distinct positions of each of ``n``
    segments of ``length``, each a substitution, an insertion or a
    deletion with equal chance."""
    op = np.full((n, length), KEEP, np.uint8)
    if errors:
        keys = rng.random((n, length), dtype=np.float32)
        pos = np.argpartition(keys, errors - 1, axis=1)[:, :errors]
        kinds = rng.integers(SUB, DEL + 1, (n, errors), dtype=np.uint8)
        np.put_along_axis(op, pos, kinds, axis=1)
    return op.reshape(-1)


def apply_ops(rng, letters: Letters, src: np.ndarray, offsets: np.ndarray,
              op: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The mutated flat array and its offsets.  A segment that every
    edit would empty keeps its source."""
    val = src.copy()
    sub = op == SUB
    val[sub] = letters.draw_other(rng, src[sub])
    counts = np.ones(len(src), np.int64)
    counts[op == INS] = 2
    counts[op == DEL] = 0
    ends = offsets_of(counts)
    empty = np.nonzero(np.diff(ends[offsets]) == 0)[0]
    for s in empty:
        a, b = offsets[s], offsets[s + 1]
        val[a:b] = src[a:b]
        counts[a:b] = 1
    if empty.size:
        ends = offsets_of(counts)
    out = np.repeat(val, counts)
    ins = (op == INS) & (counts == 2)
    out[ends[:-1][ins]] = letters.draw(rng, int(ins.sum()))
    return out, ends[offsets]


def to_bytes(letters: Letters, idx: np.ndarray,
             offsets: np.ndarray) -> list[bytes]:
    blob = letters.alphabet[idx].tobytes()
    off = offsets.tolist()
    return [blob[a:b] for a, b in zip(off[:-1], off[1:])]
