"""The benchmark's plain reference: affine-gap alignment in plain PyTorch.

Gotoh's recurrence, a gap of k positions costing ``open + (k - 1) *
extend``, global (``nw``), semi-global (``sg``) or local (``sw``), one
query row at a time over a batch of pairs, on whatever device the
tensors live.  Within a row the horizontal gap F is a running maximum:
with ``open >= extend`` a gap opened from a cell whose H came from F
never beats extending F, so ``F[j] = max_{k <= j}(H~[k] + k * extend) - open - j * extend`` over
the row's H~ = max(diagonal, E, [0 for local]).  The end cell, the
flags and the walk follow parasail's tie order: H prefers the diagonal,
then E (a vertical gap, CIGAR ``I``), then F (``D``); a gap prefers
opening on ties; a local end is the first maximum in row order, then
column order; the walk starts in H at the end cell.

Semi-global ends (``free_ends``): a free query begin (``qb``) zeroes
row 0 and a free reference begin (``db``) column 0; a free query end
(``qe``) makes each pair's own last row end candidates, a free
reference end (``de``) its own last column; the corner always is one.
The end is the largest candidate, the smallest row, then the smallest
column, on ties.  The walk leaves out a leading gap run that reaches a
free border (overhang); any other is part of the CIGAR, as in ``nw``.

A band (``nw`` only, ``bandwidth``): only cells with ``|i - j| <=
bandwidth`` on the bordered grid are computed, border cells included;
every other cell is ``NEG`` in H, E and F, so a pair whose corner lies
outside the band scores ``NEG`` (-2^30).  Score only.

``saturate8`` computes every value in saturating 8-bit arithmetic
([-128, 127]): the control that a check must fail.
"""

from __future__ import annotations

import numpy as np
import torch

from .matrices import encoder

NEG = -(1 << 30)

# flag bits of one cell (parasail's trace table)
ZERO, INS, DEL, DIAG = 0, 1, 2, 4
DIAG_E, INS_E, DIAG_F, DEL_F = 8, 16, 32, 64

# flag plane cells one batch may hold
PLANE_CELLS = 1 << 32

# the free-end sets parasail names: sg (all four), sg_qb, sg_qe, sg_qx,
# sg_db, sg_de, sg_dx, sg_qb_de, sg_qe_db
SG_SETS = [frozenset(s) for s in (
    ("qb", "qe", "db", "de"), ("qb",), ("qe",), ("qb", "qe"), ("db",),
    ("de",), ("db", "de"), ("qb", "de"), ("qe", "db"))]


def free_ends(scoring) -> tuple[bool, bool, bool, bool]:
    """``(qb, qe, db, de)`` of a configuration's ``scoring``: which of
    the query's and the reference's begin and end gaps are free.  Only
    ``sg`` has free ends; its ``free`` lists parasail's suffixes, absent
    or empty meaning all four, and must be one of ``SG_SETS``."""
    free = scoring.get("free")
    if scoring["mode"] != "sg":
        if free is not None:
            raise ValueError("free ends are for mode sg")
        return (False,) * 4
    names = list(free or SG_SETS[0])
    if len(set(names)) != len(names) or frozenset(names) not in SG_SETS:
        raise ValueError(f"free {free!r}: not one of parasail's sg sets")
    return tuple(k in names for k in ("qb", "qe", "db", "de"))


def bandwidth(scoring) -> int | None:
    """The configuration's band (``nw`` only), or None."""
    bw = scoring.get("bandwidth")
    if bw is None:
        return None
    if scoring["mode"] != "nw" or type(bw) is not int or bw < 0:
        raise ValueError(f"bandwidth {bw!r}: a whole number >= 0, nw only")
    return bw


def _letters(seqs, lut, width, device):
    out = np.zeros((len(seqs), width), np.int64)
    for b, s in enumerate(seqs):
        idx = lut[np.frombuffer(s, np.uint8)]
        if (idx < 0).any():
            raise ValueError("a sequence holds a letter outside the matrix")
        out[b, :len(s)] = idx
    return torch.from_numpy(out).to(device)


def _sweep(queries, refs, alphabet, matrix, open_, ext, mode, trace,
           device, saturate8, free=(False,) * 4, band=None):
    """One batch: scores, ends and (with ``trace``) the flag plane."""
    if mode not in ("nw", "sg", "sw"):
        raise ValueError(f"mode {mode!r}: the reference knows nw, sg, sw")
    if open_ < ext:
        raise ValueError("the row scan needs gap open >= gap extend")
    if band is not None and trace:
        raise ValueError("a band is score only")
    local, sg = mode == "sw", mode == "sg"
    qb, qe, db, de = free
    lut = encoder(alphabet)
    B = len(queries)
    qlen = torch.tensor([len(q) for q in queries], device=device)
    rlen = torch.tensor([len(r) for r in refs], device=device)
    if int(qlen.min()) < 1 or int(rlen.min()) < 1:
        raise ValueError("empty sequence")
    Qm, Rm = int(qlen.max()), int(rlen.max())
    Q = _letters(queries, lut, Qm, device)
    R = _letters(refs, lut, Rm, device)
    M = torch.from_numpy(np.asarray(matrix, np.int32)).to(device)
    i32 = dict(dtype=torch.int32, device=device)
    lo, hi = (-128, 127) if saturate8 else (NEG, -NEG)

    def sat(x):
        return x.clamp_(lo, hi) if saturate8 else x

    cols = torch.arange(Rm, device=device)
    kext = (cols * ext).to(torch.int32)
    # row 0: H[0, 0] = 0, H[0, j] = -(open + (j - 1) * extend) or 0
    Hprev = torch.zeros((B, Rm + 1), **i32)
    if not (local or qb):
        Hprev[:, 1:] = sat(-(open_ + kext))
    if band is not None:
        Hprev[:, 1:].masked_fill_(cols >= band, lo)
    Eprev = torch.full((B, Rm), NEG, **i32)
    neg_col = torch.full((B, 1), NEG, **i32)
    score = torch.zeros(B, dtype=torch.int32, device=device)
    if sg:
        score.fill_(torch.iinfo(torch.int32).min)
    end_q = torch.zeros(B, dtype=torch.int64, device=device)
    end_r = torch.zeros(B, dtype=torch.int64, device=device)
    pad_cols = cols[None, :] >= rlen[:, None]
    last_col = (rlen - 1)[:, None]
    plane = (torch.empty((B, Qm, Rm), dtype=torch.int8, device=device)
             if trace else None)
    for i in range(Qm):
        s = torch.gather(M[Q[:, i]], 1, R)
        up = sat(Hprev[:, 1:] - open_)
        E = torch.maximum(up, sat(Eprev - ext))
        diag = sat(Hprev[:, :-1] + s)
        Ht = torch.maximum(diag, E)
        if local or db:
            if local:
                Ht.clamp_(min=0)
            col0 = torch.zeros((B, 1), **i32)
        else:
            col0 = torch.full((B, 1), -(open_ + i * ext), **i32)
            sat(col0)
        if band is not None:
            out = (cols - i).abs() > band
            E.masked_fill_(out, lo)
            Ht.masked_fill_(out, lo)
            if i >= band:
                col0.fill_(lo)
        Hx = torch.cat([col0, Ht[:, :-1]], 1)
        F = sat(torch.cummax(Hx + kext, 1).values - open_ - kext)
        H = torch.maximum(Ht, F)
        if band is not None:
            H.masked_fill_(out, lo)
        if trace:
            eflag = torch.where(up >= Eprev - ext, DIAG_E, INS_E)
            Hleft = torch.cat([col0, H[:, :-1]], 1)
            Fleft = torch.cat([neg_col, F[:, :-1]], 1)
            fflag = torch.where(Hleft - open_ >= Fleft - ext, DIAG_F, DEL_F)
            hflag = torch.where((diag >= E) & (diag >= F), DIAG,
                                torch.where(E >= F, INS, DEL))
            if local:
                best3 = torch.maximum(torch.maximum(diag, E), F)
                hflag = torch.where(best3 <= 0, ZERO, hflag)
            plane[:, i, :] = (hflag | eflag | fflag).to(torch.int8)
        if local:
            rowmax, arg = H.masked_fill(pad_cols, -1).max(1)
            better = (rowmax > score) & (i < qlen)
            score = torch.where(better, rowmax, score)
            end_q = torch.where(better, i, end_q)
            end_r = torch.where(better, arg, end_r)
        elif sg:
            # this row's candidate: the last row's first maximum with qe,
            # else the pair's own last column (every row with de)
            here = qlen == i + 1
            cand = torch.gather(H, 1, last_col).squeeze(1)
            arg = rlen - 1
            if qe:
                rowmax, rarg = H.masked_fill(pad_cols, NEG).max(1)
                cand = torch.where(here, rowmax, cand)
                arg = torch.where(here, rarg, arg)
            better = (cand > score) & ((i < qlen) if de else here)
            score = torch.where(better, cand, score)
            end_q = torch.where(better, i, end_q)
            end_r = torch.where(better, arg, end_r)
        else:
            here = qlen == i + 1
            corner = torch.gather(H, 1, last_col).squeeze(1)
            score = torch.where(here, corner, score)
        Hprev = torch.cat([col0, H], 1)
        Eprev = E
    if mode == "nw":
        end_q, end_r = qlen - 1, rlen - 1
    return (score.cpu().tolist(), end_q.cpu().tolist(),
            end_r.cpu().tolist(), plane)


def walk(flags: bytes, stride: int, query: bytes, ref: bytes, end_q: int,
         end_r: int, local: bool, qb: bool = False, db: bool = False) -> str:
    """The CIGAR of one pair, walked back from its end cell over its flag
    rows (``flags[i * stride + j]``): runs of ``=``, ``X``, ``I`` and
    ``D``; a global alignment's leading gap runs are part of it, but for
    one that reaches a free border (``qb``: row 0, ``db``: column 0)."""
    i, j = end_q, end_r
    rev = []
    state = 0                 # 0: H, 1: E (vertical gap), 2: F
    while i >= 0 and j >= 0:
        t = flags[i * stride + j]
        if state == 0:
            h = t & 7
            if h == ZERO and local:
                break
            if h & DIAG:
                rev.append("=" if query[i] == ref[j] else "X")
                i -= 1
                j -= 1
            elif h & INS:
                rev.append("I")
                state = 0 if t & DIAG_E else 1
                i -= 1
            elif h & DEL:
                rev.append("D")
                state = 0 if t & DIAG_F else 2
                j -= 1
            else:
                break
        elif state == 1:
            rev.append("I")
            state = 0 if t & DIAG_E else 1
            i -= 1
        else:
            rev.append("D")
            state = 0 if t & DIAG_F else 2
            j -= 1
    if not local:
        if i >= 0 and j < 0 and not db:
            rev.extend("I" * (i + 1))
        if j >= 0 and i < 0 and not qb:
            rev.extend("D" * (j + 1))
    runs = []
    for c in reversed(rev):
        if runs and runs[-1][1] == c:
            runs[-1][0] += 1
        else:
            runs.append([1, c])
    return "".join(f"{n}{c}" for n, c in runs)


def align(pairs, scoring, *, cigar: bool, device="cpu",
          saturate8: bool = False) -> list[tuple]:
    """``(score, end_query, end_ref, cigar or None)`` of each
    ``(query, ref)`` pair under a configuration's ``scoring``
    (``mode``, ``matrix``, ``gap_open``, ``gap_extend``; ``free`` for
    ``sg``, ``bandwidth`` for ``nw``).  Pairs run in batches of like
    size, their flag planes within ``PLANE_CELLS``."""
    from .matrices import table

    alphabet, matrix = table(scoring["matrix"])
    mode, open_, ext = (scoring["mode"], scoring["gap_open"],
                        scoring["gap_extend"])
    free, band = free_ends(scoring), bandwidth(scoring)
    order = sorted(range(len(pairs)),
                   key=lambda k: (max(map(len, pairs[k])), len(pairs[k][0])))
    out: list[tuple | None] = [None] * len(pairs)
    k = 0
    while k < len(order):
        n = 1
        qm, rm = map(len, pairs[order[k]])
        while k + n < len(order):
            q, r = pairs[order[k + n]]
            qm, rm = max(qm, len(q)), max(rm, len(r))
            if cigar and (n + 1) * qm * rm > PLANE_CELLS:
                break
            n += 1
        group = order[k:k + n]
        qs = [pairs[g][0] for g in group]
        rs = [pairs[g][1] for g in group]
        score, eq, er, plane = _sweep(qs, rs, alphabet, matrix, open_, ext,
                                      mode, cigar, device, saturate8, free,
                                      band)
        for b, g in enumerate(group):
            cig = None
            if cigar:
                flags = plane[b].cpu().numpy().tobytes()
                cig = walk(flags, plane.shape[2], qs[b], rs[b], eq[b], er[b],
                           mode == "sw", free[0], free[2])
            out[g] = (score[b], eq[b], er[b], cig)
        del plane
        k += n
    return out
