"""Batched anti-diagonal wavefront DP fill, every output class, in torch ops.

The port of ``parasail_rs_tpu.ops.wavefront.wavefront_align`` (XLA in
the reference, so plain PyTorch here, not a hand kernel).  It is the
plain version of the CUDA kernels' stats, table and rowcol forms
(``csrc/scan_short.cu``, ``csrc/scan_chunked.cu``) and of every banded
form (``csrc/scan_banded.cu``, ``csrc/scan_short_banded.cu``,
``csrc/scan_chunked_banded.cu``): :func:`~.scan_kernel.score_align` runs it
on CPU tensors for those classes, and ``chip_smoke.py`` holds the kernels
to it on the card.

Cells on one anti-diagonal of the affine-gap recurrence do not depend on
each other, so the reference's ``lax.scan`` over the D = Qp + Rp - 1
anti-diagonals becomes a Python loop of torch ops vectorised over
(B, Qp): lane i of step d is cell (i, d - i).  Every value, flag and
payload follows golden's literal ``>=`` comparisons, so every penalty pair
is exact, open <= ext included.  All arithmetic is int32 with
``NEG_INF32`` as minus infinity, as in the reference.

Where it differs from the reference, on purpose:

- a pair with an empty side (qlen == 0 or rlen == 0) gets golden's end
  cell and payload on the bordered grid (:func:`empty_side`), banded
  ones the all-gap border within the band and -2^30 beyond it, as
  golden's ``banded_nw_fill``; the reference's wavefront gives -2^30 and
  padded coordinates there (ROADMAP Queue 3);
- planes (trace and tables) are 0 outside each pair's qlen x rlen cells,
  as the kernel writes them; the reference leaves the padded cells'
  values there;
- a reference letter outside [0, A) scores 0, as in the kernel.
"""

from __future__ import annotations

import torch

from ..constants import (
    NEG_INF32,
    TRACE_DEL,
    TRACE_DEL_F,
    TRACE_DIAG,
    TRACE_DIAG_E,
    TRACE_DIAG_F,
    TRACE_INS,
    TRACE_INS_E,
    WIDTH_MAX,
    WIDTH_MIN,
)

STATS_CLASSES = ("stats", "stats_table", "stats_rowcol")
STATS_KEYS = ("matches", "similar", "length")
PLANES = ("score", "matches", "similar", "length")


def flag_outputs(score, eq, er, sat8, sat16, width) -> dict:
    """The reference's scalar output dict (scan_kernel.py:1466-1488):
    ``saturated`` is the flag of the width (16-bit at ``sat``, where
    ``promoted`` is the 8-bit one; never at 32 and 64)."""
    out = {"score": score, "end_query": eq, "end_ref": er}
    if width == "8":
        out["saturated"] = sat8
    elif width in ("16", "sat"):
        out["saturated"] = sat16
        if width == "sat":
            out["promoted"] = sat8
    else:
        out["saturated"] = torch.zeros_like(sat8)
    return out


def empty_side(best, eq, er, qlen, rlen, Qp, Rp, border, qb, qe, db, de):
    """Golden's end cell for the pairs with qlen == 0 or rlen == 0 (no
    in-sequence cell): the best of the corner and, if qe (qlen == 0) or
    de (rlen == 0), the other cells of the bordered grid's one line;
    value desc, then position asc.  Both empty: 0 at (-1, -1).
    ``border(c, is_free)`` gives the line's cell at c characters
    (NEG_INF32 beyond a band).

    Returns (score, end_query, end_ref, length, empty): the length
    payload of that cell is the characters it consumes, or 0 on a free
    border (matches and similar are 0); ``empty`` marks the pairs."""
    def pick(n, P, is_free, end_free):
        c = torch.arange(1, P + 1, dtype=torch.int32, device=n.device)
        cand = (c[None] <= n[:, None]) & (end_free | (c[None] == n[:, None]))
        v = torch.where(cand, border(c, is_free)[None], NEG_INF32)
        top = v.amax(dim=1) if P else torch.full_like(n, NEG_INF32)
        at = (torch.where(cand & (v == top[:, None]), c[None], P + 1)
              .amin(dim=1) if P else torch.zeros_like(n))
        length = torch.where(n > 0, 0 if is_free else at, 0)
        return top, at - 1, length

    q0, r0 = qlen == 0, rlen == 0
    s_r, at_r, l_r = pick(rlen, Rp, qb, qe)   # qlen == 0: along the top row
    s_q, at_q, l_q = pick(qlen, Qp, db, de)   # rlen == 0: the left column
    both = q0 & r0
    best = torch.where(both, 0, torch.where(q0, s_r,
                                            torch.where(r0, s_q, best)))
    eq = torch.where(q0, -1, torch.where(r0, at_q, eq))
    er = torch.where(r0, -1, torch.where(q0, at_r, er))
    length = torch.where(q0, l_r, l_q)
    i32 = torch.int32
    return (best.to(i32), eq.to(i32), er.to(i32), length.to(i32), q0 | r0)


def _undiagonalise(slabs, k, B, Qp, Rp, dev, dtype):
    """Plane k of the per-diagonal slabs, as (B, Qp, Rp)."""
    if Qp + Rp - 1 <= 0:
        return torch.zeros((B, Qp, Rp), dtype=dtype, device=dev)
    ii = torch.arange(Qp, device=dev)[:, None]
    dd = ii + torch.arange(Rp, device=dev)[None, :]          # (Qp, Rp)
    slab = torch.stack([st[k] for st in slabs])              # (D, B, Qp)
    return slab[dd, :, ii].permute(2, 0, 1).contiguous()


def _shift1(x, fill):
    """y[..., i] = x[..., i - 1]; y[..., 0] = fill (along the lanes)."""
    return torch.nn.functional.pad(x[..., :-1], (1, 0), value=fill)


def wavefront_align(profile, qidx, ridx, qlen, rlen, *, open_, ext, mode,
                    free, outputs, width="32", banded=False, bandwidth=0,
                    col_offset=0, left=None, segment=False, row_offset=0,
                    top=None, corner=None, qp_total=None) -> dict:
    """Run the batched wavefront fill; return a dict of tensors on the
    inputs' device.

    ``profile`` (1 or B, Qp, A) substitution rows, ``qidx`` (1 or B, Qp)
    query letters (compared for ``matches``; may be None outside the
    stats classes), ``ridx`` (B, Rp), ``qlen`` / ``rlen`` (B,): int32.
    Returns ``score``, ``end_query``, ``end_ref`` (B,) int32 and
    ``saturated`` (+ ``promoted`` at width ``sat``) bool, and per class:

    - stats*:   ``matches``, ``similar``, ``length`` (B,)
    - table(s): ``score_table`` (+ ``matches/similar/length_table``)
      (B, Qp, Rp)
    - rowcol:   ``score_row`` (B, Rp) / ``score_col`` (B, Qp) (+ stats
      rows and columns), 0 beyond each pair's lengths
    - trace:    ``trace_table`` (B, Qp, Rp) int8 flags

    ``banded`` excludes cells with |i - j| > ``bandwidth`` (border cells
    beyond the band included), as the reference does.

    ``segment=True`` fills one reference segment of longer pairs (the
    plain version of the segment kernel, ``scan_kernel.score_segment``):
    ``ridx`` holds columns [``col_offset``, ``col_offset`` + Rp) of the
    pairs, ``rlen`` stays their whole length, and ``left`` carries the
    column left of the segment: ``h`` and ``f`` (B, Qp), and for the stats
    class ``pay``, the (6, B, Qp) payloads of both; None means the bordered
    left column.  It returns the raw sweep, not the mode's outputs:
    ``best`` / ``best_i`` / ``best_j`` (the first maximum among the
    segment's candidates in row-major order, -2^30 at (Qp, 2^30) if none;
    ``best_j`` a global column), ``best_pay`` (3, B), ``hmax`` / ``hmin``
    over the segment's cells (0 if none), the new ``h`` / ``f`` / ``pay``
    (each pair's last column in the segment, rows below ``qlen``; a pair
    with no column here keeps ``left``'s), and the trace class's
    ``trace_table``.

    ``top`` (with ``segment=True``) fills one TILE of a sequence-parallel
    fill (the plain version of the tile kernel,
    ``scan_kernel.score_rowseg``): ``profile`` / ``qidx`` hold query rows
    [``row_offset``, ``row_offset`` + Qp) of the pairs, ``qlen`` stays
    their whole length, ``left`` is required and holds those rows, and
    the row above the tile is read, not computed: ``top`` (B, 2 or 8, Rp)
    holds per column H and E of row ``row_offset`` - 1 (stats: then the
    payloads of H and of E), ``corner`` (B, 4) H and its payload left of
    that row.  The raw sweep then has ``best_i`` as a global row
    (``qp_total`` if none) and ``down``, ``top``'s layout: the tile's last
    row where the pair has it, ``top`` elsewhere.
    """
    dev = ridx.device
    i32 = torch.int32
    _, Qp, A = profile.shape
    B, Rp = ridx.shape
    D = Qp + Rp - 1
    local = mode == "sw"
    qb, qe, db, de = (True,) * 4 if local else tuple(bool(x) for x in free)
    want_stats = outputs in STATS_CLASSES
    want_tables = outputs in ("table", "stats_table")
    want_rowcol = outputs in ("rowcol", "stats_rowcol")
    want_trace = outputs == "trace"
    nplanes = 4 if want_stats else 1
    neg = NEG_INF32
    open_, ext, bw = int(open_), int(ext), int(bandwidth)
    off = int(col_offset)
    r0 = int(row_offset)
    ivec = torch.arange(Qp, dtype=i32, device=dev)
    ig = ivec + r0                      # the lanes' global rows
    tile = top is not None
    if tile:
        down = top.clone()

    def border(c, is_free):             # H[0][c] / H[c][0], golden's
        base = torch.where(c > 0, -(open_ + (c - 1) * ext), 0).to(i32)
        return torch.zeros_like(base) if is_free else base

    def boundary(c, is_free):           # the same, out of the band -inf
        base = border(c, is_free)
        return torch.where(c <= bw, base, neg) if banded else base

    def blen(c, is_free):               # the border's length payload
        return torch.zeros_like(c) if is_free else c

    prof = profile.expand(B, Qp, A)
    if qidx is None:
        qidx = torch.zeros((1, Qp), dtype=i32, device=dev)
    qid = qidx.expand(B, Qp)
    # lengths within this segment's columns (the whole pair when off == 0)
    qlen_c, rlen_c = qlen[:, None], (rlen - off)[:, None]
    brange = torch.arange(B, device=dev)

    def full(v, shape=(B, Qp)):
        return torch.full(shape, v, dtype=i32, device=dev)

    # the column left of the segment: carried, or the bordered left column
    # (the stats payloads travel stacked: (3, B, Qp) for H's m, s, l, and
    # (6, B, Qp) for H's then F's)
    if left is None:
        left_h = boundary(ig + 1, db)[None].expand(B, Qp)
        left_f = full(neg)
        left_p = torch.stack([full(0), full(0),
                              blen(ig + 1, db)[None].expand(B, Qp),
                              full(0), full(0), full(0)]) \
            if want_stats else None
    else:
        left_h, left_f = left["h"], left["f"]
        left_p = left["pay"] if want_stats else None
    if segment:
        end_c = rlen_c.clamp(0, Rp) - 1       # each pair's last column here
        st_h, st_f = left_h.clone(), left_f.clone()
        st_p = left_p.clone() if want_stats else None

    H1, H2, E1, F1 = full(neg), full(neg), full(neg), full(neg)
    best, best_i, best_j = full(neg, (B,)), full(Qp, (B,)), full(Rp, (B,))
    # the extremes of H over the in-sequence cells (0 if none), for the
    # saturation flags
    hmax_all, hmin_all = full(0, (B,)), full(0, (B,))
    i0 = (ivec == 0)[None, :]
    last_row = ig[None, :] == qlen_c - 1
    if want_stats:
        Hp1 = full(0, (3, B, Qp))             # H payloads (m, s, l), d - 1
        Hp2 = full(0, (3, B, Qp))             # d - 2
        Ep1 = full(0, (3, B, Qp))
        Fp1 = full(0, (3, B, Qp))
        best_p = full(0, (3, B))
        left_hp, left_fp = left_p[:3], left_p[3:]
        left_hp_dg = _shift1(left_hp, 0)      # the diagonal at column 0
        step_l = torch.tensor([0, 0, 1], dtype=i32, device=dev)[:, None,
                                                                None]
        ones = full(1)
        zq = torch.zeros(Qp, dtype=i32, device=dev)
    if want_rowcol:
        rows = [full(0, (B, Rp)) for _ in range(nplanes)]
        cols = [full(0, (B, Qp)) for _ in range(nplanes)]
    slabs = []

    for d in range(D):
        jvec = d - ivec                                   # (Qp,)
        on_diag = ((jvec >= 0) & (jvec < Rp))[None, :]
        in_seq = on_diag & (ig[None, :] < qlen_c) & (jvec[None, :] < rlen_c)
        rd = ridx[:, jvec.clamp(0, Rp - 1)]
        rd = torch.where(on_diag, rd, 0)
        rok = (rd >= 0) & (rd < A)
        s = torch.gather(prof, 2, rd.clamp(0, A - 1).long()[:, :, None])[..., 0]
        s = torch.where(rok, s, 0)
        j0 = (jvec == 0)[None, :]

        if tile:
            # row 0 of the tile is lane 0, at column d: what it reads from
            # the row above is `top` at columns d and d - 1 (the corner)
            t_at = top[:, :, min(d, Rp - 1)]
            t_dg = corner if d == 0 else torch.cat(
                [top[:, :1, min(d - 1, Rp - 1)],
                 (top[:, 2:5, min(d - 1, Rp - 1)] if want_stats
                  else top.new_zeros((B, 3)))], dim=1)
            top_h, top_e = t_at[:, :1], t_at[:, 1:2]
            top_hd = t_dg[:, :1]
        else:
            top_h = boundary(jvec + off + 1, qb)[None]
            top_e = neg
            top_hd = boundary(jvec + off, qb)[None]
        h_up = torch.where(i0, top_h, _shift1(H1, 0))
        e_up = torch.where(i0, top_e, _shift1(E1, 0))
        h_left = torch.where(j0, left_h, H1)
        f_left = torch.where(j0, left_f, F1)
        h_diag = torch.where(
            i0, top_hd,
            torch.where(j0, _shift1(left_h, 0), _shift1(H2, 0)))

        e_open, e_ext = h_up - open_, e_up - ext
        E = torch.maximum(e_open, e_ext)
        from_open_e = e_open >= e_ext
        f_open, f_ext = h_left - open_, f_left - ext
        F = torch.maximum(f_open, f_ext)
        from_open_f = f_open >= f_ext
        diag = h_diag + s
        H = torch.maximum(torch.maximum(diag, E), F)
        take_diag = diag >= torch.maximum(E, F)
        take_e = ~take_diag & (E >= F)
        if local:
            clamp0 = H <= 0
            H = H.clamp_min(0)
        if banded:
            in_band = ((ivec - jvec).abs() <= bw)[None, :]
            H = torch.where(in_band, H, neg)
            E = torch.where(in_band, E, neg)
            F = torch.where(in_band, F, neg)

        H2 = H1
        H1 = torch.where(on_diag, H, H1)
        E1 = torch.where(on_diag, E, E1)
        F1 = torch.where(on_diag, F, F1)

        if want_stats:
            if tile:
                top_u = t_at[:, 2:5].t()[:, :, None]          # (3, B, 1)
                top_eu = t_at[:, 5:8].t()[:, :, None]
                top_d = t_dg[:, 1:4].t()[:, :, None]
            else:
                top_u = torch.stack([zq, zq, blen(jvec + off + 1, qb)])[
                    :, None]                                  # (3, 1, Qp)
                top_eu = 0
                top_d = torch.stack([zq, zq, blen(jvec + off, qb)])[:, None]
            up = torch.where(i0, top_u, _shift1(Hp1, 0))
            eup = torch.where(i0, top_eu, _shift1(Ep1, 0))
            lft = torch.where(j0, left_hp, Hp1)
            fleft = torch.where(j0, left_fp, Fp1)
            dg = torch.where(i0, top_d,
                             torch.where(j0, left_hp_dg, _shift1(Hp2, 0)))
            Ep = torch.where(from_open_e, up, eup) + step_l
            Fp = torch.where(from_open_f, lft, fleft) + step_l
            Dp = dg + torch.stack([(qid == rd).to(i32), (s > 0).to(i32),
                                   ones])
            Hp = torch.where(take_diag, Dp, torch.where(take_e, Ep, Fp))
            if local:
                Hp = torch.where(clamp0, 0, Hp)
            Hp2 = Hp1
            Hp1 = torch.where(on_diag, Hp, Hp1)
            Ep1 = torch.where(on_diag, Ep, Ep1)
            Fp1 = torch.where(on_diag, Fp, Fp1)

        hs = torch.where(in_seq, H, 0)
        hmax, hmin = hs.amax(dim=1), hs.amin(dim=1)
        jl = d - (Qp - 1)               # the last lane's column
        if tile and 0 <= jl < Rp:
            vals = [H, E] + (list(Hp) + list(Ep) if want_stats else [])
            new = torch.stack([v[:, Qp - 1] for v in vals], dim=1)
            down[:, :, jl] = torch.where(in_seq[:, Qp - 1:], new,
                                         down[:, :, jl])
        if segment:
            at_end = in_seq & (jvec[None, :] == end_c)
            st_h = torch.where(at_end, H, st_h)
            st_f = torch.where(at_end, F, st_f)
            if want_stats:
                st_p = torch.where(at_end, torch.cat([Hp, Fp]), st_p)
        hmax_all = torch.maximum(hmax_all, hmax)
        hmin_all = torch.minimum(hmin_all, hmin)

        last_col = jvec[None, :] == rlen_c - 1
        if local:
            cand = in_seq & (H > 0)
        elif mode == "sg":
            sel = last_row & last_col           # the corner, always
            if qe:
                sel = sel | last_row
            if de:
                sel = sel | last_col
            cand = in_seq & sel
        else:
            cand = in_seq & last_row & last_col
        hc = torch.where(cand, H, neg)
        step_best = hc.amax(dim=1)
        step_i = torch.where(hc == step_best[:, None], ivec[None, :],
                             Qp).amin(dim=1)
        better = (step_best > best) | ((step_best == best) &
                                       (step_best > neg) & (step_i < best_i))
        best = torch.where(better, step_best, best)
        best_i = torch.where(better, step_i, best_i)
        best_j = torch.where(better, d - step_i, best_j)
        if want_stats:
            at = step_i.clamp(0, Qp - 1)[None, :, None].expand(3, B, 1)
            best_p = torch.where(better, Hp1.gather(2, at)[..., 0], best_p)

        if want_rowcol:
            vals = [H] + (list(Hp) if want_stats else [])
            jcol = (d - (qlen - 1)).clamp(0, Rp - 1).long()
            icol = (d - (rlen - 1)).clamp(0, Qp - 1).long()
            at_row = (qlen - 1).clamp(0, Qp - 1).long()[:, None]
            rok_b = (in_seq & last_row).any(dim=1)
            cok_b = (in_seq & last_col).any(dim=1)
            for k, M in enumerate(vals):
                rv = M.gather(1, at_row)[:, 0]
                rows[k][brange, jcol] = torch.where(
                    rok_b, rv, rows[k][brange, jcol])
                cv = M.gather(1, icol[:, None])[:, 0]
                cols[k][brange, icol] = torch.where(
                    cok_b, cv, cols[k][brange, icol])

        if want_trace:
            eflag = torch.where(from_open_e, TRACE_DIAG_E, TRACE_INS_E)
            fflag = torch.where(from_open_f, TRACE_DIAG_F, TRACE_DEL_F)
            hflag = torch.where(take_diag, TRACE_DIAG,
                                torch.where(take_e, TRACE_INS, TRACE_DEL))
            if local:
                hflag = torch.where(clamp0, 0, hflag)
            slabs.append([torch.where(in_seq, hflag | eflag | fflag, 0)
                          .to(torch.int8)])
        elif want_tables:
            vals = [H] + (list(Hp) if want_stats else [])
            slabs.append([torch.where(in_seq, v, 0) for v in vals])

    sat8 = (hmax_all >= WIDTH_MAX["8"]) | (hmin_all <= WIDTH_MIN["8"])
    sat16 = (hmax_all >= WIDTH_MAX["16"]) | (hmin_all <= WIDTH_MIN["16"])
    if segment:
        none = best <= neg
        out = {"best": best,
               "best_i": torch.where(
                   none, Qp if qp_total is None else int(qp_total),
                   best_i + r0),
               "best_j": torch.where(none, 1 << 30, best_j + off),
               "hmax": hmax_all, "hmin": hmin_all, "h": st_h, "f": st_f}
        if want_stats:
            out["best_pay"] = best_p
            out["pay"] = st_p
        if want_trace:
            out["trace_table"] = _undiagonalise(slabs, 0, B, Qp, Rp, dev,
                                                torch.int8)
        if tile:
            out["down"] = down
        return out
    stats = best_p if want_stats else None
    if mode == "nw":
        score, eq, er = best, qlen - 1, rlen - 1
    elif local:
        # no cell above 0: golden's empty local alignment, 0 at (0, 0)
        none = best <= 0
        score, eq, er = (torch.where(none, 0, x)
                         for x in (best, best_i, best_j))
        if want_stats:
            stats = [torch.where(none, 0, p) for p in stats]
    else:
        score, eq, er = best, best_i, best_j
    if not local:
        # banded: the border beyond the band is -inf, as in banded_nw_fill
        score, eq, er, elen, empty = empty_side(
            score, eq, er, qlen, rlen, Qp, Rp, boundary, qb,
            qe and mode == "sg", db, de and mode == "sg")
        if want_stats:
            stats = [torch.where(empty, 0, stats[0]),
                     torch.where(empty, 0, stats[1]),
                     torch.where(empty, elen, stats[2])]
    out = flag_outputs(score.to(i32), eq.to(i32), er.to(i32), sat8, sat16,
                       width)
    if want_stats:
        out.update(zip(STATS_KEYS, stats))

    names = PLANES[:nplanes]
    if want_tables or want_trace:
        for k, name in enumerate(("trace",) if want_trace else names):
            out[f"{name}_table"] = _undiagonalise(
                slabs, k, B, Qp, Rp, dev, torch.int8 if want_trace else i32)
    if want_rowcol:
        for k, name in enumerate(names):
            out[f"{name}_row"], out[f"{name}_col"] = rows[k], cols[k]
    return out
