// Per-pair affine-gap (Gotoh) score sweep, shared by the CUDA kernel
// (scan_score.cu) and the host harness the CPU tests build with g++.
//
// Semantics are those of parasail_rs_tpu's score class
// (ops/scan_kernel.py::_make_kernel, score branch; golden/model.py:156-237):
//
//   E[i][j] = max(H[i-1][j] - open, E[i-1][j] - ext)      vertical gap
//   F[i][j] = max(H[i][j-1] - open, F[i][j-1] - ext)      horizontal gap
//   H[i][j] = max(H[i-1][j-1] + S[i][j], E[i][j], F[i][j])  (>= 0 in SW)
//
// on the bordered (qlen+1, rlen+1) grid.  A non-free border cell at c
// consumed characters is -(open + (c-1)*ext), a free one 0, the corner 0.
// The recurrence is written literally, so the open < ext case needs no
// slope substitution (the TPU kernel's prefix closed form does).
//
// The end cell is the first maximum in row-major order among the mode's
// candidates (H desc, then i asc, then j asc): SW every in-sequence cell
// with H > 0 (none -> score 0 at (0, 0)); SG the corner plus the last row
// if qe and the last column if de; NW the corner.  The width-8/16
// saturation flags are taken over in-sequence H only.
//
// A pair with an empty side has no in-sequence cell; its end cell is
// golden's candidate on the bordered grid's one line (the top row when
// qlen == 0, the left column when rlen == 0), see empty_side().
//
// The trace form (OUT_TRACE) also writes each cell's flags hflag | eflag |
// fflag, bit for bit with golden/model.py:166-211: eflag DIAG_E when
// H[i-1][j] - open >= E[i-1][j] - ext (else INS_E), fflag DIAG_F when
// H[i][j-1] - open >= F[i][j-1] - ext (else DEL_F), hflag DIAG when the
// unclamped diagonal is >= E and >= F, else INS when E >= F, else DEL;
// in SW a cell with max(diag, E, F) <= 0 gets hflag 0 and keeps its E
// and F bits.  The score form compiles without any of it.
//
// The stats forms (OUT_STATS, OUT_STATS_TABLE, OUT_STATS_ROWCOL) carry
// golden's payloads (matches, similar, length; golden/model.py:152-209)
// beside H, E and F: E's from the cell above and F's from the cell to
// the left, each by the same >= open-against-extend comparison that picks
// the value (length + 1); H takes the diagonal's (m + (q == r), s +
// (S > 0), l + 1) when diag >= E and diag >= F, else E's when E >= F,
// else F's; in SW a cell with max(diag, E, F) <= 0 zeroes its payload.
// The top border row carries (0, 0, qb ? 0 : j), the left column (0, 0,
// db ? 0 : i), E above row 0 and F left of column 0 carry 0.  The end
// cell's payload is the output.  `matches` compares mapped letters, not
// bytes.  The table forms write every in-sequence cell's H (after the SW
// clamp) and, with stats, its payload; the rowcol forms write the cells
// of the last row and the last column.  No form writes outside a pair's
// qlen x rlen cells.  Because every value and payload follows golden's
// literal comparisons, open < ext and open == ext need nothing special.
//
// The banded forms (kBanded) are the TPU kernel's banded mode
// (scan_kernel.py:602-617, :722-725, :890-891) in every class and mode:
// cells with |i - j| > bw and border cells beyond bw are NEG_INF32.  The
// score form sweeps only the band's cells; every other form sweeps every
// cell and masks, so that its flags and payloads outside the band are the
// plain version's; see score_pair.
//
// All arithmetic is exact int32 with NEG_INF32 = -2^30 as minus infinity,
// so NEG_INF32 - open - ext cannot wrap.
#pragma once

#include <stdint.h>

#if !defined(__CUDACC__)
#include <vector>
#endif

#if defined(__CUDACC__)
#define PT_HD __host__ __device__ __forceinline__
#else
#define PT_HD inline
#endif

namespace ptscore {

constexpr int32_t NEG_INF32 = -(1 << 30);
constexpr int32_t BIG = 1 << 30;

enum Mode : int32_t { MODE_NW = 0, MODE_SG = 1, MODE_SW = 2 };

// free-end bits (qb, qe, db, de), as in golden.model.free_flags
constexpr int32_t FREE_QB = 1;
constexpr int32_t FREE_QE = 2;
constexpr int32_t FREE_DB = 4;
constexpr int32_t FREE_DE = 8;

// Saturation thresholds (constants.WIDTH_MAX / WIDTH_MIN).
constexpr int32_t W8_MAX = 127, W8_MIN = -128;
constexpr int32_t W16_MAX = 32767, W16_MIN = -32768;

// Trace flags (constants.TRACE_*).
constexpr int32_t TRACE_INS = 1, TRACE_DEL = 2, TRACE_DIAG = 4;
constexpr int32_t TRACE_DIAG_E = 8, TRACE_INS_E = 16;
constexpr int32_t TRACE_DIAG_F = 32, TRACE_DEL_F = 64;

// Output classes, in the order of ops/scan_kernel.py's OUTPUTS.
enum OutClass : int32_t {
  OUT_SCORE = 0,
  OUT_TRACE = 1,
  OUT_STATS = 2,
  OUT_TABLE = 3,
  OUT_STATS_TABLE = 4,
  OUT_ROWCOL = 5,
  OUT_STATS_ROWCOL = 6,
};

// What a form computes beyond the score.
template <int32_t kOut>
struct Out {
  static constexpr bool trace = kOut == OUT_TRACE;
  static constexpr bool stats = kOut == OUT_STATS ||
                                kOut == OUT_STATS_TABLE ||
                                kOut == OUT_STATS_ROWCOL;
  static constexpr bool table = kOut == OUT_TABLE || kOut == OUT_STATS_TABLE;
  static constexpr bool rowcol = kOut == OUT_ROWCOL ||
                                 kOut == OUT_STATS_ROWCOL;
};

// One pair's state and outputs beyond the H and E rows and the trace
// plane.  Plane k of a table, row or column is 0 score, 1 matches,
// 2 similar, 3 length.  Element j of a payload row or of the last row,
// and element i of the last column, sits at [j * stride] / [i * stride],
// as in the H and E rows; a table cell (i, j) at [i * tsi + j * tsj], as
// in the trace plane.
struct PlaneIO {
  const int32_t* mq = nullptr;   // stats: the query letters of `matches`
  int32_t* pay = nullptr;        // stats: rows H m/s/l, E m/s/l
  int64_t pay_plane = 0;
  int32_t* table = nullptr;      // table forms
  int64_t tab_plane = 0;
  int32_t* row = nullptr;        // rowcol forms: the last row
  int64_t row_plane = 0;
  int32_t* col = nullptr;        // rowcol forms: the last column
  int64_t col_plane = 0;
};

struct PairResult {
  int32_t score;
  int32_t end_query;
  int32_t end_ref;
  int32_t sat8;
  int32_t sat16;
  int32_t matches;
  int32_t similar;
  int32_t length;
};

PT_HD int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
PT_HD int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }

// Bordered H at c consumed characters (top_b / left_b of the TPU kernel).
PT_HD int32_t border(int32_t c, bool is_free, int32_t open, int32_t ext) {
  return (is_free || c <= 0) ? 0 : -(open + (c - 1) * ext);
}

// border() of the banded form: -inf beyond the band's half-width bw
// (the TPU kernel's masked top_b / left_b, scan_kernel.py:607-616).
PT_HD int32_t band_border(int32_t c, bool is_free, int32_t open, int32_t ext,
                          int32_t bw) {
  return c <= bw ? border(c, is_free, open, ext) : NEG_INF32;
}

// One DP cell.  h_diag = H[i-1][j-1], h_up = H[i-1][j], e_up = E[i-1][j],
// h_left = H[i][j-1]; f carries F[i][j-1] in and F[i][j] out.
PT_HD void cell(int32_t h_diag, int32_t h_up, int32_t e_up, int32_t h_left,
                int32_t s, int32_t open, int32_t ext, bool local,
                int32_t& f, int32_t& h, int32_t& e) {
  e = imax(h_up - open, e_up - ext);
  f = imax(h_left - open, f - ext);
  int32_t v = imax(imax(h_diag + s, e), f);
  h = local ? imax(v, 0) : v;
}

// cell() plus the cell's trace flags.
PT_HD int32_t cell_trace(int32_t h_diag, int32_t h_up, int32_t e_up,
                         int32_t h_left, int32_t s, int32_t open,
                         int32_t ext, bool local, int32_t& f, int32_t& h,
                         int32_t& e) {
  const int32_t e_open = h_up - open, e_ext = e_up - ext;
  const int32_t f_open = h_left - open, f_ext = f - ext;
  e = imax(e_open, e_ext);
  f = imax(f_open, f_ext);
  const int32_t diag = h_diag + s;
  const int32_t v = imax(imax(diag, e), f);
  h = local ? imax(v, 0) : v;
  int32_t hflag = (diag >= e && diag >= f) ? TRACE_DIAG
                  : (e >= f ? TRACE_INS : TRACE_DEL);
  if (local && v <= 0) hflag = 0;
  return hflag | (e_open >= e_ext ? TRACE_DIAG_E : TRACE_INS_E) |
         (f_open >= f_ext ? TRACE_DIAG_F : TRACE_DEL_F);
}

// A cell's payload (matches, similar, length), golden/model.py:152-209.
struct Pay {
  int32_t m, s, l;
};

// cell() plus golden's payloads.  `up` and `eup` are the payloads of
// H[i-1][j] and E[i-1][j], `left` of H[i][j-1], `diag` of H[i-1][j-1];
// `fp` carries F[i][j-1]'s in and F[i][j]'s out; `match` says whether the
// mapped letters are equal.  `hp` and `ep` receive H[i][j]'s and E[i][j]'s.
// E and F take the opening cell's payload when open >= extend (golden's
// `>=`), H the diagonal's when diag >= E and diag >= F, else E's when
// E >= F, else F's; a local cell with max(diag, E, F) <= 0 zeroes its own.
PT_HD void cell_stats(int32_t h_diag, int32_t h_up, int32_t e_up,
                      int32_t h_left, int32_t s, int32_t open, int32_t ext,
                      bool local, bool match, const Pay& up, const Pay& eup,
                      const Pay& left, const Pay& diag_p, Pay& fp, int32_t& f,
                      int32_t& h, int32_t& e, Pay& hp, Pay& ep) {
  const int32_t e_open = h_up - open, e_ext = e_up - ext;
  const int32_t f_open = h_left - open, f_ext = f - ext;
  e = imax(e_open, e_ext);
  f = imax(f_open, f_ext);
  const int32_t diag = h_diag + s;
  const int32_t v = imax(imax(diag, e), f);
  h = local ? imax(v, 0) : v;
  ep = e_open >= e_ext ? up : eup;
  ep.l += 1;
  if (f_open >= f_ext) fp = left;
  fp.l += 1;
  if (diag >= e && diag >= f) {
    hp.m = diag_p.m + (match ? 1 : 0);
    hp.s = diag_p.s + (s > 0 ? 1 : 0);
    hp.l = diag_p.l + 1;
  } else if (e >= f) {
    hp = ep;
  } else {
    hp = fp;
  }
  if (local && v <= 0) hp = Pay{0, 0, 0};
}

// End cell of a non-local pair with qlen == 0 or rlen == 0 (golden's
// candidates, value desc then (i, j) asc): the corner, plus the top row's
// cells if qe (qlen == 0) or the left column's if de (rlen == 0).  Its
// payload is (0, 0, the characters consumed, or 0 on a free border).
// Banded, a border cell beyond bw is -inf, so a side longer than the band
// scores NEG_INF32, as golden's banded_nw_fill; when every candidate is
// beyond it, the first candidate is the end cell, as in the plain version.
template <bool kBanded = false>
PT_HD PairResult empty_side(int32_t qlen, int32_t rlen, int32_t open,
                            int32_t ext, bool qb, bool qe, bool db,
                            bool de, int32_t bw = 0) {
  PairResult out{0, qlen - 1, rlen - 1, 0, 0, 0, 0, 0};
  const int32_t n = qlen == 0 ? rlen : qlen;
  const bool is_free = qlen == 0 ? qb : db;
  const bool end_free = qlen == 0 ? qe : de;
  int32_t best = NEG_INF32, at = 0;
  for (int32_t c = 1; c <= n; ++c) {
    const int32_t v = kBanded ? band_border(c, is_free, open, ext, bw)
                              : border(c, is_free, open, ext);
    if ((end_free || c == n) && (at == 0 || v > best)) {
      best = v;
      at = c;
    }
  }
  if (n > 0) {
    out.score = best;
    if (qlen == 0) out.end_ref = at - 1; else out.end_query = at - 1;
    out.length = is_free ? 0 : at;
  }
  return out;
}

// Sweep one pair's qlen x rlen cells, i outer and j inner.
//
//   rows:   substitution rows; row i is rows + (qidx ? qidx[i] : i) * A
//           (table form: rows = the (A, A) table, qidx = the query
//           letters; profile form: rows = the pair's (Qp, A) profile,
//           qidx = nullptr).  A letter outside [0, A) scores 0.
//   ridx:   the pair's reference letters.
//   hrow, erow: H and E of the previous row, element j at [j * stride].
//   qp, rp: padded lengths: a non-local pair with no candidate (banded SG,
//           every candidate outside the band) ends at (qp, rp).
//   trace:  OUT_TRACE only: cell (i, j)'s flags go to trace[i * tsi +
//           j * tsj]; the table forms write their planes at the same
//           strides.
//   io:     the stats, table and rowcol forms' rows and planes.
//
// kBanded (K1e): only cells with |i - j| <= bw exist; bw must lie in
// [-1, qp + rlen] (the caller clamps it).  Two sweeps give exactly what
// the plain version (the wavefront, which masks H, E and F outside the
// band and the borders beyond bw to NEG_INF32) gives:
//
// - the score form sweeps only the band: row i takes j in [max(0, i -
//   bw), min(rlen - 1, i + bw)], O(qlen * (2 bw + 1)) cells a pair.  The
//   top row starts as the masked border, so a cell right of row i - 1's
//   band, never written, reads NEG_INF32; at a left edge lo > 0, H and F
//   to the left are NEG_INF32 and the diagonal is row i - 1's H at lo -
//   1; column 0 reads the masked border.  In-band E and F keep the same
//   unclamped int32 values (NEG_INF32 - open and so on).  Out-of-band
//   cells, never swept, are never candidates (the plain version's are
//   NEG_INF32, which no candidate exceeds), and the saturation flags add
//   the plain version's count of them as NEG_INF32 in closed form.
// - every other form sweeps every cell, in the plain version's order:
//   the cell from its (masked) neighbours with the SW clamp, then its
//   flags and payloads from those unmasked comparisons, then H, E and F
//   set to NEG_INF32 outside the band.  So the flags and payloads
//   outside the band, and the extremes behind the saturation flags, are
//   the plain version's; the payloads are never masked.
template <int32_t kOut, bool kBanded = false>
PT_HD PairResult score_pair(const int32_t* rows, const int32_t* qidx,
                            int32_t A, const int32_t* ridx, int32_t qlen,
                            int32_t rlen, int32_t qp, int32_t rp,
                            int32_t* hrow, int32_t* erow, int64_t stride,
                            int32_t open, int32_t ext, int32_t mode,
                            int32_t free_bits, int8_t* trace, int64_t tsi,
                            int64_t tsj, const PlaneIO& io, int32_t bw = 0) {
  // the band-only sweep (score form) and the masked full sweep (the rest)
  constexpr bool kBandOnly = kBanded && kOut == OUT_SCORE;
  constexpr bool kMasked = kBanded && kOut != OUT_SCORE;
  using O = Out<kOut>;
  const bool local = mode == MODE_SW;
  const bool qb = local || (free_bits & FREE_QB);
  const bool db = local || (free_bits & FREE_DB);
  const bool qe = mode == MODE_SG && (free_bits & FREE_QE);
  const bool de = mode == MODE_SG && (free_bits & FREE_DE);
  if (!local && (qlen == 0 || rlen == 0))
    return empty_side<kBanded>(qlen, rlen, open, ext, qb, qe, db, de, bw);

  // payload rows: H's (m, s, l) and E's (m, s, l) of the previous row
  int32_t* const HM = io.pay;
  int32_t* const HS = io.pay + io.pay_plane;
  int32_t* const HL = io.pay + 2 * io.pay_plane;
  int32_t* const EM = io.pay + 3 * io.pay_plane;
  int32_t* const ES = io.pay + 4 * io.pay_plane;
  int32_t* const EL = io.pay + 5 * io.pay_plane;

  // row "-1": the bordered top row H[0][j+1], E = -inf
  for (int32_t j = 0; j < rlen; ++j) {
    hrow[j * stride] = kBanded ? band_border(j + 1, qb, open, ext, bw)
                               : border(j + 1, qb, open, ext);
    erow[j * stride] = NEG_INF32;
    if constexpr (O::stats) {
      const int64_t o = j * stride;
      HM[o] = HS[o] = EM[o] = ES[o] = EL[o] = 0;
      HL[o] = qb ? 0 : j + 1;
    }
  }

  int32_t best = local ? 0 : NEG_INF32;
  int32_t bi = local ? 0 : qp;
  int32_t bj = local ? 0 : rp;
  int32_t bm = 0, bs = 0, bl = 0;
  int32_t hmax = 0, hmin = 0;

  for (int32_t i = 0; i < qlen; ++i) {
    const int32_t qi = qidx ? qidx[i] : i;
    const bool qok = !qidx || (qi >= 0 && qi < A);
    const int32_t* srow = rows + (int64_t)(qok ? qi : 0) * A;
    const bool last_row = i == qlen - 1;
    // candidates of this row: every cell, or only its last column
    const bool row_all = local || (last_row && qe);
    const bool row_last = last_row || de;

    // H[i][0] and H[i+1][0] of the bordered grid
    int32_t h_diag = kBanded ? band_border(i, db, open, ext, bw)
                             : border(i, db, open, ext);
    int32_t h_left = kBanded ? band_border(i + 1, db, open, ext, bw)
                             : border(i + 1, db, open, ext);
    int32_t lo = 0, hi = rlen;                      // this row's [lo, hi)
    if constexpr (kBandOnly) {
      lo = imax(0, i - bw);
      hi = imin(rlen, i + bw + 1);
      if (lo >= hi) continue;
      if (lo > 0) {
        h_diag = hrow[(lo - 1) * stride];
        h_left = NEG_INF32;
      }
    }
    int32_t f = NEG_INF32;
    // stats: payloads of the diagonal, the cell to the left and F
    Pay dp{0, 0, db ? 0 : i};
    Pay lp{0, 0, db ? 0 : i + 1};
    Pay fp{0, 0, 0};
    int32_t mqi = 0;
    if constexpr (O::stats) mqi = io.mq[i];
    for (int32_t j = lo; j < hi; ++j) {
      const int32_t r = ridx[j];
      const int32_t s = (qok && r >= 0 && r < A) ? srow[r] : 0;
      const int32_t h_up = hrow[j * stride];
      const int32_t e_up = erow[j * stride];
      int32_t h, e;
      int32_t hm = 0, hs = 0, hl = 0;
      if constexpr (O::trace) {
        trace[i * tsi + j * tsj] = (int8_t)cell_trace(
            h_diag, h_up, e_up, h_left, s, open, ext, local, f, h, e);
      } else if constexpr (O::stats) {
        // all six payload loads issue together, beside H's and E's, so
        // a cell waits for one round trip to the rows, not two
        const int64_t o = j * stride;
        const Pay up{HM[o], HS[o], HL[o]};
        const Pay eup{EM[o], ES[o], EL[o]};
        Pay hp, ep;
        cell_stats(h_diag, h_up, e_up, h_left, s, open, ext, local, mqi == r,
                   up, eup, lp, dp, fp, f, h, e, hp, ep);
        hm = hp.m;
        hs = hp.s;
        hl = hp.l;
        HM[o] = hp.m;
        HS[o] = hp.s;
        HL[o] = hp.l;
        EM[o] = ep.m;
        ES[o] = ep.s;
        EL[o] = ep.l;
        dp = up;
        lp = hp;
      } else {
        cell(h_diag, h_up, e_up, h_left, s, open, ext, local, f, h, e);
      }
      if constexpr (kMasked) {
        if (i - j > bw || j - i > bw) h = e = f = NEG_INF32;
      }
      if constexpr (O::table) {
        const int64_t t = i * tsi + j * tsj;
        io.table[t] = h;
        if constexpr (O::stats) {
          io.table[io.tab_plane + t] = hm;
          io.table[2 * io.tab_plane + t] = hs;
          io.table[3 * io.tab_plane + t] = hl;
        }
      }
      if constexpr (O::rowcol) {
        if (last_row) {
          const int64_t t = j * stride;
          io.row[t] = h;
          if constexpr (O::stats) {
            io.row[io.row_plane + t] = hm;
            io.row[2 * io.row_plane + t] = hs;
            io.row[3 * io.row_plane + t] = hl;
          }
        }
        if (j == rlen - 1) {
          const int64_t t = i * stride;
          io.col[t] = h;
          if constexpr (O::stats) {
            io.col[io.col_plane + t] = hm;
            io.col[2 * io.col_plane + t] = hs;
            io.col[3 * io.col_plane + t] = hl;
          }
        }
      }
      hrow[j * stride] = h;
      erow[j * stride] = e;
      h_diag = h_up;
      h_left = h;
      hmax = imax(hmax, h);
      hmin = imin(hmin, h);
      const bool cand = row_all || (row_last && j == rlen - 1);
      if (cand && h > best) {
        best = h;
        bi = i;
        bj = j;
        if constexpr (O::stats) {
          bm = hm;
          bs = hs;
          bl = hl;
        }
      }
    }
  }

  PairResult out;
  out.score = best;
  out.end_query = mode == MODE_NW ? qlen - 1 : bi;
  out.end_ref = mode == MODE_NW ? rlen - 1 : bj;
  out.sat8 = (hmax >= W8_MAX || hmin <= W8_MIN) ? 1 : 0;
  out.sat16 = (hmax >= W16_MAX || hmin <= W16_MIN) ? 1 : 0;
  if constexpr (kBandOnly) {
    // the plain version counts every in-sequence cell outside the band as
    // H = NEG_INF32: there is one when the far corner of the longer side,
    // (qlen - 1, 0) or (0, rlen - 1), lies outside
    if (qlen > 0 && rlen > 0 && imax(qlen, rlen) - 1 > bw)
      out.sat8 = out.sat16 = 1;
  }
  out.matches = bm;
  out.similar = bs;
  out.length = bl;
  return out;
}

// Pair b of a padded batch: picks its substitution rows, letters and
// lengths (clamped to the padded sizes) and sweeps it.
//
//   subs:  the (A, A) table (table form) or (Bq, Qp, A) profile rows
//   table: where to read the table from (subs, or a shared-memory copy)
//   qidx:  (Bq, Qp) query letters; null selects the profile form
//   trace: OUT_TRACE only: pair b's cell (0, 0), strides tsi and tsj
//   io:    pair b's rows and planes (its `mq` the pair's letters)
//   bw:    kBanded only: the band's half-width, in [-1, Qp + Rp]
template <int32_t kOut, bool kBanded = false>
PT_HD PairResult score_batch_pair(int32_t b, const int32_t* subs,
                                  const int32_t* table, const int32_t* qidx,
                                  const int32_t* ridx, const int32_t* qlen,
                                  const int32_t* rlen, int32_t* hrow,
                                  int32_t* erow, int64_t stride, int32_t Bq,
                                  int32_t Qp, int32_t Rp, int32_t A,
                                  int32_t open, int32_t ext, int32_t mode,
                                  int32_t free_bits, int8_t* trace,
                                  int64_t tsi, int64_t tsj,
                                  const PlaneIO& io, int32_t bw = 0) {
  const int64_t bq = Bq == 1 ? 0 : b;
  const int32_t* rows = qidx ? table : subs + bq * Qp * A;
  const int32_t* q = qidx ? qidx + bq * Qp : nullptr;
  return score_pair<kOut, kBanded>(rows, q, A, ridx + (int64_t)b * Rp,
                                   imin(qlen[b], Qp), imin(rlen[b], Rp), Qp,
                                   Rp, hrow, erow, stride, open, ext, mode,
                                   free_bits, trace, tsi, tsj, io, bw);
}

// A band's half-width clamped to [-1, Qp + Rp]: the same cells and
// borders as any wider or more negative value, and no int32 overflow in
// i + bw + 1.
PT_HD int32_t clamp_band(int32_t bw, int32_t Qp, int32_t Rp) {
  return imin(imax(bw, -1), Qp + Rp);
}

// ---------------------------------------------------------------------------
// The segment form (kernel K2): columns [off, off + Rseg) of a pair, with
// the sweep's state carried in and out, so a pair of any length runs as a
// chain of calls (the TPU package's scan_score_segment, scan_kernel.py:1528).
//
// State of a pair, after the segment that ends at column c_end (the last
// column the pair has had so far, min(off + Rseg, rlen) - 1):
//   h[i], f[i]      H[i][c_end] and F[i][c_end] of every query row i < qlen
//   stats           the payloads of h[i] (m, s, l) and of f[i] (m, s, l)
//   acc[8]          best, its i and j, max and min of H over the cells so
//                   far (the extremes behind the width-8/16 flags), and the
//                   best cell's m, s, l
// The first segment (resume = false) starts from the bordered left column
// and F = -inf.  A segment beyond the pair's rlen leaves its state alone.
//
// The cells are swept by 32 lanes, one query row each, in stripes of 32
// rows; lane l runs one column behind lane l - 1, so what a cell needs
// from the row above (H, E and their payloads) is what that lane computed
// one step earlier.  SegLane is one lane's registers, seg_cell one cell of
// it: every value, flag and payload comes from cell / cell_trace /
// cell_stats above, so the tie rules are the one-shot form's.  The CUDA
// kernel (scan_segment.cu) moves the values between lanes by warp shuffle;
// segment_pair_host below steps the same lanes in a loop for the CPU tests.
//
// The end cell is the first maximum in row-major order over the WHOLE pair,
// but cells arrive neither in row-major order (rows run in parallel) nor
// all in one call.  So a lane keeps the first maximum of its own rows in
// this segment (rows and then columns ascend there, so a strictly larger H
// wins), the lanes reduce with seg_better (H descending, i ascending, j
// ascending), and the segment's best replaces the carried one by the same
// rule.

constexpr int32_t SEG_LANES = 32;

// Is candidate (h, i, j) ahead of (bh, bi, bj) in the end cell's order?
PT_HD bool seg_better(int32_t h, int32_t i, int32_t j, int32_t bh, int32_t bi,
                      int32_t bj) {
  return h > bh || (h == bh && (i < bi || (i == bi && j < bj)));
}

// What the row below reads of a cell: H and E, and their payloads.
struct SegUp {
  int32_t h = NEG_INF32, e = NEG_INF32;
  Pay hp{0, 0, 0}, ep{0, 0, 0};
};

// A SegUp kept as rows `stride` apart, column k: H, E, and for the stats
// forms their six payloads (the kernel's ring and scratch rows).
template <int32_t kOut>
PT_HD SegUp seg_up_load(const int32_t* rows, int32_t stride, int32_t k) {
  SegUp u;
  u.h = rows[k];
  u.e = rows[stride + k];
  if constexpr (Out<kOut>::stats) {
    u.hp = Pay{rows[2 * stride + k], rows[3 * stride + k],
               rows[4 * stride + k]};
    u.ep = Pay{rows[5 * stride + k], rows[6 * stride + k],
               rows[7 * stride + k]};
  }
  return u;
}

template <int32_t kOut>
PT_HD void seg_up_store(int32_t* rows, int32_t stride, int32_t k,
                        const SegUp& u) {
  rows[k] = u.h;
  rows[stride + k] = u.e;
  if constexpr (Out<kOut>::stats) {
    rows[2 * stride + k] = u.hp.m;
    rows[3 * stride + k] = u.hp.s;
    rows[4 * stride + k] = u.hp.l;
    rows[5 * stride + k] = u.ep.m;
    rows[6 * stride + k] = u.ep.s;
    rows[7 * stride + k] = u.ep.l;
  }
}

// A pair's configuration for one segment.
struct SegPair {
  int32_t qlen, rlen;      // global lengths (qlen clamped to qp)
  int32_t qp;              // padded query length
  int32_t off;             // global column of the segment's first column
  int32_t ncols;           // this pair's columns in the segment (may be 0)
  int32_t open, ext;
  bool local, qb, qe, db, de;
  bool resume;
  int32_t A;
  // the rows swept, [row_lo, row_hi): the pair's rows in the segment form,
  // the tile's in the tile form, whose state buffers start at row_lo
  int32_t row_lo, row_hi;
  bool tile;               // the tile form (kernel K3), see below
  int32_t down_row;        // tile: the row handed to the tile below, else -1
};

PT_HD SegPair seg_pair(int32_t qlen, int32_t rlen, int32_t qp, int32_t off,
                       int32_t rseg, int32_t open, int32_t ext, int32_t mode,
                       int32_t free_bits, bool resume, int32_t A) {
  SegPair p;
  p.qlen = imin(qlen, qp);
  p.rlen = rlen;
  p.qp = qp;
  p.off = off;
  p.ncols = imax(0, imin(rseg, rlen - off));
  p.open = open;
  p.ext = ext;
  p.local = mode == MODE_SW;
  p.qb = p.local || (free_bits & FREE_QB);
  p.db = p.local || (free_bits & FREE_DB);
  p.qe = mode == MODE_SG && (free_bits & FREE_QE);
  p.de = mode == MODE_SG && (free_bits & FREE_DE);
  p.resume = resume;
  p.A = A;
  p.row_lo = 0;
  p.row_hi = p.qlen;
  p.tile = false;
  p.down_row = -1;
  return p;
}

// The top border above column jg (global): H[-1][jg], E = -inf, and the
// border's payload (0, 0, characters consumed unless free).
PT_HD SegUp seg_top(const SegPair& p, int32_t jg) {
  SegUp u;
  u.h = border(jg + 1, p.qb, p.open, p.ext);
  u.hp.l = p.qb ? 0 : jg + 1;
  return u;
}

// A lane's best cell and extremes over its rows in this segment.
struct SegBest {
  int32_t h, i, j;
  Pay p{0, 0, 0};
  int32_t hmax = 0, hmin = 0;
};

PT_HD SegBest seg_best_init(const SegPair& p) {
  SegBest b;
  b.h = p.local ? 0 : NEG_INF32;
  b.i = p.local ? BIG : p.qp;
  b.j = BIG;
  return b;
}

// (a, b) -> the one ahead in the end cell's order, extremes merged.
PT_HD SegBest seg_merge(const SegBest& a, const SegBest& b) {
  SegBest r = seg_better(b.h, b.i, b.j, a.h, a.i, a.j) ? b : a;
  r.hmax = imax(a.hmax, b.hmax);
  r.hmin = imin(a.hmin, b.hmin);
  return r;
}

// One lane: query row i of the current stripe.
template <int32_t kOut>
struct SegLane {
  int32_t i = 0;
  bool on = false;                 // i < qlen
  const int32_t* srow = nullptr;   // the row's substitution scores
  bool qok = false;
  int32_t mqi = 0;                 // stats: the row's letter
  bool row_all = false, row_last = false;   // the row's candidates
  int32_t h_left = 0, f = NEG_INF32, h_diag = 0;
  Pay lp{0, 0, 0}, fp{0, 0, 0}, dp{0, 0, 0};
  SegUp out;                       // the last cell computed
  SegBest best;
};

// Start row i: its substitution row, its candidates, and the boundary
// column left of the segment (the carried state, or the bordered left
// column).  `old` receives H[i][off-1] and its payload as they were
// before this segment: the row below needs them as its first diagonal.
template <int32_t kOut>
PT_HD void seg_row_begin(SegLane<kOut>& L, const SegPair& p, int32_t i,
                         const int32_t* rows, const int32_t* q,
                         const int32_t* mq, const int32_t* st_h,
                         const int32_t* st_f, const int32_t* st_pay,
                         int64_t pay_plane, SegUp& old) {
  using O = Out<kOut>;
  L.i = i;
  L.on = i < p.row_hi;
  old = SegUp();
  if (!L.on) return;
  const int32_t k = i - p.row_lo;          // the row in the state buffers
  const int32_t qi = q ? q[i] : i;
  L.qok = !q || (qi >= 0 && qi < p.A);
  L.srow = rows + (int64_t)(L.qok ? qi : 0) * p.A;
  if constexpr (O::stats) L.mqi = mq[i];
  const bool last_row = i == p.qlen - 1;
  L.row_all = p.local || (last_row && p.qe);
  L.row_last = last_row || p.de;
  if (p.resume) {
    L.h_left = st_h[k];
    L.f = st_f[k];
    if constexpr (O::stats) {
      L.lp = Pay{st_pay[k], st_pay[pay_plane + k], st_pay[2 * pay_plane + k]};
      L.fp = Pay{st_pay[3 * pay_plane + k], st_pay[4 * pay_plane + k],
                 st_pay[5 * pay_plane + k]};
    }
  } else {
    L.h_left = border(i + 1, p.db, p.open, p.ext);
    L.f = NEG_INF32;
    L.lp = Pay{0, 0, p.db ? 0 : i + 1};
    L.fp = Pay{0, 0, 0};
  }
  old.h = L.h_left;
  old.hp = L.lp;
}

// The plane forms' outputs of one pair in the block kernel (the chunked
// form, kernel K1f): plane k of the table holds cell (i, j) at
// [k * tab_plane + j * qp + i], query-fastest, so that a warp's 32 rows at
// one column are one run of 128 bytes; element j of the last row sits at
// [k * row_plane + j], element i of the last column at [k * col_plane + i].
// Plane k is 0 score, 1 matches, 2 similar, 3 length.
struct SegPlanes {
  int32_t* table = nullptr;      // table forms
  int64_t tab_plane = 0;
  int32_t* row = nullptr;        // rowcol forms: the last row
  int64_t row_plane = 0;
  int32_t* col = nullptr;        // rowcol forms: the last column
  int64_t col_plane = 0;
};

// The first diagonal of a row: H[i-1][off-1] and its payload, taken from
// the row above's `old` (row -1: the top border left of the segment).
template <int32_t kOut>
PT_HD void seg_row_diag(SegLane<kOut>& L, const SegUp& above) {
  L.h_diag = above.h;
  L.dp = above.hp;
}

PT_HD SegUp seg_corner(const SegPair& p) {
  SegUp u;
  u.h = border(p.off, p.qb, p.open, p.ext);
  u.hp.l = p.qb ? 0 : p.off;
  return u;
}

// The row's substitution score against reference letter r.
template <int32_t kOut>
PT_HD int32_t seg_score(const SegLane<kOut>& L, const SegPair& p, int32_t r) {
  return (L.qok && r >= 0 && r < p.A) ? L.srow[r] : 0;
}

// One cell: row L.i, local column c (global off + c), reference letter r
// and its score s = seg_score(L, p, r), `up` from the row above.  Writes
// the cell's flags (trace form), its H and payload into the planes (table
// forms; rowcol forms: on the pair's last row and last column), the row's
// state at the pair's last column of the segment, and the lane's best;
// leaves the cell in L.out.
template <int32_t kOut>
PT_HD void seg_cell(SegLane<kOut>& L, const SegPair& p, int32_t c, int32_t r,
                    int32_t s, const SegUp& up, int8_t* trace_row,
                    int32_t* st_h, int32_t* st_f, int32_t* st_pay,
                    int64_t pay_plane, const SegPlanes& pl = SegPlanes()) {
  using O = Out<kOut>;
  int32_t h, e;
  Pay hp{0, 0, 0}, ep{0, 0, 0};
  if constexpr (O::trace) {
    trace_row[c] = (int8_t)cell_trace(L.h_diag, up.h, up.e, L.h_left, s,
                                      p.open, p.ext, p.local, L.f, h, e);
  } else if constexpr (O::stats) {
    cell_stats(L.h_diag, up.h, up.e, L.h_left, s, p.open, p.ext, p.local,
               L.mqi == r, up.hp, up.ep, L.lp, L.dp, L.fp, L.f, h, e, hp, ep);
    L.dp = up.hp;
    L.lp = hp;
  } else {
    cell(L.h_diag, up.h, up.e, L.h_left, s, p.open, p.ext, p.local, L.f, h,
         e);
  }
  L.h_diag = up.h;
  L.h_left = h;
  L.out.h = h;
  L.out.e = e;
  L.out.hp = hp;
  L.out.ep = ep;
  L.best.hmax = imax(L.best.hmax, h);
  L.best.hmin = imin(L.best.hmin, h);
  const int32_t jg = p.off + c;
  if constexpr (O::table) {
    const int64_t t = (int64_t)jg * p.qp + L.i;
    pl.table[t] = h;
    if constexpr (O::stats) {
      pl.table[pl.tab_plane + t] = hp.m;
      pl.table[2 * pl.tab_plane + t] = hp.s;
      pl.table[3 * pl.tab_plane + t] = hp.l;
    }
  }
  if constexpr (O::rowcol) {
    if (L.i == p.qlen - 1) {
      pl.row[jg] = h;
      if constexpr (O::stats) {
        pl.row[pl.row_plane + jg] = hp.m;
        pl.row[2 * pl.row_plane + jg] = hp.s;
        pl.row[3 * pl.row_plane + jg] = hp.l;
      }
    }
    if (jg == p.rlen - 1) {
      pl.col[L.i] = h;
      if constexpr (O::stats) {
        pl.col[pl.col_plane + L.i] = hp.m;
        pl.col[2 * pl.col_plane + L.i] = hp.s;
        pl.col[3 * pl.col_plane + L.i] = hp.l;
      }
    }
  }
  const bool cand = L.row_all || (L.row_last && jg == p.rlen - 1);
  if (cand && h > L.best.h) {
    L.best.h = h;
    L.best.i = L.i;
    L.best.j = jg;
    L.best.p = hp;
  }
  if (c == p.ncols - 1) {
    const int32_t k = L.i - p.row_lo;
    st_h[k] = h;
    st_f[k] = L.f;
    if constexpr (O::stats) {
      st_pay[k] = hp.m;
      st_pay[pay_plane + k] = hp.s;
      st_pay[2 * pay_plane + k] = hp.l;
      st_pay[3 * pay_plane + k] = L.fp.m;
      st_pay[4 * pay_plane + k] = L.fp.s;
      st_pay[5 * pay_plane + k] = L.fp.l;
    }
  }
}

// Fold the segment's best into the carried accumulator `acc` (8 values;
// initialised here when !resume) and derive the pair's outputs from it,
// as score_pair's: the SW clamp is the accumulator's initial (0, 0, 0),
// NW ends at (qlen - 1, rlen - 1), and a non-local pair with an empty side
// takes empty_side(), decided from the global lengths.
template <int32_t kOut>
PT_HD PairResult seg_finish(const SegPair& p, int32_t mode,
                            const SegBest& seg, int32_t* acc) {
  using O = Out<kOut>;
  if (!p.local && (p.qlen == 0 || p.rlen == 0)) {
    if (!p.resume)
      for (int32_t k = 0; k < 8; ++k) acc[k] = 0;
    return empty_side(p.qlen, p.rlen, p.open, p.ext, p.qb, p.qe, p.db, p.de);
  }
  SegBest a;
  if (p.resume) {
    a.h = acc[0];
    a.i = acc[1];
    a.j = acc[2];
    a.hmax = acc[3];
    a.hmin = acc[4];
    a.p = Pay{acc[5], acc[6], acc[7]};
  } else {
    a.h = p.local ? 0 : NEG_INF32;
    a.i = p.local ? 0 : p.qp;
    a.j = p.local ? 0 : BIG;
  }
  a = seg_merge(a, seg);
  acc[0] = a.h;
  acc[1] = a.i;
  acc[2] = a.j;
  acc[3] = a.hmax;
  acc[4] = a.hmin;
  acc[5] = a.p.m;
  acc[6] = a.p.s;
  acc[7] = a.p.l;
  PairResult out;
  out.score = a.h;
  out.end_query = mode == MODE_NW ? p.qlen - 1 : a.i;
  out.end_ref = mode == MODE_NW ? p.rlen - 1 : a.j;
  out.sat8 = (a.hmax >= W8_MAX || a.hmin <= W8_MIN) ? 1 : 0;
  out.sat16 = (a.hmax >= W16_MAX || a.hmin <= W16_MIN) ? 1 : 0;
  out.matches = O::stats ? a.p.m : 0;
  out.similar = O::stats ? a.p.s : 0;
  out.length = O::stats ? a.p.l : 0;
  return out;
}

// Several warps on a pair: a block's warps take SEG_LANES rows each, one
// group of rows after another.  Warp w runs SEG_LAG steps behind warp
// w - 1, whose last lane's row it reads from a ring of SEG_RING columns:
// a column is written a whole round of SEG_LANES steps (one block
// barrier) before it is read, and a slot is reused another round after.
constexpr int32_t SEG_LAG = 2 * SEG_LANES;
constexpr int32_t SEG_RING = 4 * SEG_LANES;

// Warp w's own step at the group's step g.  Step -1 only fetches ahead.
PT_HD int32_t seg_local_step(int32_t g, int32_t w) {
  return g - SEG_LAG * w - 1;
}

// Steps a group of rows takes when `nw` of its warps have rows: the last
// warp starts SEG_LAG * (nw - 1) + 1 steps in and sweeps ncols columns
// with up to SEG_LANES lanes.
PT_HD int32_t seg_group_steps(int32_t ncols, int32_t nw) {
  return SEG_LAG * (nw - 1) + 1 + ncols + SEG_LANES - 1;
}

// Does the pair sweep any cell in this segment?
PT_HD bool seg_sweeps(const SegPair& p) {
  return p.row_hi > p.row_lo && p.ncols > 0;
}

// ---------------------------------------------------------------------------
// The tile form (kernel K3): query rows [r0, r0 + qc) by columns
// [off, off + C) of a pair, one tile of a sequence-parallel fill (the TPU
// package's scan_rowseg_step, scan_kernel.py:1737).  It is the segment form
// with a row range and with every border a read:
//
//   left    the right-going state of the tile to the left, rows [r0, r0+qc):
//           h, f (and the stats payloads), in buffers that start at row r0;
//           the caller fills them with the bordered left column at off == 0
//   above   the down-state of the tile above, per column: H and E of row
//           r0 - 1 (and their payloads), in the layout of the segment
//           form's scratch row; the caller fills it with the top border at
//           r0 == 0.  The tile leaves there the same of row r0 + qc - 1, for
//           the tile below, from whichever lane holds that row.  (The TPU
//           kernel carries a prefix-max seed instead of E: it computes E by
//           a prefix scan, this cell by the literal recurrence.)
//   corner  H[r0-1][off-1] and its payload, four words `t`: what the tile
//           to the left read above its last column, which it hands on as it
//           was before it swept (t_out = the down-state in at column C - 1)
//   acc     the accumulator of this column shard, folded over its tiles;
//           shards are merged by the caller, by seg_better
//
// Lanes hold global row indices, so the candidate rules, the empty-side
// rule and the state's meaning are the segment form's.

PT_HD SegPair tile_pair(int32_t qlen, int32_t rlen, int32_t qp, int32_t r0,
                        int32_t qc, int32_t off, int32_t cols, int32_t open,
                        int32_t ext, int32_t mode, int32_t free_bits,
                        int32_t A) {
  SegPair p = seg_pair(qlen, rlen, qp, off, cols, open, ext, mode, free_bits,
                       true, A);
  p.tile = true;
  p.row_lo = r0;
  p.row_hi = imax(r0, imin(r0 + qc, p.qlen));
  p.down_row = r0 + qc - 1;
  return p;
}

// The corner of a tile from its four words, and the four words a tile
// hands to its right neighbour: the down-state in at its last column.
PT_HD SegUp tile_corner(const int32_t* t) {
  SegUp u;
  u.h = t[0];
  u.hp = Pay{t[1], t[2], t[3]};
  return u;
}

template <int32_t kOut>
PT_HD void tile_corner_out(const int32_t* down, int32_t cols, int32_t* t) {
  const SegUp u = seg_up_load<kOut>(down, cols, cols - 1);
  t[0] = u.h;
  t[1] = u.hp.m;
  t[2] = u.hp.s;
  t[3] = u.hp.l;
}

#if !defined(__CUDACC__)
// One pair's segment on the host: the kernel's lanes stepped in a loop.
// `warps` warps of SEG_LANES lanes take SEG_LANES * warps rows abreast, as
// the kernel's block does: warp w runs SEG_LAG steps behind warp w - 1 and
// reads its last lane's row from a ring of SEG_RING columns (the kernel's
// shared memory); warps and lanes are stepped last first, so each reads
// what the one above left earlier.
//
//   rows, q, mq: as score_pair's rows and qidx, and PlaneIO::mq
//   ridx_seg:    the segment's reference letters (Rseg of them)
//   bottom:      scratch, 8 rows of Rseg: the last row of each group of
//                SEG_LANES * warps rows (H, E, and their payloads) for
//                the next group
//   st_h, st_f:  the pair's state rows (qp each), updated in place
//   st_pay:      stats: its six payload rows, `pay_plane` apart
//   acc:         its accumulator (8)
//   trace:       trace form: the pair's (qp, rseg) flags of this segment
//
// The tile form (p.tile): `down` is the down-state, read above the tile's
// first row and left holding the tile's last row; the state rows and
// `trace` start at row p.row_lo; `t_in` / `t_out` are the corner words.
// The plane forms (the chunked form): `pl` is the pair's SegPlanes.
template <int32_t kOut>
inline PairResult segment_pair_host(const int32_t* rows, const int32_t* q,
                                    const int32_t* mq,
                                    const int32_t* ridx_seg, int32_t rseg,
                                    const SegPair& p, int32_t mode,
                                    int32_t* bottom, int32_t* st_h,
                                    int32_t* st_f, int32_t* st_pay,
                                    int64_t pay_plane, int32_t* acc,
                                    int8_t* trace, int32_t warps = 1,
                                    int32_t* down = nullptr,
                                    const int32_t* t_in = nullptr,
                                    int32_t* t_out = nullptr,
                                    const SegPlanes& pl = SegPlanes()) {
  using O = Out<kOut>;
  constexpr int32_t W = SEG_LANES;
  SegBest total = seg_best_init(p);
  if (p.tile) tile_corner_out<kOut>(down, rseg, t_out);
  if (seg_sweeps(p)) {
    std::vector<SegLane<kOut>> lanes(warps * W);
    std::vector<SegUp> old(warps * W);
    std::vector<SegUp> ring((int64_t)warps * SEG_RING);
    for (auto& L : lanes) L.best = seg_best_init(p);
    // the row above's H left of the segment (or tile)
    SegUp carry = p.tile ? tile_corner(t_in) : seg_corner(p);
    const int32_t group = warps * W;
    for (int32_t i0 = p.row_lo; i0 < p.row_hi; i0 += group) {
      for (int32_t k = 0; k < group; ++k)
        seg_row_begin(lanes[k], p, i0 + k, rows, q, mq, st_h, st_f, st_pay,
                      pay_plane, old[k]);
      for (int32_t k = 0; k < group; ++k)
        seg_row_diag(lanes[k], k == 0 ? carry : old[k - 1]);
      carry = old[group - 1];
      const int32_t nrows = imin(group, p.row_hi - i0);
      const int32_t nw = (nrows + W - 1) / W;       // warps with rows
      const bool feeds = i0 + group < p.row_hi;     // a group follows
      const int32_t total_steps = seg_group_steps(p.ncols, nw);
      for (int32_t g = 0; g < total_steps; ++g) {
        for (int32_t w = nw - 1; w >= 0; --w) {
          const int32_t t = seg_local_step(g, w);
          const int32_t nl = imin(W, nrows - w * W);
          if (t < 0 || t >= p.ncols + nl - 1) continue;
          for (int32_t l = nl - 1; l >= 0; --l) {
            const int32_t c = t - l;
            if (c < 0 || c >= p.ncols) continue;
            SegUp up;
            if (l > 0) {
              up = lanes[w * W + l - 1].out;
            } else if (w > 0) {
              up = ring[(int64_t)(w - 1) * SEG_RING + c % SEG_RING];
            } else if (i0 == p.row_lo) {
              up = p.tile ? seg_up_load<kOut>(down, rseg, c)
                          : seg_top(p, p.off + c);
            } else {
              up = seg_up_load<kOut>(bottom, rseg, c);
            }
            SegLane<kOut>& L = lanes[w * W + l];
            const int32_t r = ridx_seg[c];
            seg_cell(L, p, c, r, seg_score(L, p, r), up,
                     O::trace ? trace + (int64_t)(L.i - p.row_lo) * rseg
                              : nullptr,
                     st_h, st_f, st_pay, pay_plane, pl);
            if (l == W - 1 && w < warps - 1)
              ring[(int64_t)w * SEG_RING + c % SEG_RING] = L.out;
            if (l == W - 1 && w == warps - 1 && feeds)
              seg_up_store<kOut>(bottom, rseg, c, L.out);
            if (L.i == p.down_row) seg_up_store<kOut>(down, rseg, c, L.out);
          }
        }
      }
    }
    for (const auto& L : lanes) total = seg_merge(total, L.best);
  }
  return seg_finish<kOut>(p, mode, total, acc);
}
#endif

}  // namespace ptscore
