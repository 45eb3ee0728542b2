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
// The banded score form (kBanded, NW) sweeps only the cells with
// |i - j| <= bw and masks the borders beyond bw, as the TPU kernel's
// banded mode (scan_kernel.py:602-617, :722-725, :890-891); see
// score_pair.
//
// All arithmetic is exact int32 with NEG_INF32 = -2^30 as minus infinity,
// so NEG_INF32 - open - ext cannot wrap.
#pragma once

#include <stdint.h>

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

// End cell of a non-local pair with qlen == 0 or rlen == 0 (golden's
// candidates, value desc then (i, j) asc): the corner, plus the top row's
// cells if qe (qlen == 0) or the left column's if de (rlen == 0).  Its
// payload is (0, 0, the characters consumed, or 0 on a free border).
// Banded (NW only), a border cell beyond bw is -inf, so a side longer
// than the band scores NEG_INF32, as golden's banded_nw_fill.
template <bool kBanded = false>
PT_HD PairResult empty_side(int32_t qlen, int32_t rlen, int32_t open,
                            int32_t ext, bool qb, bool qe, bool db,
                            bool de, int32_t bw = 0) {
  PairResult out{0, qlen - 1, rlen - 1, 0, 0, 0, 0, 0};
  const int32_t n = qlen == 0 ? rlen : qlen;
  const bool is_free = qlen == 0 ? qb : db;
  const bool end_free = qlen == 0 ? qe : de;
  int32_t best = NEG_INF32, at = n;
  for (int32_t c = 1; c <= n; ++c) {
    const int32_t v = kBanded ? band_border(c, is_free, open, ext, bw)
                              : border(c, is_free, open, ext);
    if ((end_free || c == n) && v > best) {
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
//   qp:     padded query length (the SG end row before any candidate).
//   trace:  OUT_TRACE only: cell (i, j)'s flags go to trace[i * tsi +
//           j * tsj]; the table forms write their planes at the same
//           strides.
//   io:     the stats, table and rowcol forms' rows and planes.
//
// kBanded (the banded score form, K1e; run as NW): only cells with
// |i - j| <= bw exist, so row i sweeps j in [max(0, i - bw),
// min(rlen - 1, i + bw)] and a pair costs O(qlen * (2 bw + 1)) cells.
// The edges give exactly what the plain version (the wavefront, which
// masks H, E and F outside the band and the borders beyond bw to
// NEG_INF32) gives: the top row starts as the masked border, so a cell
// right of row i - 1's band, never written, reads NEG_INF32; at a left
// edge lo > 0, H and F to the left are NEG_INF32 and the diagonal is row
// i - 1's H at lo - 1; column 0 reads the masked border.  In-band E and F
// keep the same unclamped int32 values (NEG_INF32 - open and so on).
// bw must lie in [-1, qp + rlen] (the caller clamps it).
template <int32_t kOut, bool kBanded = false>
PT_HD PairResult score_pair(const int32_t* rows, const int32_t* qidx,
                            int32_t A, const int32_t* ridx, int32_t qlen,
                            int32_t rlen, int32_t qp, int32_t* hrow,
                            int32_t* erow, int64_t stride, int32_t open,
                            int32_t ext, int32_t mode, int32_t free_bits,
                            int8_t* trace, int64_t tsi, int64_t tsj,
                            const PlaneIO& io, int32_t bw = 0) {
  static_assert(!kBanded || kOut == OUT_SCORE, "banded: score form only");
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
  int32_t bj = local ? 0 : BIG;
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

    int32_t h_diag = border(i, db, open, ext);      // H[i][0] (bordered)
    int32_t h_left = border(i + 1, db, open, ext);  // H[i+1][0]
    int32_t lo = 0, hi = rlen;                      // this row's [lo, hi)
    if constexpr (kBanded) {
      lo = imax(0, i - bw);
      hi = imin(rlen, i + bw + 1);
      if (lo >= hi) continue;
      if (lo == 0) {
        h_diag = band_border(i, db, open, ext, bw);
        h_left = band_border(i + 1, db, open, ext, bw);
      } else {
        h_diag = hrow[(lo - 1) * stride];
        h_left = NEG_INF32;
      }
    }
    int32_t f = NEG_INF32;
    // stats: payloads of the diagonal, the cell to the left and F
    int32_t dm = 0, ds = 0, dl = db ? 0 : i;
    int32_t lm = 0, ls = 0, ll = db ? 0 : i + 1;
    int32_t fm = 0, fs = 0, fl = 0;
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
        const int32_t um = HM[o], us = HS[o], ul = HL[o];
        const int32_t pm = EM[o], ps = ES[o], pl = EL[o];
        const int32_t e_open = h_up - open, e_ext = e_up - ext;
        const int32_t f_open = h_left - open, f_ext = f - ext;
        e = imax(e_open, e_ext);
        f = imax(f_open, f_ext);
        const int32_t diag = h_diag + s;
        const int32_t v = imax(imax(diag, e), f);
        h = local ? imax(v, 0) : v;
        const bool e_opens = e_open >= e_ext;
        const int32_t em = e_opens ? um : pm;
        const int32_t es = e_opens ? us : ps;
        const int32_t el = (e_opens ? ul : pl) + 1;
        if (f_open >= f_ext) {
          fm = lm;
          fs = ls;
          fl = ll;
        }
        fl += 1;
        if (diag >= e && diag >= f) {
          hm = dm + (mqi == r ? 1 : 0);
          hs = ds + (s > 0 ? 1 : 0);
          hl = dl + 1;
        } else if (e >= f) {
          hm = em;
          hs = es;
          hl = el;
        } else {
          hm = fm;
          hs = fs;
          hl = fl;
        }
        if (local && v <= 0) hm = hs = hl = 0;
        HM[o] = hm;
        HS[o] = hs;
        HL[o] = hl;
        EM[o] = em;
        ES[o] = es;
        EL[o] = el;
        dm = um;
        ds = us;
        dl = ul;
        lm = hm;
        ls = hs;
        ll = hl;
      } else {
        cell(h_diag, h_up, e_up, h_left, s, open, ext, local, f, h, e);
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
  if constexpr (kBanded) {
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
                                   hrow, erow, stride, open, ext, mode,
                                   free_bits, trace, tsi, tsj, io, bw);
}

// A band's half-width clamped to [-1, Qp + Rp]: the same cells and
// borders as any wider or more negative value, and no int32 overflow in
// i + bw + 1.
PT_HD int32_t clamp_band(int32_t bw, int32_t Qp, int32_t Rp) {
  return imin(imax(bw, -1), Qp + Rp);
}

}  // namespace ptscore
