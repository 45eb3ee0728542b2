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
// The trace form (kTrace) also writes each cell's flags hflag | eflag |
// fflag, bit for bit with golden/model.py:166-211: eflag DIAG_E when
// H[i-1][j] - open >= E[i-1][j] - ext (else INS_E), fflag DIAG_F when
// H[i][j-1] - open >= F[i][j-1] - ext (else DEL_F), hflag DIAG when the
// unclamped diagonal is >= E and >= F, else INS when E >= F, else DEL;
// in SW a cell with max(diag, E, F) <= 0 gets hflag 0 and keeps its E
// and F bits.  The score form compiles without any of it.
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

struct PairResult {
  int32_t score;
  int32_t end_query;
  int32_t end_ref;
  int32_t sat8;
  int32_t sat16;
};

PT_HD int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
PT_HD int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }

// Bordered H at c consumed characters (top_b / left_b of the TPU kernel).
PT_HD int32_t border(int32_t c, bool is_free, int32_t open, int32_t ext) {
  return (is_free || c <= 0) ? 0 : -(open + (c - 1) * ext);
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
// cells if qe (qlen == 0) or the left column's if de (rlen == 0).
PT_HD PairResult empty_side(int32_t qlen, int32_t rlen, int32_t open,
                            int32_t ext, bool qb, bool qe, bool db,
                            bool de) {
  PairResult out{0, qlen - 1, rlen - 1, 0, 0};
  const int32_t n = qlen == 0 ? rlen : qlen;
  const bool is_free = qlen == 0 ? qb : db;
  const bool end_free = qlen == 0 ? qe : de;
  int32_t best = NEG_INF32, at = n;
  for (int32_t c = 1; c <= n; ++c) {
    const int32_t v = border(c, is_free, open, ext);
    if ((end_free || c == n) && v > best) {
      best = v;
      at = c;
    }
  }
  if (n > 0) {
    out.score = best;
    if (qlen == 0) out.end_ref = at - 1; else out.end_query = at - 1;
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
//   trace:  kTrace only: cell (i, j)'s flags go to trace[i * tsi + j * tsj].
template <bool kTrace>
PT_HD PairResult score_pair(const int32_t* rows, const int32_t* qidx,
                            int32_t A, const int32_t* ridx, int32_t qlen,
                            int32_t rlen, int32_t qp, int32_t* hrow,
                            int32_t* erow, int64_t stride, int32_t open,
                            int32_t ext, int32_t mode, int32_t free_bits,
                            int8_t* trace, int64_t tsi, int64_t tsj) {
  const bool local = mode == MODE_SW;
  const bool qb = local || (free_bits & FREE_QB);
  const bool db = local || (free_bits & FREE_DB);
  const bool qe = mode == MODE_SG && (free_bits & FREE_QE);
  const bool de = mode == MODE_SG && (free_bits & FREE_DE);
  if (!local && (qlen == 0 || rlen == 0))
    return empty_side(qlen, rlen, open, ext, qb, qe, db, de);

  // row "-1": the bordered top row H[0][j+1], E = -inf
  for (int32_t j = 0; j < rlen; ++j) {
    hrow[j * stride] = border(j + 1, qb, open, ext);
    erow[j * stride] = NEG_INF32;
  }

  int32_t best = local ? 0 : NEG_INF32;
  int32_t bi = local ? 0 : qp;
  int32_t bj = local ? 0 : BIG;
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
    int32_t f = NEG_INF32;
    for (int32_t j = 0; j < rlen; ++j) {
      const int32_t r = ridx[j];
      const int32_t s = (qok && r >= 0 && r < A) ? srow[r] : 0;
      const int32_t h_up = hrow[j * stride];
      const int32_t e_up = erow[j * stride];
      int32_t h, e;
      if constexpr (kTrace) {
        trace[i * tsi + j * tsj] = (int8_t)cell_trace(
            h_diag, h_up, e_up, h_left, s, open, ext, local, f, h, e);
      } else {
        cell(h_diag, h_up, e_up, h_left, s, open, ext, local, f, h, e);
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
      }
    }
  }

  PairResult out;
  out.score = best;
  out.end_query = mode == MODE_NW ? qlen - 1 : bi;
  out.end_ref = mode == MODE_NW ? rlen - 1 : bj;
  out.sat8 = (hmax >= W8_MAX || hmin <= W8_MIN) ? 1 : 0;
  out.sat16 = (hmax >= W16_MAX || hmin <= W16_MIN) ? 1 : 0;
  return out;
}

// Pair b of a padded batch: picks its substitution rows, letters and
// lengths (clamped to the padded sizes) and sweeps it.
//
//   subs:  the (A, A) table (table form) or (Bq, Qp, A) profile rows
//   table: where to read the table from (subs, or a shared-memory copy)
//   qidx:  (Bq, Qp) query letters; null selects the profile form
//   trace: kTrace only: pair b's cell (0, 0), strides tsi and tsj
template <bool kTrace>
PT_HD PairResult score_batch_pair(int32_t b, const int32_t* subs,
                                  const int32_t* table, const int32_t* qidx,
                                  const int32_t* ridx, const int32_t* qlen,
                                  const int32_t* rlen, int32_t* hrow,
                                  int32_t* erow, int64_t stride, int32_t Bq,
                                  int32_t Qp, int32_t Rp, int32_t A,
                                  int32_t open, int32_t ext, int32_t mode,
                                  int32_t free_bits, int8_t* trace,
                                  int64_t tsi, int64_t tsj) {
  const int64_t bq = Bq == 1 ? 0 : b;
  const int32_t* rows = qidx ? table : subs + bq * Qp * A;
  const int32_t* q = qidx ? qidx + bq * Qp : nullptr;
  return score_pair<kTrace>(rows, q, A, ridx + (int64_t)b * Rp,
                            imin(qlen[b], Qp), imin(rlen[b], Rp), Qp, hrow,
                            erow, stride, open, ext, mode, free_bits, trace,
                            tsi, tsj);
}

}  // namespace ptscore
