// Per-pair affine-gap (Gotoh) score sweep, shared by the CUDA kernels
// (scan_short.cuh, scan_banded.cu, segment_block.cuh) and the host harness
// the CPU tests build with g++.
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
// score form of score_pair (and the ring, below) sweeps only the band's
// cells; every other form sweeps every cell and masks, so that its flags
// and payloads outside the band are the plain version's; see score_pair.
// The card runs the masked sweep on the short form and the block kernel
// (their kBanded instantiations: band_out, seg_border).
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
#define PT_UNROLL _Pragma("unroll")
#else
#define PT_HD inline
#define PT_UNROLL
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

// Max-plus on Hopper's DPX instructions (sm_90: one instruction each);
// the same integer functions elsewhere, so the g++ build runs the same
// header.  addmax(a, b, c) = max(a + b, c), max3 / min3 of three values,
// max3_relu = max(a, b, c, 0), which is SW's clamp.
PT_HD int32_t addmax(int32_t a, int32_t b, int32_t c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __viaddmax_s32(a, b, c);
#else
  return imax(a + b, c);
#endif
}

PT_HD int32_t max3(int32_t a, int32_t b, int32_t c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __vimax3_s32(a, b, c);
#else
  return imax(imax(a, b), c);
#endif
}

PT_HD int32_t min3(int32_t a, int32_t b, int32_t c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __vimin3_s32(a, b, c);
#else
  return imin(imin(a, b), c);
#endif
}

PT_HD int32_t max3_relu(int32_t a, int32_t b, int32_t c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __vimax3_s32_relu(a, b, c);
#else
  return imax(imax(imax(a, b), c), 0);
#endif
}

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

// Does cell (i, j) lie outside the band of half-width bw?
PT_HD bool band_out(int32_t i, int32_t j, int32_t bw) {
  return i - j > bw || j - i > bw;
}

// One DP cell.  h_diag = H[i-1][j-1], h_up = H[i-1][j], e_up = E[i-1][j],
// h_left = H[i][j-1]; f carries F[i][j-1] in and F[i][j] out.
PT_HD void cell(int32_t h_diag, int32_t h_up, int32_t e_up, int32_t h_left,
                int32_t s, int32_t open, int32_t ext, bool local,
                int32_t& f, int32_t& h, int32_t& e) {
  e = addmax(h_up, -open, e_up - ext);
  f = addmax(h_left, -open, f - ext);
  h = local ? max3_relu(h_diag + s, e, f) : max3(h_diag + s, e, f);
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
  // local: h == 0 exactly when max(diag, e, f) <= 0
  h = local ? max3_relu(diag, e, f) : max3(diag, e, f);
  int32_t hflag = (diag >= e && diag >= f) ? TRACE_DIAG
                  : (e >= f ? TRACE_INS : TRACE_DEL);
  if (local && h == 0) hflag = 0;
  return hflag | (e_open >= e_ext ? TRACE_DIAG_E : TRACE_INS_E) |
         (f_open >= f_ext ? TRACE_DIAG_F : TRACE_DEL_F);
}

// A cell's payload (matches, similar, length), golden/model.py:152-209.
struct Pay {
  int32_t m, s, l;
};

// What the stats forms do to a payload: select it, add a step to its
// length (ext), add a diagonal step (diag: the length, and matches /
// similar by one where the letters match / the score is > 0), or zero it.
// PayOps keeps golden's three values apart; the short form packs them
// into one or two words (PackOps, Pack2Ops, below), where the same steps
// are additions to fields that cannot carry.
struct PayOps {
  using V = Pay;
  PT_HD V ext(V p) const {
    p.l += 1;
    return p;
  }
  PT_HD V diag(const V& p, bool match, bool sim) const {
    return Pay{p.m + (match ? 1 : 0), p.s + (sim ? 1 : 0), p.l + 1};
  }
  PT_HD V zero() const { return Pay{0, 0, 0}; }
};

// cell() plus golden's payloads, in the representation of `po`.  `up`
// and `eup` are the payloads of H[i-1][j] and E[i-1][j], `left` of
// H[i][j-1], `diag_p` of H[i-1][j-1]; `fp` carries F[i][j-1]'s in and
// F[i][j]'s out; `match` says whether the mapped letters are equal.  `hp`
// and `ep` receive H[i][j]'s and E[i][j]'s.  E and F take the opening
// cell's payload when open >= extend (golden's `>=`), H the diagonal's
// when diag >= E and diag >= F, else E's when E >= F, else F's; a local
// cell with max(diag, E, F) <= 0 zeroes its own.
template <class PO>
PT_HD void cell_stats_of(const PO& po, int32_t h_diag, int32_t h_up,
                         int32_t e_up, int32_t h_left, int32_t s, int32_t open,
                         int32_t ext, bool local, bool match,
                         const typename PO::V& up, const typename PO::V& eup,
                         const typename PO::V& left,
                         const typename PO::V& diag_p, typename PO::V& fp,
                         int32_t& f, int32_t& h, int32_t& e,
                         typename PO::V& hp, typename PO::V& ep) {
  const int32_t e_open = h_up - open, e_ext = e_up - ext;
  const int32_t f_open = h_left - open, f_ext = f - ext;
  e = imax(e_open, e_ext);
  f = imax(f_open, f_ext);
  const int32_t diag = h_diag + s;
  h = local ? max3_relu(diag, e, f) : max3(diag, e, f);
  ep = po.ext(e_open >= e_ext ? up : eup);
  fp = po.ext(f_open >= f_ext ? left : fp);
  if (diag >= e && diag >= f) {
    hp = po.diag(diag_p, match, s > 0);
  } else if (e >= f) {
    hp = ep;
  } else {
    hp = fp;
  }
  if (local && h == 0) hp = po.zero();
}

// cell_stats_of with golden's three values.
PT_HD void cell_stats(int32_t h_diag, int32_t h_up, int32_t e_up,
                      int32_t h_left, int32_t s, int32_t open, int32_t ext,
                      bool local, bool match, const Pay& up, const Pay& eup,
                      const Pay& left, const Pay& diag_p, Pay& fp, int32_t& f,
                      int32_t& h, int32_t& e, Pay& hp, Pay& ep) {
  cell_stats_of(PayOps(), h_diag, h_up, e_up, h_left, s, open, ext, local,
                match, up, eup, left, diag_p, fp, f, h, e, hp, ep);
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
// The cells are swept by lanes of 32, each holding kR consecutive query
// rows (kR = 2, 4 or 8; 8 only in the score and rowcol forms), in groups
// of rows; lane l runs one column behind lane l - 1.  At step t a lane
// computes column t - l of its kR rows, top to bottom: E runs down the
// rows in registers, each row's H to the left, F and diagonal stay in
// registers, and only the bottom row's cell (H, E and their payloads)
// reaches the lane below, one step later.  SegLane is one lane's registers, seg_lane_step one step of
// it: every value, flag and payload comes from cell / cell_trace /
// cell_stats above, so the tie rules are the one-shot form's.  The CUDA
// kernel (segment_block.cuh) moves the bottom row between lanes by warp
// shuffle; segment_pair_host below steps the same lanes in a loop for the
// CPU tests.
//
// The end cell is the first maximum in row-major order over the WHOLE pair,
// but cells arrive neither in row-major order nor all in one call.  A
// lane's cells arrive column by column, its rows top to bottom at each
// column, so (i + 1, c) comes before (i, c + 1): a lane takes a candidate
// on a larger H, or on an equal H in an earlier row, which for cells that
// arrive in this order is seg_better (H descending, i ascending, j
// ascending).  Lanes, warps and blocks reduce with seg_better, and the
// segment's best replaces the carried one by the same rule.

constexpr int32_t SEG_LANES = 32;

// Several warps on a pair: warp w of the pair's chain (the warps of its
// block, or of the blocks of its cluster one after another) runs SEG_LAG
// steps behind warp w - 1, whose last lane's bottom row it reads from a
// ring of SEG_RING columns.  A step is a column of every lane, whatever
// kR, so the lag and the ring are those of one row a lane: a column is
// written at least one round of SEG_LANES steps (one barrier of the
// pair's blocks) before it is read, and a slot is reused another round
// after.
constexpr int32_t SEG_LAG = 2 * SEG_LANES;
constexpr int32_t SEG_RING = 4 * SEG_LANES;
// The ring of the segment's reference letters a block stages ahead of its
// warps: they read at most SEG_LAG * 7 + 2 * SEG_LANES columns behind the
// newest.
constexpr int32_t SEG_LETTERS = 1024;

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
// forms their six payloads (the kernel's rings and scratch rows).
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
  // read only by the banded (masked) instantiations of the one-shot forms
  // (kBanded below): the band's half-width, in [-1, qp + rlen], and the
  // padded reference length, the end column of a non-local pair whose
  // every candidate lies outside the band (score_pair's (qp, rp))
  int32_t bw = 0, rp = 0;
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

// `p` with the band of half-width bw and the padded reference length rp,
// for the masked forms.
PT_HD SegPair with_band(SegPair p, int32_t bw, int32_t rp) {
  p.bw = bw;
  p.rp = rp;
  return p;
}

// A bordered H at c consumed characters of a pair: border(), or with
// kBanded (the masked one-shot forms, from column 0 only) band_border().
template <bool kBanded>
PT_HD int32_t seg_border(const SegPair& p, int32_t c, bool is_free) {
  if constexpr (kBanded) return band_border(c, is_free, p.open, p.ext, p.bw);
  return border(c, is_free, p.open, p.ext);
}

// The top border above column jg (global): H[-1][jg], E = -inf, and the
// border's payload (0, 0, characters consumed unless free; the masked
// forms mask H only, never a payload).
template <bool kBanded = false>
PT_HD SegUp seg_top(const SegPair& p, int32_t jg) {
  SegUp u;
  u.h = seg_border<kBanded>(p, jg + 1, p.qb);
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

// The substitution scores, as the kernel stages them in shared memory,
// with a last column of 0, so that a reference letter outside [0, A)
// reads 0 by its column (seg_col).  The table form stages the (A, A)
// table as A + 1 rows of A + 1 scores, row A all 0 (a query letter outside
// [0, A)); a row's scores start at so = row * (A + 1) and letter column c
// is so + c.  The profile form stages the profile rows of the query rows
// a block sweeps in a group, column by column: column c of staged row x
// sits at c * seg_prof_stride(n) + seg_pad(x), where the pad of a word
// every 32 rows puts the rows a warp's lanes read at one step (32 rows kR
// apart) in 32 banks; a row's scores start at so = seg_pad(x), and letter
// column c is so + c * seg_prof_stride(n).
PT_HD int32_t seg_col(int32_t r, int32_t A) {
  return (r >= 0 && r < A) ? r : A;
}

PT_HD int32_t seg_pad(int32_t x) { return x + (x >> 5); }

// words of a staged profile column of n rows
PT_HD int32_t seg_prof_stride(int32_t n) { return seg_pad(n - 1) + 1; }

PT_HD int32_t seg_table_at(const int32_t* subs, int32_t A, int32_t k) {
  const int32_t r = k / (A + 1), c = k % (A + 1);
  return (r < A && c < A) ? subs[r * A + c] : 0;
}

// Stage `rows` profile rows from prow (row-major, A a row) into the
// column-major layout of capacity `cap` rows, items [first, items) of
// rows * (A + 1) taken `step` at a time (a block's threads, or one loop).
PT_HD void seg_stage_profile(int32_t* sc, const int32_t* prow, int32_t rows,
                             int32_t A, int32_t cap, int32_t first,
                             int32_t step) {
  const int32_t stride = seg_prof_stride(cap);
  // item k is row x = k / A, column c = k % A; both advance by the step
  // without a division an item
  const int32_t dx = step / A, dc = step % A;
  int32_t x = first / A, c = first % A;
  for (int32_t k = first; k < rows * A; k += step) {
    sc[c * stride + seg_pad(x)] = prow[k];
    x += dx;
    c += dc;
    if (c >= A) {
      c -= A;
      ++x;
    }
  }
  for (int32_t y = first; y < rows; y += step) sc[A * stride + seg_pad(y)] = 0;
}

// No candidate yet: below every H.
constexpr int32_t SEG_NONE = -2147483647 - 1;

// One query row of a lane.
template <int32_t kOut>
struct SegRow {
  int32_t h_left = 0, f = NEG_INF32, h_diag = 0;
  int32_t so = 0;                  // its scores in the staged scores
  int32_t mqi = 0;                 // stats: the row's letter
  bool row_all = false, row_last = false;   // the row's candidates
  Pay lp{0, 0, 0}, fp{0, 0, 0}, dp{0, 0, 0};
  // the row's first maximum among its candidates in this group, H and
  // column (SEG_NONE: none yet); the forms without payloads keep it a row
  int32_t bh = SEG_NONE, bj = 0;
  uint32_t tw = 0;                 // trace: up to 4 flags, one word
};

// One lane: query rows i0 .. i0 + kR - 1 of the current group.
template <int32_t kOut, int32_t kR>
struct SegLane {
  int32_t i0 = 0;
  int32_t nr = 0;                  // its rows below row_hi, 0 to kR
  SegRow<kOut> row[kR];
  SegUp out;                       // the bottom row's last cell
  SegBest best;
};

// Start a lane's rows: their scores (so: table form, row q[i] of the
// staged table; profile form, staged row i - prof_row0), candidates and
// the boundary column left of the segment (the carried state, or the
// bordered left column).  A row's first diagonal is the row above's H
// left of the segment as it was before this segment; `old` receives that
// of the lane's bottom row, for the lane below.  kBanded: the masked
// form's left border (band_border), from column 0 only.
template <bool kBanded = false, int32_t kOut, int32_t kR>
PT_HD void seg_lane_begin(SegLane<kOut, kR>& L, const SegPair& p, int32_t i0,
                          const int32_t* q, int32_t prof_row0,
                          const int32_t* mq, const int32_t* st_h,
                          const int32_t* st_f, const int32_t* st_pay,
                          int64_t pay_plane, SegUp& old) {
  using O = Out<kOut>;
  L.i0 = i0;
  L.nr = imax(0, imin(kR, p.row_hi - i0));
  old = SegUp();
PT_UNROLL
  for (int32_t k = 0; k < kR; ++k) {
    if (k >= L.nr) continue;
    SegRow<kOut>& w = L.row[k];
    const int32_t i = i0 + k;
    const int32_t j = i - p.row_lo;        // the row in the state buffers
    w.so = q ? seg_col(q[i], p.A) * (p.A + 1) : seg_pad(i - prof_row0);
    if constexpr (O::stats) w.mqi = mq[i];
    const bool last_row = i == p.qlen - 1;
    w.row_all = p.local || (last_row && p.qe);
    w.row_last = last_row || p.de;
    w.bh = SEG_NONE;
    w.tw = 0;
    if (p.resume) {
      w.h_left = st_h[j];
      w.f = st_f[j];
      if constexpr (O::stats) {
        w.lp = Pay{st_pay[j], st_pay[pay_plane + j],
                   st_pay[2 * pay_plane + j]};
        w.fp = Pay{st_pay[3 * pay_plane + j], st_pay[4 * pay_plane + j],
                   st_pay[5 * pay_plane + j]};
      }
    } else {
      w.h_left = seg_border<kBanded>(p, i + 1, p.db);
      w.f = NEG_INF32;
      w.lp = Pay{0, 0, p.db ? 0 : i + 1};
      w.fp = Pay{0, 0, 0};
    }
    if (k + 1 < kR) {
      L.row[k + 1].h_diag = w.h_left;
      L.row[k + 1].dp = w.lp;
    }
    old.h = w.h_left;
    old.hp = w.lp;
  }
}

// The first diagonal of the lane's top row: H[i0-1][off-1] and its
// payload, the lane above's `old` (row -1: the top border left of the
// segment).
template <int32_t kOut, int32_t kR>
PT_HD void seg_lane_diag(SegLane<kOut, kR>& L, const SegUp& above) {
  L.row[0].h_diag = above.h;
  L.row[0].dp = above.hp;
}

// The plane forms' outputs of one pair in the block kernel (the chunked
// form, kernel K1f): plane k of the table holds cell (i, j) at
// [k * tab_plane + j * qp + i], query-fastest, so that a lane's kR rows at
// one column are one vector store; element j of the last row sits at
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

template <bool kBanded = false>
PT_HD SegUp seg_corner(const SegPair& p) {
  SegUp u;
  u.h = seg_border<kBanded>(p, p.off, p.qb);
  u.hp.l = p.qb ? 0 : p.off;
  return u;
}

// kR consecutive values to dst, kR a multiple of 4: 16-byte vector stores
// on the card (dst aligned to kR values), a loop elsewhere.
template <int32_t kR>
PT_HD void store_rows(int32_t* dst, const int32_t (&v)[kR]) {
  static_assert(kR % 4 == 0, "whole vectors only");
#if defined(__CUDA_ARCH__)
PT_UNROLL
  for (int32_t k = 0; k < kR; k += 4)
    *reinterpret_cast<int4*>(dst + k) =
        make_int4(v[k], v[k + 1], v[k + 2], v[k + 3]);
#else
  for (int32_t k = 0; k < kR; ++k) dst[k] = v[k];
#endif
}

// Four flags at a 4-byte-aligned address.
PT_HD void store_word(int8_t* dst, uint32_t v) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint32_t*>(dst) = v;
#else
  for (int32_t k = 0; k < 4; ++k) dst[k] = (int8_t)(v >> (8 * k));
#endif
}

// Four words, 16 bytes, at a 16-byte aligned dst.
PT_HD void store_words4(int8_t* dst, uint32_t a, uint32_t b, uint32_t c,
                        uint32_t d) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint4*>(dst) = make_uint4(a, b, c, d);
#else
  store_word(dst, a);
  store_word(dst + 4, b);
  store_word(dst + 8, c);
  store_word(dst + 12, d);
#endif
}

// Fold each row's first maximum of the group into the lane's best (by
// seg_better) and clear it: at the end of every group of rows.  The stats
// forms keep the lane's best cell by cell instead.
template <int32_t kOut, int32_t kR>
PT_HD void seg_lane_fold(SegLane<kOut, kR>& L) {
  if constexpr (!Out<kOut>::stats) {
    PT_UNROLL
    for (int32_t k = 0; k < kR; ++k) {
      SegRow<kOut>& w = L.row[k];
      if (w.bh != SEG_NONE &&
          seg_better(w.bh, L.i0 + k, w.bj, L.best.h, L.best.i, L.best.j)) {
        L.best.h = w.bh;
        L.best.i = L.i0 + k;
        L.best.j = w.bj;
      }
      w.bh = SEG_NONE;
    }
  }
}

// The scores of a lane's rows against letter column rc: sc[so + at] with
// at = rc for the table form, rc * seg_prof_stride(rows) for the profile
// form.  The kernel fetches them a step ahead of their use.
template <int32_t kOut, int32_t kR>
PT_HD void seg_lane_scores(const SegLane<kOut, kR>& L, const int32_t* sc,
                           int32_t at, int32_t (&s)[kR]) {
  PT_UNROLL
  for (int32_t k = 0; k < kR; ++k) s[k] = sc[L.row[k].so + at];
}

// One step of a lane: column c (global off + c) of its rows, reference
// letter r and the rows' scores against it (seg_lane_scores), `u` the
// cell above its top row.  Writes each cell's flags (trace form; trace0
// is the top row's, rows rseg apart; with `pack`, four columns a 32-bit
// store, rseg a multiple of 4), its H and payload into the planes (table
// forms: H of the kR rows one vector store when kR is a multiple of 4,
// `vec` and every row is in the pair; rowcol forms: on the pair's last
// row and last column), the
// tile's down-state (`down`, on the tile's last row), the row's state at
// the pair's last column of the segment, and the row's first maximum
// (the stats forms: the lane's best, payload and all); leaves the bottom
// row's cell in L.out.  kBanded (the masked one-shot form): each cell
// takes its flags and payloads first, then H, E and F become NEG_INF32
// outside the band (band_out at its global column, p.bw), before anything
// stores, passes on or folds them, and such a cell is no candidate;
// score_pair's masked sweep, cell for cell.
template <int32_t kOut, int32_t kR, bool kBanded = false>
PT_HD void seg_lane_step(SegLane<kOut, kR>& L, const SegPair& p, int32_t c,
                         int32_t r, const int32_t (&sk)[kR], SegUp u,
                         int8_t* trace0, int32_t rseg, int32_t* st_h,
                         int32_t* st_f, int32_t* st_pay, int64_t pay_plane,
                         const SegPlanes& pl, int32_t* down, bool vec,
                         bool pack) {
  using O = Out<kOut>;
  const int32_t jg = p.off + c;
  const bool last_col = jg == p.rlen - 1;
  const bool state_col = c == p.ncols - 1;
  // the H plane's one vector store (16-byte stores: kR a multiple of 4)
  // where the lane holds kR rows (L.nr == kR, written against row_hi for
  // the reason short_whole gives)
  const bool whole = kR % 4 == 0 && vec && L.i0 + kR <= p.row_hi;
  int32_t hv[kR];
PT_UNROLL
  for (int32_t k = 0; k < kR; ++k) {
    // a row past the pair (the lane's last rows, where the pair ends
    // inside it) is computed as the others, without a branch, and writes
    // nothing; the extremes read row 0's H in its place
    const bool on = k < L.nr;
    SegRow<kOut>& w = L.row[k];
    const int32_t i = L.i0 + k;
    const int32_t s = sk[k];
    int32_t h, e;
    Pay hp{0, 0, 0}, ep{0, 0, 0};
    if constexpr (O::trace) {
      const int32_t fl = cell_trace(w.h_diag, u.h, u.e, w.h_left, s, p.open,
                                    p.ext, p.local, w.f, h, e);
      int8_t* at = trace0 + (int64_t)k * rseg;
      if (pack) {
        w.tw |= (uint32_t)fl << (8 * (c & 3));
        if ((c & 3) == 3 || state_col) {
          if (on) store_word(at + (c & ~3), w.tw);
          w.tw = 0;
        }
      } else if (on) {
        at[c] = (int8_t)fl;
      }
    } else if constexpr (O::stats) {
      cell_stats(w.h_diag, u.h, u.e, w.h_left, s, p.open, p.ext, p.local,
                 w.mqi == r, u.hp, u.ep, w.lp, w.dp, w.fp, w.f, h, e, hp, ep);
      w.dp = u.hp;
      w.lp = hp;
    } else {
      cell(w.h_diag, u.h, u.e, w.h_left, s, p.open, p.ext, p.local, w.f, h,
           e);
    }
    const bool out = kBanded && band_out(i, jg, p.bw);
    if constexpr (kBanded) {
      h = out ? NEG_INF32 : h;
      e = out ? NEG_INF32 : e;
      w.f = out ? NEG_INF32 : w.f;
    }
    w.h_diag = u.h;
    w.h_left = h;
    u.h = h;
    u.e = e;
    u.hp = hp;
    u.ep = ep;
    hv[k] = on ? h : hv[0];
    if constexpr (O::table) {
      const int64_t t = (int64_t)jg * p.qp + i;
      if (on && !whole) pl.table[t] = h;
      if constexpr (O::stats) {
        if (on) {
          pl.table[pl.tab_plane + t] = hp.m;
          pl.table[2 * pl.tab_plane + t] = hp.s;
          pl.table[3 * pl.tab_plane + t] = hp.l;
        }
      }
    }
    if constexpr (O::rowcol) {
      if (on && i == p.qlen - 1) {
        pl.row[jg] = h;
        if constexpr (O::stats) {
          pl.row[pl.row_plane + jg] = hp.m;
          pl.row[2 * pl.row_plane + jg] = hp.s;
          pl.row[3 * pl.row_plane + jg] = hp.l;
        }
      }
      if (on && last_col) {
        pl.col[i] = h;
        if constexpr (O::stats) {
          pl.col[pl.col_plane + i] = hp.m;
          pl.col[2 * pl.col_plane + i] = hp.s;
          pl.col[3 * pl.col_plane + i] = hp.l;
        }
      }
    }
    if (on && down != nullptr && i == p.down_row)
      seg_up_store<kOut>(down, rseg, c, u);
    const bool cand = on && !out && (w.row_all || (w.row_last && last_col));
    if constexpr (O::stats) {
      // rows top to bottom, then columns: an equal H in an earlier row is
      // ahead (seg_better for cells that arrive in this order)
      if (cand && (h > L.best.h || (h == L.best.h && i < L.best.i))) {
        L.best.h = h;
        L.best.i = i;
        L.best.j = jg;
        L.best.p = hp;
      }
    } else if (cand && h > w.bh) {       // columns ascend within a row
      w.bh = h;
      w.bj = jg;
    }
    if (on && state_col) {
      const int32_t j = i - p.row_lo;
      st_h[j] = h;
      st_f[j] = w.f;
      if constexpr (O::stats) {
        st_pay[j] = hp.m;
        st_pay[pay_plane + j] = hp.s;
        st_pay[2 * pay_plane + j] = hp.l;
        st_pay[3 * pay_plane + j] = w.fp.m;
        st_pay[4 * pay_plane + j] = w.fp.s;
        st_pay[5 * pay_plane + j] = w.fp.l;
      }
    }
  }
  // the extremes, two rows an instruction
  int32_t mx = L.best.hmax, mn = L.best.hmin;
PT_UNROLL
  for (int32_t k = 0; k + 1 < kR; k += 2) {
    mx = max3(mx, hv[k], hv[k + 1]);
    mn = min3(mn, hv[k], hv[k + 1]);
  }
  if constexpr (kR % 2 == 1) {
    mx = imax(mx, hv[kR - 1]);
    mn = imin(mn, hv[kR - 1]);
  }
  L.best.hmax = mx;
  L.best.hmin = mn;
  if constexpr (O::table) {
    if constexpr (kR % 4 == 0)
      if (whole) store_rows<kR>(pl.table + (int64_t)jg * p.qp + L.i0, hv);
  }
  L.out = u;
}

// Fold the segment's best into the carried accumulator `acc` (8 values;
// initialised here when !resume) and derive the pair's outputs from it,
// as score_pair's: the SW clamp is the accumulator's initial (0, 0, 0),
// NW ends at (qlen - 1, rlen - 1), and a non-local pair with an empty side
// takes empty_side(), decided from the global lengths (kBanded: the
// banded one, band_border's; and a non-local pair with no candidate in the
// band, score -2^30, ends at (qp, rp) as score_pair's).
template <int32_t kOut, bool kBanded = false>
PT_HD PairResult seg_finish(const SegPair& p, int32_t mode,
                            const SegBest& seg, int32_t* acc) {
  using O = Out<kOut>;
  if (!p.local && (p.qlen == 0 || p.rlen == 0)) {
    if (!p.resume)
      for (int32_t k = 0; k < 8; ++k) acc[k] = 0;
    return empty_side<kBanded>(p.qlen, p.rlen, p.open, p.ext, p.qb, p.qe,
                               p.db, p.de, p.bw);
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
    a.j = p.local ? 0 : (kBanded ? p.rp : BIG);
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

// Warp w's own step at the group's step g.  Step -1 only fetches ahead.
PT_HD int32_t seg_local_step(int32_t g, int32_t w) {
  return g - SEG_LAG * w - 1;
}

// Steps a group of rows takes when `nw` warps of its chain have rows: the
// last starts SEG_LAG * (nw - 1) + 1 steps in and sweeps ncols columns
// with up to SEG_LANES lanes.
PT_HD int32_t seg_group_steps(int32_t ncols, int32_t nw) {
  return SEG_LAG * (nw - 1) + 1 + ncols + SEG_LANES - 1;
}

// Does the pair sweep any cell in this segment?
PT_HD bool seg_sweeps(const SegPair& p) {
  return p.row_hi > p.row_lo && p.ncols > 0;
}

// ---------------------------------------------------------------------------
// The launcher's rule: kR rows a lane, W warps a block and C blocks (a
// thread-block cluster) a pair, for B pairs of Qs rows by ncols columns.
// What bounds a step is its dependent chain, so the rule fills each
// warp's lanes with rows and puts the rows of a pair in as few groups as
// it can, every group paying SEG_LAG steps of fill a warp:
//
//   kR  the largest of the class's forms whose eight warps of 32 kR rows
//       the pair's Qs rows fill, else the largest whose one warp they
//       fill, else 2; at most 4 where a step writes a plane cell by cell
//       (trace, table, stats_table) or carries payloads (the stats
//       classes), 8 elsewhere (score, rowcol).  The table classes take 4
//       whenever one warp's 128 rows fill: their H plane is then one
//       16-byte store a lane, which beats the warps 2 rows would fill
//       (128 x 512^2: table 0.39 ms against 0.78, stats_table 2.79
//       against 3.44; PERF.md);
//   W   the warps whose 32 kR rows cover Qs, at most 8;
//   C   when B blocks leave SMs idle, the pair's blocks on the idle SMs
//       (132 / B), at most the blocks whose warps cover Qs, at most 8;
//
// and halves W while the block's shared memory (the profile form's
// staged rows) passes SEG_SMEM_BUDGET.  A non-zero warps, rows or cluster
// fixes that choice (the tests and chip_smoke.py check given forms so);
// chip_smoke.py's phase 27 times the rule's pick beside other forms at
// the main paths' shapes.
struct SegPlan {
  int32_t rows, warps, cluster;
};

constexpr int32_t SEG_SMS = 132;                 // the H100's SMs
constexpr int32_t SEG_MAX_WARPS = 8;
constexpr int32_t SEG_MAX_CLUSTER = 8;           // the portable limit
constexpr int64_t SEG_SMEM_BUDGET = 160 * 1024;

PT_HD bool seg_stats_class(int32_t out_class) {
  return out_class == OUT_STATS || out_class == OUT_STATS_TABLE ||
         out_class == OUT_STATS_ROWCOL;
}

// Does the class have forms of 8 rows a lane?  Only where a step neither
// writes a plane cell by cell nor carries payloads: score and rowcol.
PT_HD constexpr bool seg_wide_class(int32_t out_class) {
  return out_class == OUT_SCORE || out_class == OUT_ROWCOL;
}

// rows a lane the class's forms are compiled for: the rows seg_plan picks
PT_HD bool seg_rows_compiled(int32_t out_class, int32_t rows) {
  return rows == 2 || rows == 4 || (rows == 8 && seg_wide_class(out_class));
}

// The letters a block stages: a ring of SEG_LETTERS columns, or, for a
// segment of fewer columns, all of them (a power of two).
PT_HD int32_t seg_letter_ring(int32_t ncols) {
  int32_t n = SEG_LANES;
  while (n < ncols && n < SEG_LETTERS) n *= 2;
  return n;
}

// Profile rows a block stages: its rows of a group, at most the state's.
PT_HD int32_t seg_prof_rows(int32_t rows, int32_t warps, int32_t Qs) {
  return imax(1, imin(warps * SEG_LANES * rows, Qs));
}

// Shared memory of a block, words: the staged scores, the letter ring,
// a ring per warp (read by it, written by the warp above it in the
// chain), and the olds and bests of the pair's C W warps; the kernel
// lays them out in this order.
PT_HD int64_t seg_score_words(bool profile, int32_t rows, int32_t warps,
                              int32_t Qs, int32_t A) {
  return profile ? (int64_t)(A + 1) *
                       seg_prof_stride(seg_prof_rows(rows, warps, Qs))
                 : (int64_t)(A + 1) * (A + 1);
}

PT_HD int64_t seg_block_bytes(int32_t out_class, bool profile, int32_t rows,
                              int32_t warps, int32_t cluster, int32_t A,
                              int32_t Qs, int32_t ncols) {
  const int64_t state = seg_stats_class(out_class) ? 8 : 2;
  return 4 * (seg_score_words(profile, rows, warps, Qs, A) +
              seg_letter_ring(ncols) + (int64_t)warps * state * SEG_RING +
              (int64_t)warps * cluster * (4 + 8));
}

PT_HD int32_t seg_div_up(int32_t a, int32_t b) { return (a + b - 1) / b; }

PT_HD SegPlan seg_plan(int32_t out_class, int32_t B, int32_t Qs,
                       int32_t ncols, int32_t A, bool profile, int32_t warps,
                       int32_t rows, int32_t cluster) {
  Qs = imax(Qs, 1);
  int32_t R = rows;
  if (R <= 0) {
    const int32_t most = seg_wide_class(out_class) ? 8 : 4;
    const bool table = out_class == OUT_TABLE || out_class == OUT_STATS_TABLE;
    // eight warps full, else one (the table classes: one)
    const int32_t full[2] = {table ? 1 : SEG_MAX_WARPS, 1};
    for (int32_t f : full)
      for (int32_t r = most; R <= 0 && r >= 2; r /= 2)
        if (SEG_LANES * r * f <= Qs) R = r;
    if (R <= 0) R = 2;
  }
  int32_t W = warps > 0
      ? imin(warps, SEG_MAX_WARPS)
      : imax(1, imin(SEG_MAX_WARPS, seg_div_up(Qs, SEG_LANES * R)));
  int32_t C = cluster;
  if (C <= 0)
    C = imax(1, imin(SEG_MAX_CLUSTER,
                     imin(SEG_SMS / imax(B, 1),
                          seg_div_up(Qs, SEG_LANES * R * W))));
  if (warps <= 0)
    while (W > 1 && seg_block_bytes(out_class, profile, R, W, C, A, Qs,
                                    ncols) > SEG_SMEM_BUDGET)
      W /= 2;
  return SegPlan{R, W, C};
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
//           the tile below, from whichever lane holds that row among its kR
//           rows.  (The TPU kernel carries a prefix-max seed instead of E:
//           it computes E by a prefix scan, this cell by the literal
//           recurrence.)
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

// ---------------------------------------------------------------------------
// The short form (csrc/scan_short.cuh; kernels K1a-K1d, and K1e's masked
// classes): every class of the one-shot sweep for pairs of at most
// SEG_LANES kR padded query rows, ONE warp a pair, several pairs a block,
// unbanded (scan_short.cu) or masked to a band (kBanded, as score_pair's
// masked sweep; scan_short_banded.cu).  Lane L holds query
// rows [L kR, L kR + kR) and at step t computes column t - L of them top
// to bottom, as a lane of the segment form does (cell / cell_trace /
// cell_stats_of, the DPX max-plus helpers, the end cell's order of
// seg_better, the outputs of seg_finish); one shuffle a step brings the
// bottom row of the lane above.  What the segment form's lane carries
// beyond that (state rows, rings, groups of rows) a one-shot pair of one
// warp needs not, so the short form has its own lane registers: H, E and
// F stay in registers for the whole pair.  The plane classes write what
// the chunked form writes (SegPlanes: the tables laid out (nplanes, B,
// Rp, Qp), the last row and the last column), a lane's kR rows of a
// column as one short vector where it holds kR rows of the pair.
//
// The stats payloads travel PACKED, as the reference's one-pass kernel
// packs them (parasail_rs_tpu/ops/scan_kernel.py, stats_pack_params and
// stats_pack2_params): [m | s | l] in one int32 where its rule says the
// fields fit 31 bits (Qp + Rp up to about 1,000), else [m | s] in one
// int32 and l in another.  The length field holds l itself (the
// reference's OFFL offset serves its prefix scan, which a cell-by-cell
// recurrence does not have).  A payload moves only by selects and by
// field increments (cell_stats_of), and no field can outgrow its width on
// a pair's cells: l <= Qp + Rp, m and s <= Qp.  So the values are
// golden's exactly, the local reset is the word 0, and the row below
// reads four words a step (H, E and their payloads; six with l apart)
// instead of eight.

// [m | s | l] in one word: l in bits [0, sh_s), s in [sh_s, sh_m), m above.
struct PackOps {
  using V = int32_t;
  int32_t sh_m = 0, sh_s = 0;
  int32_t inc_m = 0, inc_s = 0;   // 1 << sh_m, 1 << sh_s
  PT_HD V ext(V p) const { return p + 1; }
  PT_HD V diag(V p, bool match, bool sim) const {
    return p + (match ? inc_m : 0) + (sim ? inc_s : 0) + 1;
  }
  PT_HD V zero() const { return 0; }
  PT_HD V border(int32_t l) const { return l; }
  PT_HD Pay unpack(V p) const {
    return Pay{p >> sh_m, (p >> sh_s) & (inc_m / inc_s - 1),
               p & (inc_s - 1)};
  }
};

// [m | s] in one word (s in bits [0, sh)) and l in another.
struct Pay2 {
  int32_t ms = 0, l = 0;
};

struct Pack2Ops {
  using V = Pay2;
  int32_t sh = 0;
  int32_t inc_m = 0;              // 1 << sh
  PT_HD V ext(V p) const {
    p.l += 1;
    return p;
  }
  PT_HD V diag(const V& p, bool match, bool sim) const {
    return Pay2{p.ms + (match ? inc_m : 0) + (sim ? 1 : 0), p.l + 1};
  }
  PT_HD V zero() const { return Pay2{0, 0}; }
  PT_HD V border(int32_t l) const { return Pay2{0, l}; }
  PT_HD Pay unpack(const V& p) const {
    return Pay{p.ms >> sh, p.ms & (inc_m - 1), p.l};
  }
};

// The classes without stats carry no payload.
struct NoPay {};

struct NoPayOps {
  using V = NoPay;
  PT_HD V zero() const { return V(); }
  PT_HD V border(int32_t) const { return V(); }
  PT_HD Pay unpack(const V&) const { return Pay{0, 0, 0}; }
};

PT_HD int32_t bit_length(int32_t x) {
  int32_t n = 0;
  for (; x > 0; x >>= 1) ++n;
  return n;
}

// The payload layouts of the short form's stats classes.
enum ShortLayout : int32_t { SHORT_UNPACKED = 0, SHORT_PACKED = 1,
                             SHORT_PACKED2 = 2 };

// The reference's rule (stats_pack_params): [m | s | l] in one word when
// two fields of bit_length(Qp + Rp + 1) bits and one of bit_length(2 Qp +
// Rp + 1) fit 31 bits; else [m | s] + l (stats_pack2_params: two fields of
// bit_length(Qp) bits, which fit for every Qp the short form takes).
PT_HD int32_t short_layout(int32_t Qp, int32_t Rp) {
  const int32_t span = Qp + Rp;
  const int32_t bm = imax(1, bit_length(span + 1));
  const int32_t bl = imax(1, bit_length(span + Qp + 1));
  return 2 * bm + bl <= 31 ? SHORT_PACKED : SHORT_PACKED2;
}

PT_HD PackOps pack_ops(int32_t Qp, int32_t Rp) {
  const int32_t span = Qp + Rp;
  PackOps po;
  po.sh_s = imax(1, bit_length(span + Qp + 1));
  po.sh_m = po.sh_s + imax(1, bit_length(span + 1));
  po.inc_s = 1 << po.sh_s;
  po.inc_m = 1 << po.sh_m;
  return po;
}

PT_HD Pack2Ops pack2_ops(int32_t Qp) {
  Pack2Ops po;
  po.sh = imax(1, bit_length(Qp));
  po.inc_m = 1 << po.sh;
  return po;
}

// The launcher's rule: kR rows a lane, pairs (warps) a block and the
// payload layout, for B pairs of Qp by Rp padded cells.  kR is the fewest
// rows of a form (short_rows) whose 32 kR rows hold the query: a step
// costs kR cells and lanes past the query idle, so the fewer the better
// (5 rows at Qp = 160 keep every lane busy, 8 would idle 12 of 32).
// Rows 0 means the short form does not take the batch (Qp > SEG_LANES *
// 8, or a block that cannot stage its inputs), which the block kernel's
// one-shot forms then serve.  Pairs a
// block: enough blocks for every SM (B / SEG_SMS, at most
// SHORT_MAX_PAIRS), fewer while the block's shared memory passes
// SHORT_SMEM_BUDGET (two blocks an SM).
struct ShortPlan {
  int32_t rows, pairs, layout;
};

constexpr int32_t SHORT_MAX_PAIRS = 8;
constexpr int32_t SHORT_MAX_QP = SEG_LANES * 8;

// The forms' rows a lane (4, 5, 6 or 8): the fewest whose warp holds Qp.
PT_HD int32_t short_rows(int32_t Qp) {
  for (int32_t r = 4; r < 8; ++r)
    if (r != 7 && SEG_LANES * r >= Qp) return r;
  return 8;
}

constexpr int64_t SHORT_SMEM_BUDGET = 112 * 1024;
constexpr int64_t SHORT_SMEM_MAX = 200 * 1024;

// Words of one staged set of scores: the (A + 1)^2 table, or a pair's
// profile rows column by column (seg_stage_profile's layout, Qp rows).
PT_HD int64_t short_score_words(bool profile, int32_t Qp, int32_t A) {
  return profile ? (int64_t)(A + 1) * seg_prof_stride(imax(Qp, 1))
                 : (int64_t)(A + 1) * (A + 1);
}

// Shared memory of a block: one set of scores (the table, or a profile
// all pairs share), or one a pair (per-pair profiles); then each pair's
// reference letters, all of them.
PT_HD int64_t short_block_bytes(int32_t pairs, int32_t Qp, int32_t Rp,
                                int32_t A, bool profile, bool per_pair) {
  return 4 * (short_score_words(profile, Qp, A) * (per_pair ? pairs : 1) +
              (int64_t)pairs * imax(Rp, 1));
}

PT_HD ShortPlan short_plan(int32_t out_class, int32_t B, int32_t Qp,
                           int32_t Rp, int32_t A, bool profile,
                           bool per_pair) {
  const ShortPlan none{0, 0, 0};
  if (out_class < OUT_SCORE || out_class > OUT_STATS_ROWCOL ||
      Qp > SHORT_MAX_QP)
    return none;
  int32_t pairs = imax(1, imin(SHORT_MAX_PAIRS, seg_div_up(B, SEG_SMS)));
  while (pairs > 1 && short_block_bytes(pairs, Qp, Rp, A, profile,
                                        per_pair) > SHORT_SMEM_BUDGET)
    --pairs;
  if (short_block_bytes(pairs, Qp, Rp, A, profile, per_pair) >
      SHORT_SMEM_MAX)
    return none;
  return ShortPlan{short_rows(Qp), pairs,
                   seg_stats_class(out_class) ? short_layout(Qp, Rp)
                                              : SHORT_UNPACKED};
}

// Whether the trace class stores its flags 16 columns a 16-byte store, for
// rows `rstride` bytes apart (else a byte a cell).  A warp's stores land
// on as many rows as it has lanes, so each is a memory transaction of its
// own: wide ones make them few.
PT_HD bool short_wide(int64_t rstride) { return rstride % 16 == 0; }

// The words of the plane classes' vector stores at kR rows a lane: 16
// bytes where kR is a multiple of 4, 8 where of 2, else a word.  A lane's
// rows of a column start at word j Qp + L kR, so the vector is aligned
// where Qp is a multiple of it too (short_vec_ok).
PT_HD constexpr int32_t short_vec(int32_t kR) {
  return kR % 4 == 0 ? 4 : (kR % 2 == 0 ? 2 : 1);
}

PT_HD bool short_vec_ok(int32_t kR, int32_t Qp) {
  return Qp % short_vec(kR) == 0;
}

// A lane's kR values to dst, its rows of one column of a plane (or of the
// last column): whole vectors (short_vec) where `whole` (the lane holds kR
// rows of the pair and dst is aligned), else word by word with the rows
// past the pair (k >= nr) masked, so that no store lands on a padding row
// or, with (B, Rp, Qp) planes, on the next column.
template <int32_t kR>
PT_HD void short_store(int32_t* dst, const int32_t (&v)[kR], int32_t nr,
                       bool whole) {
#if defined(__CUDA_ARCH__)
  if constexpr (short_vec(kR) > 1) {
    if (whole) {
PT_UNROLL
      for (int32_t k = 0; k < kR; k += short_vec(kR)) {
        if constexpr (short_vec(kR) == 4)
          *reinterpret_cast<int4*>(dst + k) =
              make_int4(v[k], v[k + 1], v[k + 2], v[k + 3]);
        else
          *reinterpret_cast<int2*>(dst + k) = make_int2(v[k], v[k + 1]);
      }
    } else {
PT_UNROLL
      for (int32_t k = 0; k < kR; ++k)
        if (k < nr) dst[k] = v[k];
    }
    return;
  }
#endif
  (void)whole;
PT_UNROLL
  for (int32_t k = 0; k < kR; ++k)
    if (k < nr) dst[k] = v[k];
}

// What the row below reads of a cell: H and E, and their payloads.
template <class PO>
struct ShortUp {
  int32_t h = NEG_INF32, e = NEG_INF32;
  typename PO::V hp{}, ep{};
};

template <class PO>
struct ShortRow {
  int32_t h_left = 0, f = NEG_INF32, h_diag = 0;
  int32_t so = 0;                  // its scores in the staged scores
  int32_t mqi = 0;                 // stats: the row's letter
  bool row_all = false, row_last = false;   // the row's candidates
  typename PO::V lp{}, fp{}, dp{};
  int32_t bh = SEG_NONE, bj = 0;   // no stats: the row's first maximum
  uint32_t tw = 0;                 // trace: up to 4 flags, one word
  uint32_t tq[3] = {0, 0, 0};      // trace: the words before it in 16
};

// One lane: query rows i0 .. i0 + kR - 1 of the pair.  The stats classes
// keep the lane's best cell (bh, bi, bj, bp) cell by cell, the others
// each row's first maximum, folded at the end (short_lane_best).
template <int32_t kR, class PO>
struct ShortLane {
  int32_t i0 = 0;
  int32_t nr = 0;                  // its rows below qlen, 0 to kR
  ShortRow<PO> row[kR];
  ShortUp<PO> out;                 // the bottom row's last cell
  int32_t bh = 0, bi = 0, bj = 0;
  typename PO::V bp{};
  int32_t hmax = 0, hmin = 0;
};

// Start lane `lane`'s rows: their scores (table form, row q[i] of the
// staged table; profile form, staged row i), letters, candidates and the
// bordered left column (kBanded: band_border's); `old` receives the bottom
// row's left border, the lane below's first diagonal.
template <int32_t kOut, bool kBanded = false, int32_t kR, class PO>
PT_HD void short_lane_begin(ShortLane<kR, PO>& L, const SegPair& p,
                            int32_t lane, const int32_t* q,
                            const int32_t* mq, const PO& po,
                            ShortUp<PO>& old) {
  L.i0 = lane * kR;
  L.nr = imax(0, imin(kR, p.qlen - L.i0));
  L.bh = p.local ? 0 : NEG_INF32;
  L.bi = p.local ? BIG : p.qp;
  L.bj = BIG;
  old = ShortUp<PO>();
PT_UNROLL
  for (int32_t k = 0; k < kR; ++k) {
    if (k >= L.nr) continue;
    ShortRow<PO>& w = L.row[k];
    const int32_t i = L.i0 + k;
    w.so = q ? seg_col(q[i], p.A) * (p.A + 1) : seg_pad(i);
    if constexpr (Out<kOut>::stats) w.mqi = mq[i];
    const bool last_row = i == p.qlen - 1;
    w.row_all = p.local || (last_row && p.qe);
    w.row_last = last_row || p.de;
    w.h_left = seg_border<kBanded>(p, i + 1, p.db);
    w.lp = po.border(p.db ? 0 : i + 1);
    if (k + 1 < kR) {
      L.row[k + 1].h_diag = w.h_left;
      L.row[k + 1].dp = w.lp;
    }
    old.h = w.h_left;
    old.hp = w.lp;
  }
}

// The first diagonal of the lane's top row, H[i0 - 1][-1]: the lane
// above's `old`, for lane 0 the corner (0, its payload 0).
template <int32_t kR, class PO>
PT_HD void short_lane_diag(ShortLane<kR, PO>& L, const ShortUp<PO>& above) {
  L.row[0].h_diag = above.h;
  L.row[0].dp = above.hp;
}

// The top border above column c: H[-1][c], E = -inf, and its payload
// (kBanded: H band_border's, the payload unmasked).
template <bool kBanded = false, class PO>
PT_HD ShortUp<PO> short_top(const SegPair& p, int32_t c, const PO& po) {
  ShortUp<PO> u;
  u.h = seg_border<kBanded>(p, c + 1, p.qb);
  u.hp = po.border(p.qb ? 0 : c + 1);
  return u;
}

template <int32_t kR, class PO>
PT_HD void short_lane_scores(const ShortLane<kR, PO>& L, const int32_t* sc,
                             int32_t at, int32_t (&s)[kR]) {
  PT_UNROLL
  for (int32_t k = 0; k < kR; ++k) s[k] = sc[L.row[k].so + at];
}

// The trace class's stores of a lane's rows after column c, the last of
// a word or the pair's: the word waits in tq until the last word of its 16
// columns or the pair's, then the 16 columns go out in one 16-byte store.
// One branch a step for the lane's rows, the rows past the pair masked
// (a branch a row would split the warp once a row).
template <int32_t kR, class PO>
PT_HD void short_lane_flush(ShortLane<kR, PO>& L, int8_t* trace0,
                            int64_t rstride, int32_t c, bool last_col) {
  const int32_t m = (c >> 2) & 3;      // the word's place among 16 columns
PT_UNROLL
  for (int32_t k = 0; k < kR; ++k) {
    ShortRow<PO>& w = L.row[k];
    w.tq[0] = m == 0 ? w.tw : w.tq[0];
    w.tq[1] = m == 1 ? w.tw : w.tq[1];
    w.tq[2] = m == 2 ? w.tw : w.tq[2];
  }
  if (m == 3 || last_col) {
PT_UNROLL
    for (int32_t k = 0; k < kR; ++k) {
      ShortRow<PO>& w = L.row[k];
      if (k < L.nr)
        store_words4(trace0 + k * rstride + (c & ~15), w.tq[0], w.tq[1],
                     w.tq[2], m == 3 ? w.tw : 0);
      w.tq[0] = w.tq[1] = w.tq[2] = 0;
    }
  }
PT_UNROLL
  for (int32_t k = 0; k < kR; ++k) L.row[k].tw = 0;
}

// Does a lane store whole vectors (short_store)?  Where it holds kR rows
// of the pair (L.nr == kR, written against qlen: for that comparison the
// CUDA compiler took the predicate of the min that computes L.nr, which
// also holds below kR, and the stats forms stored whole vectors past the
// pair; phase 28 of chip_smoke.py holds the lanes' edges) and `vec`
// (short_vec_ok) aligns them.
template <int32_t kR, class PO>
PT_HD bool short_whole(const ShortLane<kR, PO>& L, const SegPair& p,
                       bool vec) {
  return vec && L.i0 + kR <= p.qlen;
}

// A lane's kR rows of one column: H to dst and, for the stats classes,
// the payloads (unpacked here, plane by plane) `plane` words apart after
// it.
template <bool kStats, int32_t kR, class PO>
PT_HD void short_store_planes(int32_t* dst, int64_t plane,
                              const int32_t (&hv)[kR],
                              const typename PO::V (&pv)[kR], int32_t nr,
                              bool whole, const PO& po) {
  short_store<kR>(dst, hv, nr, whole);
  if constexpr (kStats) {
    int32_t v[kR];
PT_UNROLL
    for (int32_t k = 0; k < kR; ++k) v[k] = po.unpack(pv[k]).m;
    short_store<kR>(dst + plane, v, nr, whole);
PT_UNROLL
    for (int32_t k = 0; k < kR; ++k) v[k] = po.unpack(pv[k]).s;
    short_store<kR>(dst + 2 * plane, v, nr, whole);
PT_UNROLL
    for (int32_t k = 0; k < kR; ++k) v[k] = po.unpack(pv[k]).l;
    short_store<kR>(dst + 3 * plane, v, nr, whole);
  }
}

// The plane classes' stores of a lane's step at column c (SegPlanes of the
// pair): the tables' column c, and the last row where the lane holds row
// qlen - 1.  `hv` holds the rows' H, `pv` their payloads.  The last column
// is written once, after the sweep (short_lane_last_col).
template <int32_t kOut, int32_t kR, class PO>
PT_HD void short_lane_planes(const ShortLane<kR, PO>& L, const SegPair& p,
                             int32_t c, const int32_t (&hv)[kR],
                             const typename PO::V (&pv)[kR],
                             const SegPlanes& pl, bool vec, const PO& po) {
  using O = Out<kOut>;
  if constexpr (O::table)
    short_store_planes<O::stats>(pl.table + (int64_t)c * p.qp + L.i0,
                                 pl.tab_plane, hv, pv, L.nr,
                                 short_whole(L, p, vec), po);
  if constexpr (O::rowcol) {
    // the last row: one word a step (a plane), from the lane that holds
    // it, its row picked by selects
    const int32_t x = p.qlen - 1 - L.i0;
    if (x >= 0 && x < L.nr) {
      int32_t h = hv[0];
      typename PO::V pk = pv[0];
PT_UNROLL
      for (int32_t k = 1; k < kR; ++k) {
        h = k == x ? hv[k] : h;
        pk = k == x ? pv[k] : pk;
      }
      pl.row[c] = h;
      if constexpr (O::stats) {
        const Pay u = po.unpack(pk);
        pl.row[pl.row_plane + c] = u.m;
        pl.row[2 * pl.row_plane + c] = u.s;
        pl.row[3 * pl.row_plane + c] = u.l;
      }
    }
  }
}

// The rowcol classes' last column, after the sweep: each row's H left of
// the next column and its payload (h_left, lp) are those of column rlen -
// 1, the pair's last; a lane's rows one short vector a plane.
template <int32_t kOut, int32_t kR, class PO>
PT_HD void short_lane_last_col(const ShortLane<kR, PO>& L, const SegPair& p,
                               const SegPlanes& pl, bool vec, const PO& po) {
  if constexpr (Out<kOut>::rowcol) {
    int32_t hv[kR];
    typename PO::V pv[kR];
PT_UNROLL
    for (int32_t k = 0; k < kR; ++k) {
      hv[k] = L.row[k].h_left;
      pv[k] = L.row[k].lp;
    }
    short_store_planes<Out<kOut>::stats>(pl.col + L.i0, pl.col_plane, hv, pv,
                                         L.nr, short_whole(L, p, vec), po);
  }
}

// One step of a lane: column c of its rows, reference letter r and the
// rows' scores against it, `u` the cell above its top row.  The trace
// class writes each cell's flags (trace0: the top row's, rows `rstride`
// apart): with `wide` (short_wide) 16 columns a store, else a byte a cell;
// the plane classes their planes (`pl`, short_lane_planes; `vec`:
// short_vec_ok); rows past the pair are computed as the others, without a
// branch, and write nothing.  The stats classes keep the lane's best cell
// cell by cell, the others each row's first maximum.  Leaves the bottom
// row's cell in L.out.  kBanded (the masked form, K1e): as seg_lane_step's,
// H, E and F become NEG_INF32 outside the band after the cell's flags and
// payloads and before its stores, its shuffle to the lane below, the
// extremes and the candidate test, which a cell outside the band fails.
template <int32_t kOut, bool kBanded = false, int32_t kR, class PO>
PT_HD void short_lane_step(ShortLane<kR, PO>& L, const SegPair& p, int32_t c,
                           int32_t r, const int32_t (&sk)[kR],
                           ShortUp<PO> u, int8_t* trace0, int64_t rstride,
                           bool wide, const SegPlanes& pl, bool vec,
                           const PO& po) {
  using O = Out<kOut>;
  const bool last_col = c == p.rlen - 1;
  int32_t hv[kR];
  typename PO::V pv[kR];
PT_UNROLL
  for (int32_t k = 0; k < kR; ++k) {
    const bool on = k < L.nr;
    ShortRow<PO>& w = L.row[k];
    const int32_t i = L.i0 + k;
    int32_t h, e;
    typename PO::V hp{}, ep{};
    if constexpr (O::trace) {
      const int32_t fl = cell_trace(w.h_diag, u.h, u.e, w.h_left, sk[k],
                                    p.open, p.ext, p.local, w.f, h, e);
      if (wide)
        w.tw |= (uint32_t)fl << (8 * (c & 3));
      else if (on)
        trace0[k * rstride + c] = (int8_t)fl;
    } else if constexpr (O::stats) {
      cell_stats_of(po, w.h_diag, u.h, u.e, w.h_left, sk[k], p.open, p.ext,
                    p.local, w.mqi == r, u.hp, u.ep, w.lp, w.dp, w.fp, w.f,
                    h, e, hp, ep);
      w.dp = u.hp;
      w.lp = hp;
    } else {
      cell(w.h_diag, u.h, u.e, w.h_left, sk[k], p.open, p.ext, p.local, w.f,
           h, e);
    }
    const bool out = kBanded && band_out(i, c, p.bw);
    if constexpr (kBanded) {
      h = out ? NEG_INF32 : h;
      e = out ? NEG_INF32 : e;
      w.f = out ? NEG_INF32 : w.f;
    }
    w.h_diag = u.h;
    w.h_left = h;
    u.h = h;
    u.e = e;
    u.hp = hp;
    u.ep = ep;
    hv[k] = (k == 0 || on) ? h : hv[0];
    pv[k] = hp;
    const bool cand = on && !out && (w.row_all || (w.row_last && last_col));
    if constexpr (O::stats) {
      // rows top to bottom, then columns: an equal H in an earlier row is
      // ahead (seg_better for cells that arrive in this order)
      if (cand && (h > L.bh || (h == L.bh && i < L.bi))) {
        L.bh = h;
        L.bi = i;
        L.bj = c;
        L.bp = hp;
      }
    } else if (cand && h > w.bh) {       // columns ascend within a row
      w.bh = h;
      w.bj = c;
    }
  }
  if constexpr (O::trace) {
    if (wide && ((c & 3) == 3 || last_col))
      short_lane_flush(L, trace0, rstride, c, last_col);
  }
  if constexpr (O::table || O::rowcol)
    short_lane_planes<kOut>(L, p, c, hv, pv, pl, vec, po);
  int32_t mx = L.hmax, mn = L.hmin;
PT_UNROLL
  for (int32_t k = 0; k + 1 < kR; k += 2) {
    mx = max3(mx, hv[k], hv[k + 1]);
    mn = min3(mn, hv[k], hv[k + 1]);
  }
  if constexpr (kR % 2 == 1) {
    mx = imax(mx, hv[kR - 1]);
    mn = imin(mn, hv[kR - 1]);
  }
  L.hmax = mx;
  L.hmin = mn;
  L.out = u;
}

// The lane's best cell and extremes, payload unpacked: the classes
// without stats fold their rows' first maxima by seg_better.
template <int32_t kR, class PO>
PT_HD SegBest short_lane_best(const ShortLane<kR, PO>& L, const PO& po) {
  SegBest b;
  b.h = L.bh;
  b.i = L.bi;
  b.j = L.bj;
  b.p = po.unpack(L.bp);
  PT_UNROLL
  for (int32_t k = 0; k < kR; ++k) {
    const ShortRow<PO>& w = L.row[k];
    if (w.bh != SEG_NONE && seg_better(w.bh, L.i0 + k, w.bj, b.h, b.i, b.j)) {
      b.h = w.bh;
      b.i = L.i0 + k;
      b.j = w.bj;
    }
  }
  b.hmax = L.hmax;
  b.hmin = L.hmin;
  return b;
}

// ---------------------------------------------------------------------------
// The banded warp form (csrc/scan_banded.cu; kernel K1e's score class):
// the band-only sweep of score_pair<OUT_SCORE, true> on the short form's
// step, with a pair's query rows as a RING of row blocks over a group of
// G lanes (G = 8, 16 or 32, so several pairs share a warp on narrow
// bands).  Row block k, query rows [k kR, k kR + kR), lives on lane
// k mod G; at step s it computes column s - k of its kR rows (cell, DPX
// max-plus), H, E and F in registers, and one shuffle from the ring's
// predecessor lane brings the bottom row of block k - 1.  A block sweeps
// only its band's columns, [k kR - bw, k kR + kR - 1 + bw] clipped to
// [0, rlen), and sets H of those cells outside the band to NEG_INF32, as
// the masked forms do (band_lane_step: E and F need no mask).  Block
// k + G starts on the lane after block k has ended exactly when 2 bw <
// (G - 1) kR + G + 1 (band_reach): block k ends at step hi_k + k, block
// k + G starts at step lo_{k+G} + k + G.  Wider bands take the masked
// full sweep (the short form or the block kernel, kBanded).
//
// What a block's rows read, so that every in-band cell equals
// score_pair's:
// - the row above at column c, on the top row: block k - 1's bottom row,
//   received a step after the predecessor computed it; block 0 reads the
//   masked top border.  Block k - 1 ends at column k kR - 1 + bw, so the
//   last kR columns of block k, which lie outside the band of the row
//   above, take NEG_INF32 there instead of the shuffle (by then the
//   predecessor may hold its next block);
// - the first diagonal: at a left edge lo = 0 the masked left border; at
//   lo > 0 the top row's is block k - 1's bottom row at lo - 1, received
//   the step before, and every other row's (and every row's left cell and
//   F) lies outside the band, NEG_INF32;
// - the end cell: each row's first maximum among its in-band candidates
//   above the pair's floor (SW 0, else NEG_INF32, score_pair's running
//   best), folded into the lane's best by seg_better when a block ends,
//   and across the group by seg_merge (H descending, i ascending, j
//   ascending);
// - the width-8/16 flags: score_pair's closed form for the cells outside
//   the band, which sets both whenever one exists (band_outside); else,
//   with no cell masked, the extremes of in-sequence H (never a padding
//   row; band_finish).
// A band wider than the padded pair is the whole pair (band_eff), so it
// is planned as max(Qp, Rp).

// The lanes' reach: the ring form takes 2 bw < band_reach(G, kR).
PT_HD int32_t band_reach(int32_t G, int32_t kR) {
  return (G - 1) * kR + G + 1;
}

// A band's half-width for the ring form: clamp_band's, and no wider than
// the padded pair (the same cells and borders).
PT_HD int32_t band_eff(int32_t bw, int32_t Qp, int32_t Rp) {
  return imin(clamp_band(bw, Qp, Rp), imax(Qp, Rp));
}

// The launcher's rule: G lanes a pair and kR rows a block for B pairs of
// Qp by Rp padded cells at half-width bw, or {0, 0} where no form reaches
// the band, or the table form's (A + 1)^2 scores do not fit a block's
// shared memory (BAND_TABLE_BYTES; the masked full sweep then runs).
// For each G the fewest rows kR of {4, 5, 6, 8} that reach; then the G
// whose cost is least (the fewer lanes on a tie).  A pair takes about
// Rp + Qp / kR steps of kR dependent cells, so its chain is kR Rp + Qp
// cells whatever G; the card
// runs B G lanes, and an SM keeps about BAND_LANES_SM of them busy, so
// past SEG_SMS * BAND_LANES_SM lanes the time grows with B G:
//   cost = (kR Rp + Qp) * max(B G, SEG_SMS * BAND_LANES_SM).
// cfg2 (8,192 pairs, Qp = Rp = 192, bw 16) gets G = 8, kR = 4; 128 pairs
// of 4,096 at bw 64 G = 32, kR = 4 (G = 16 would need 8 rows and half
// the lanes); G = 32 at kR = 8 reaches bw 140.
struct BandPlan {
  int32_t lanes, rows;
};

constexpr int32_t BAND_LANES_SM = 8 * SEG_LANES;
constexpr int64_t BAND_TABLE_BYTES = 32 * 1024;

PT_HD bool band_form(int32_t G, int32_t kR) {
  return (G == 8 || G == 16 || G == 32) &&
         (kR == 4 || kR == 5 || kR == 6 || kR == 8);
}

PT_HD BandPlan band_plan(int32_t B, int32_t Qp, int32_t Rp, int32_t bw,
                         int32_t A, bool profile) {
  bw = band_eff(bw, Qp, Rp);
  BandPlan best{0, 0};
  if (!profile && (int64_t)(A + 1) * (A + 1) * 4 > BAND_TABLE_BYTES)
    return best;
  int64_t best_cost = 0;
  for (int32_t G = 8; G <= SEG_LANES; G *= 2) {
    int32_t kR = 0;
    for (int32_t r = 4; r <= 8 && kR == 0; ++r)
      if (r != 7 && 2 * bw < band_reach(G, r)) kR = r;
    if (kR == 0) continue;
    const int64_t lanes = (int64_t)imax(B, 1) * G;
    const int64_t busy = (int64_t)SEG_SMS * BAND_LANES_SM;
    const int64_t cost =
        ((int64_t)kR * Rp + Qp) * (lanes > busy ? lanes : busy);
    if (best.lanes == 0 || cost < best_cost) {
      best = BandPlan{G, kR};
      best_cost = cost;
    }
  }
  return best;
}

// Substitution scores of the ring form: the (A + 1)^2 table a block
// stages (seg_table_at: a zero row and column for letters outside [0,
// A); row so = seg_col(q, A) (A + 1), letter column seg_col(r, A)), or
// (kProfile) the pair's (Qp, A) profile rows, read through L1 (row so =
// i A, letter column r, -1 outside [0, A), which scores 0).  A step finds
// its letter's column once (col) and each row's score with one load (at).
template <bool kProfile>
struct BandScores {
  const int32_t* sc;
  int32_t A;
  PT_HD int32_t row(const int32_t* q, int32_t i) const {
    return kProfile ? i * A : seg_col(q[i], A) * (A + 1);
  }
  PT_HD int32_t col(int32_t r) const {
    return kProfile ? ((r >= 0 && r < A) ? r : -1) : seg_col(r, A);
  }
  PT_HD int32_t at(int32_t so, int32_t c) const {
    return (kProfile && c < 0) ? 0 : sc[so + c];
  }
};

// A pair of the ring form: the segment form's configuration (one segment
// of all rlen columns), the band, its last block with columns, the steps
// until that block ends, and whether the saturation flags need the
// extremes (track: every in-sequence cell lies in the band; otherwise the
// closed form sets both flags).
struct BandPair {
  SegPair p;
  int32_t rp, bw;
  int32_t kl;          // the last block with columns (-1: none)
  int32_t steps;       // hi_kl + kl + 1
  bool track;
};

PT_HD int32_t band_lo(int32_t i0, int32_t bw) { return imax(0, i0 - bw); }

PT_HD int32_t band_hi(int32_t i0, int32_t kR, int32_t rlen, int32_t bw) {
  return imin(rlen - 1, i0 + kR - 1 + bw);
}

// The closed form of score_pair<OUT_SCORE, true>'s saturation flags: an
// in-sequence cell outside the band counts as H = NEG_INF32.
PT_HD bool band_outside(int32_t qlen, int32_t rlen, int32_t bw) {
  return qlen > 0 && rlen > 0 && imax(qlen, rlen) - 1 > bw;
}

PT_HD BandPair band_pair(int32_t qlen, int32_t rlen, int32_t qp, int32_t rp,
                         int32_t open, int32_t ext, int32_t mode,
                         int32_t free_bits, int32_t A, int32_t bw,
                         int32_t kR) {
  BandPair bp;
  bp.p = seg_pair(qlen, imin(rlen, rp), qp, 0, rp, open, ext, mode,
                  free_bits, false, A);
  bp.rp = rp;
  bp.bw = bw;
  bp.kl = -1;
  bp.steps = 0;
  bp.track = !band_outside(bp.p.qlen, bp.p.rlen, bw);
  if (bw >= 0 && bp.p.qlen > 0 && bp.p.rlen > 0) {
    // block k has columns while k kR - bw <= rlen - 1
    bp.kl = imin(seg_div_up(bp.p.qlen, kR) - 1,
                 (bp.p.rlen - 1 + bw) / kR);
    bp.steps = band_hi(bp.kl * kR, kR, bp.p.rlen, bw) + bp.kl + 1;
  }
  return bp;
}

// One query row of a block.
struct BandRow {
  int32_t h_left = 0, f = NEG_INF32, h_diag = 0;
  int32_t so = 0;                  // its scores (BandScores)
  bool row_all = false, row_last = false;   // the row's candidates
  int32_t bh = 0, bj = -1;         // its first maximum in the block (bj -1:
                                   // none above the floor)
};

// One lane of the ring: its current block kb, rows i0 .. i0 + kR - 1
// (nr of them in the pair), columns [lo, hi].
template <int32_t kR>
struct BandLane {
  int32_t kb = 0, i0 = 0, nr = 0, lo = 0, hi = -1;
  bool cands = false;              // a row of the block has candidates
  BandRow row[kR];
  int32_t out_h = NEG_INF32, out_e = NEG_INF32;   // bottom row, last step
  int32_t up_h = NEG_INF32;        // H received a step ago
  int32_t s_next[kR];              // the next step's scores
  int32_t so_next[kR];             // the rows' scores of the lane's next
                                   // block, loaded a block ahead
  SegBest best;
};

// The floor a candidate must pass, and the end cell when none does:
// score_pair's initial best (SW 0 at (0, 0); else NEG_INF32 at (qp, rp)).
PT_HD SegBest band_best_init(const BandPair& bp) {
  SegBest b;
  b.h = bp.p.local ? 0 : NEG_INF32;
  b.i = bp.p.local ? 0 : bp.p.qp;
  b.j = bp.p.local ? 0 : bp.rp;
  return b;
}

// The rows' scores of block kb (so_next), where the block has rows: rows
// past the pair take the block's first row's, and nothing reads them back.
template <int32_t kR, class Sc>
PT_HD void band_lane_rows(BandLane<kR>& L, const BandPair& bp, int32_t kb,
                          const int32_t* q, const Sc& sc) {
  if (kb > bp.kl) return;
  const int32_t i0 = kb * kR;
PT_UNROLL
  for (int32_t k = 0; k < kR; ++k)
    L.so_next[k] = sc.row(q, i0 + k < bp.p.qlen ? i0 + k : i0);
}

// Start block kb on a lane (its rows' scores in so_next): candidates (none
// on rows past the pair) and left edge; and load the scores of the lane's
// block after it, kb + G.
template <int32_t kR, class Sc>
PT_HD void band_lane_begin(BandLane<kR>& L, const BandPair& bp, int32_t kb,
                           int32_t G, const int32_t* q, const Sc& sc) {
  const SegPair& p = bp.p;
  L.kb = kb;
  L.i0 = kb * kR;
  L.nr = imax(0, imin(kR, p.qlen - L.i0));
  L.lo = band_lo(L.i0, bp.bw);
  L.hi = band_hi(L.i0, kR, p.rlen, bp.bw);
  L.cands = false;
  const int32_t floor = p.local ? 0 : NEG_INF32;
PT_UNROLL
  for (int32_t k = 0; k < kR; ++k) {
    BandRow& w = L.row[k];
    const int32_t i = L.i0 + k;
    const bool on = k < L.nr;
    w.so = L.so_next[k];
    const bool last_row = i == p.qlen - 1;
    w.row_all = on && (p.local || (last_row && p.qe));
    w.row_last = on && (last_row || p.de);
    L.cands = L.cands || w.row_all || w.row_last;
    w.h_left = w.h_diag = w.f = NEG_INF32;
    w.bh = floor;
    w.bj = -1;
  }
  if (L.lo == 0) {                 // the left border, on the first blocks
PT_UNROLL
    for (int32_t k = 0; k < kR; ++k) {
      L.row[k].h_left = band_border(L.i0 + k + 1, p.db, p.open, p.ext, bp.bw);
      L.row[k].h_diag = band_border(L.i0 + k, p.db, p.open, p.ext, bp.bw);
    }
  }
  band_lane_rows(L, bp, kb + G, q, sc);
}

// Column c of a lane's block: the rows' scores sk, (uh, ue) the cell above
// the top row.  H of a cell outside the band becomes NEG_INF32 (row k is
// in the band at column c when d - k lies in [0, 2 bw], d = c - i0 + bw:
// one unsigned compare); E and F outside it are not masked, since they
// reach no cell of the band: E runs down a column and F along a row,
// away from the band on its left side, and on its right side they come
// from masked H and the masked top (cells of the band take their H from
// a real diagonal, far above NEG_INF32, so those E and F never win).
// Candidates are tested where the block has candidate rows (a masked H is
// never above the floor), extremes where the pair tracks them (no cell is
// masked then; rows past the pair count as 0).
template <int32_t kR>
PT_HD void band_lane_step(BandLane<kR>& L, const BandPair& bp, int32_t c,
                          const int32_t (&sk)[kR], int32_t uh, int32_t ue) {
  const SegPair& p = bp.p;
  const int32_t d = c - L.i0 + bp.bw;
  const uint32_t width = 2u * (uint32_t)bp.bw;
  int32_t hv[kR];
PT_UNROLL
  for (int32_t k = 0; k < kR; ++k) {
    BandRow& w = L.row[k];
    int32_t h, e;
    cell(w.h_diag, uh, ue, w.h_left, sk[k], p.open, p.ext, p.local, w.f, h,
         e);
    h = (uint32_t)(d - k) <= width ? h : NEG_INF32;
    w.h_diag = uh;
    w.h_left = h;
    uh = h;
    ue = e;
    hv[k] = h;
  }
  L.out_h = uh;
  L.out_e = ue;
  if (L.cands) {
    const bool last_col = c == p.rlen - 1;
PT_UNROLL
    for (int32_t k = 0; k < kR; ++k) {
      BandRow& w = L.row[k];
      // columns ascend within a row: the first maximum stays
      if ((w.row_all || (w.row_last && last_col)) && hv[k] > w.bh) {
        w.bh = hv[k];
        w.bj = c;
      }
    }
  }
  if (bp.track) {
    int32_t mx = L.best.hmax, mn = L.best.hmin;
PT_UNROLL
    for (int32_t k = 0; k < kR; ++k) hv[k] = k < L.nr ? hv[k] : 0;
PT_UNROLL
    for (int32_t k = 0; k + 1 < kR; k += 2) {
      mx = max3(mx, hv[k], hv[k + 1]);
      mn = min3(mn, hv[k], hv[k + 1]);
    }
    if constexpr (kR % 2 == 1) {
      mx = imax(mx, hv[kR - 1]);
      mn = imin(mn, hv[kR - 1]);
    }
    L.best.hmax = mx;
    L.best.hmin = mn;
  }
}

// A block's rows' first maxima into the lane's best, when it ends (a
// block without candidate rows has none).
template <int32_t kR>
PT_HD void band_lane_fold(BandLane<kR>& L) {
  if (!L.cands) return;
PT_UNROLL
  for (int32_t k = 0; k < kR; ++k) {
    const BandRow& w = L.row[k];
    if (w.bj >= 0 &&
        seg_better(w.bh, L.i0 + k, w.bj, L.best.h, L.best.i, L.best.j)) {
      L.best.h = w.bh;
      L.best.i = L.i0 + k;
      L.best.j = w.bj;
    }
  }
}

// A lane's first block (its lane index in the group), before step -1.
template <int32_t kR, class Sc>
PT_HD void band_lane_start(BandLane<kR>& L, const BandPair& bp, int32_t gl,
                           int32_t G, const int32_t* q, const Sc& sc) {
  L.best = band_best_init(bp);
  L.kb = gl;
  if (gl <= bp.kl) {
    band_lane_rows(L, bp, gl, q, sc);
    band_lane_begin(L, bp, gl, G, q, sc);
  }
}

// The scores of column c1 of the lane's block into s_next, where the
// block has that column.
template <int32_t kR, class Sc>
PT_HD void band_lane_fetch(BandLane<kR>& L, int32_t c1,
                           const int32_t* letters, const Sc& sc) {
  if ((uint32_t)(c1 - L.lo) <= (uint32_t)(L.hi - L.lo)) {
    const int32_t col = sc.col(letters[c1]);
PT_UNROLL
    for (int32_t k = 0; k < kR; ++k) L.s_next[k] = sc.at(L.row[k].so, col);
  }
}

// Step s of a lane (s = -1 only fetches ahead): (raw_h, raw_e) is what
// the ring's predecessor left at step s - 1.  Fetches the scores of step
// s + 1 first, so that their loads run beside the cells; computes the
// lane's column s - kb where its block has it; and after the block's last
// column starts the lane's next block (kb + G), fetching its first column
// if step s + 1 has it.
template <int32_t kR, class Sc>
PT_HD void band_lane_iter(BandLane<kR>& L, const BandPair& bp, int32_t G,
                          int32_t s, int32_t raw_h, int32_t raw_e,
                          const int32_t* q, const int32_t* letters,
                          const Sc& sc) {
  if (L.kb <= bp.kl) {
    const int32_t c = s - L.kb;
    int32_t sk[kR];
PT_UNROLL
    for (int32_t k = 0; k < kR; ++k) sk[k] = L.s_next[k];
    band_lane_fetch(L, c + 1, letters, sc);
    if (s >= 0 && (uint32_t)(c - L.lo) <= (uint32_t)(L.hi - L.lo)) {
      const SegPair& p = bp.p;
      int32_t uh, ue;
      if (L.kb == 0) {
        uh = band_border(c + 1, p.qb, p.open, p.ext, bp.bw);
        ue = NEG_INF32;
      } else {
        // the row above is in its band up to column i0 - 1 + bw
        const bool above = c - (L.i0 - 1) <= bp.bw;
        uh = above ? raw_h : NEG_INF32;
        ue = above ? raw_e : NEG_INF32;
      }
      if (c == L.lo && L.lo > 0) L.row[0].h_diag = L.up_h;
      band_lane_step(L, bp, c, sk, uh, ue);
      if (c == L.hi) {
        band_lane_fold(L);
        if (L.kb + G <= bp.kl) {
          band_lane_begin(L, bp, L.kb + G, G, q, sc);
          band_lane_fetch(L, s + 1 - L.kb, letters, sc);
        } else {
          L.kb += G;
        }
      }
    }
  }
  L.up_h = raw_h;
}

// The pair's outputs from its group's merged best (band_best_init's
// floor, seg_merge): score_pair<OUT_SCORE, true>'s, empty sides and the
// closed-form saturation flags included.
PT_HD PairResult band_finish(const BandPair& bp, int32_t mode,
                             const SegBest& best) {
  const SegPair& p = bp.p;
  if (!p.local && (p.qlen == 0 || p.rlen == 0))
    return empty_side<true>(p.qlen, p.rlen, p.open, p.ext, p.qb, p.qe, p.db,
                            p.de, bp.bw);
  PairResult out{};
  out.score = best.h;
  out.end_query = mode == MODE_NW ? p.qlen - 1 : best.i;
  out.end_ref = mode == MODE_NW ? p.rlen - 1 : best.j;
  const bool outside = !bp.track;
  out.sat8 = (outside || best.hmax >= W8_MAX || best.hmin <= W8_MIN) ? 1 : 0;
  out.sat16 =
      (outside || best.hmax >= W16_MAX || best.hmin <= W16_MIN) ? 1 : 0;
  return out;
}

#if !defined(__CUDACC__)
// One pair's segment on the host: the kernel's lanes stepped in a loop.
// `cluster` blocks of `warps` warps of SEG_LANES lanes, kR rows a lane,
// take SEG_LANES * kR * warps * cluster rows abreast, as the kernel's
// cluster does: warp w of the chain (block w / warps, warp w % warps)
// runs SEG_LAG steps behind warp w - 1 and reads its last lane's bottom
// row from a ring of SEG_RING columns (the kernel's shared memory, in the
// reader's block); warps and lanes are stepped last first, so each reads
// what the one above left earlier.  The scores are staged as the kernel
// stages them (the profile rows of the whole pair at once: the values a
// block stages are the same).
//
//   subs, q, mq: the (A, A) table and the query letters, or the pair's
//                (qp, A) profile rows and null; PlaneIO::mq
//   ridx_seg:    the segment's reference letters (Rseg of them)
//   bottom:      scratch, 8 rows of Rseg: the last row of each group of
//                rows (H, E, and their payloads) for the next group
//   st_h, st_f:  the pair's state rows (qp each), updated in place
//   st_pay:      stats: its six payload rows, `pay_plane` apart
//   acc:         its accumulator (8)
//   trace:       trace form: the pair's (qp, rseg) flags of this segment
//
// The tile form (p.tile): `down` is the down-state, read above the tile's
// first row and left holding the tile's last row; the state rows and
// `trace` start at row p.row_lo; `t_in` / `t_out` are the corner words.
// The plane forms (the chunked form): `pl` is the pair's SegPlanes.
// kBanded: the masked one-shot form (one segment from column 0, p.bw).
template <int32_t kOut, int32_t kR, bool kBanded = false>
inline PairResult segment_pair_host(const int32_t* subs, const int32_t* q,
                                    const int32_t* mq,
                                    const int32_t* ridx_seg, int32_t rseg,
                                    const SegPair& p, int32_t mode,
                                    int32_t* bottom, int32_t* st_h,
                                    int32_t* st_f, int32_t* st_pay,
                                    int64_t pay_plane, int32_t* acc,
                                    int8_t* trace, int32_t warps,
                                    int32_t cluster, int32_t* down = nullptr,
                                    const int32_t* t_in = nullptr,
                                    int32_t* t_out = nullptr,
                                    const SegPlanes& pl = SegPlanes()) {
  using O = Out<kOut>;
  constexpr int32_t W = SEG_LANES;
  const int32_t A = p.A;
  // the scores staged as a block stages them, the profile rows of the
  // whole pair at once
  const int32_t cs = q ? 1 : seg_prof_stride(p.qp);
  std::vector<int32_t> sc(q ? (A + 1) * (A + 1) : (A + 1) * cs);
  if (q) {
    for (int32_t k = 0; k < (int32_t)sc.size(); ++k)
      sc[k] = seg_table_at(subs, A, k);
  } else {
    seg_stage_profile(sc.data(), subs, p.qp, A, p.qp, 0, 1);
  }
  SegBest total = seg_best_init(p);
  if (p.tile) tile_corner_out<kOut>(down, rseg, t_out);
  if (seg_sweeps(p)) {
    const int32_t chain = warps * cluster;
    const int32_t per_warp = W * kR;
    std::vector<SegLane<kOut, kR>> lanes(chain * W);
    std::vector<SegUp> old(chain * W);
    std::vector<SegUp> ring((int64_t)chain * SEG_RING);
    for (auto& L : lanes) L.best = seg_best_init(p);
    // the row above's H left of the segment (or tile)
    SegUp carry = p.tile ? tile_corner(t_in) : seg_corner<kBanded>(p);
    const int32_t group = chain * per_warp;
    const bool vec = p.qp % kR == 0;
    for (int32_t i0 = p.row_lo; i0 < p.row_hi; i0 += group) {
      for (int32_t x = 0; x < chain * W; ++x)
        seg_lane_begin<kBanded>(lanes[x], p, i0 + x * kR, q, 0, mq, st_h, st_f,
                       st_pay, pay_plane, old[x]);
      for (int32_t x = 0; x < chain * W; ++x)
        seg_lane_diag(lanes[x], x == 0 ? carry : old[x - 1]);
      carry = old[chain * W - 1];
      const int32_t nrows = imin(group, p.row_hi - i0);
      const int32_t nw = (nrows + per_warp - 1) / per_warp;  // with rows
      const bool feeds = i0 + group < p.row_hi;     // a group follows
      const int32_t total_steps = seg_group_steps(p.ncols, nw);
      for (int32_t g = 0; g < total_steps; ++g) {
        for (int32_t w = nw - 1; w >= 0; --w) {
          const int32_t t = seg_local_step(g, w);
          const int32_t nl =
              imin(W, (nrows - w * per_warp + kR - 1) / kR);
          if (t < 0 || t >= p.ncols + nl - 1) continue;
          for (int32_t l = nl - 1; l >= 0; --l) {
            const int32_t c = t - l;
            if (c < 0 || c >= p.ncols) continue;
            SegUp up;
            if (l > 0) {
              up = lanes[w * W + l - 1].out;
            } else if (w > 0) {
              up = ring[(int64_t)w * SEG_RING + c % SEG_RING];
            } else if (i0 == p.row_lo) {
              up = p.tile ? seg_up_load<kOut>(down, rseg, c)
                          : seg_top<kBanded>(p, p.off + c);
            } else {
              up = seg_up_load<kOut>(bottom, rseg, c);
            }
            SegLane<kOut, kR>& L = lanes[w * W + l];
            const int32_t r = ridx_seg[c];
            int32_t sk[kR];
            seg_lane_scores(L, sc.data(), seg_col(r, A) * cs, sk);
            seg_lane_step<kOut, kR, kBanded>(L, p, c, r, sk, up,
                          O::trace ? trace + (int64_t)(L.i0 - p.row_lo) * rseg
                                   : nullptr,
                          rseg, st_h, st_f, st_pay, pay_plane, pl,
                          p.tile ? down : nullptr, vec, rseg % 4 == 0);
            if (l == W - 1 && w + 1 < nw)
              ring[(int64_t)(w + 1) * SEG_RING + c % SEG_RING] = L.out;
            if (l == W - 1 && w == chain - 1 && feeds)
              seg_up_store<kOut>(bottom, rseg, c, L.out);
          }
        }
      }
      for (auto& L : lanes) seg_lane_fold(L);
    }
    for (const auto& L : lanes) total = seg_merge(total, L.best);
  }
  return seg_finish<kOut, kBanded>(p, mode, total, acc);
}

// One pair of the short form on the host, any class: the warp's SEG_LANES
// lanes stepped in a loop, last first, so that each reads what the lane
// above left a step earlier (the kernel's shuffle).  The scores are staged
// as the kernel stages them.
//
//   subs, q, mq: the (A, A) table and the query letters, or the pair's
//                (qp, A) profile rows and null; the stats letters
//   ridx:        the pair's reference letters
//   trace:       trace class: the pair's (qp, rstride) flag plane, 16
//                columns a store where `wide` (short_wide)
//   pl:          the plane classes: the pair's SegPlanes
// kBanded: the masked form (p.bw).
template <int32_t kOut, int32_t kR, bool kBanded = false, class PO>
inline PairResult short_pair_host(const int32_t* subs, const int32_t* q,
                                  const int32_t* mq, const int32_t* ridx,
                                  const SegPair& p, int32_t mode,
                                  int8_t* trace, int64_t rstride,
                                  bool wide, const PO& po,
                                  const SegPlanes& pl = SegPlanes()) {
  constexpr int32_t W = SEG_LANES;
  const int32_t A = p.A;
  const int32_t cs = q ? 1 : seg_prof_stride(imax(p.qp, 1));
  std::vector<int32_t> sc(short_score_words(q == nullptr, p.qp, A));
  if (q) {
    for (int32_t k = 0; k < (int32_t)sc.size(); ++k)
      sc[k] = seg_table_at(subs, A, k);
  } else {
    seg_stage_profile(sc.data(), subs, p.qp, A, imax(p.qp, 1), 0, 1);
  }
  SegBest total = seg_best_init(p);
  if (seg_sweeps(p)) {
    std::vector<ShortLane<kR, PO>> lanes(W);
    std::vector<ShortUp<PO>> old(W);
    for (int32_t x = 0; x < W; ++x)
      short_lane_begin<kOut, kBanded>(lanes[x], p, x, q, mq, po, old[x]);
    ShortUp<PO> corner;
    corner.h = seg_border<kBanded>(p, 0, p.qb);
    corner.hp = po.zero();
    for (int32_t x = 0; x < W; ++x)
      short_lane_diag(lanes[x], x == 0 ? corner : old[x - 1]);
    const int32_t nl = imin(W, seg_div_up(p.qlen, kR));
    for (int32_t t = 0; t < p.ncols + nl - 1; ++t) {
      for (int32_t l = nl - 1; l >= 0; --l) {
        const int32_t c = t - l;
        if (c < 0 || c >= p.ncols) continue;
        ShortLane<kR, PO>& L = lanes[l];
        const ShortUp<PO> up = l == 0 ? short_top<kBanded>(p, c, po)
                                      : lanes[l - 1].out;
        const int32_t r = ridx[c];
        int32_t sk[kR];
        short_lane_scores(L, sc.data(), seg_col(r, A) * cs, sk);
        short_lane_step<kOut, kBanded>(L, p, c, r, sk, up,
                              trace ? trace + L.i0 * rstride : nullptr,
                              rstride, wide, pl, short_vec_ok(kR, p.qp), po);
      }
    }
    for (const auto& L : lanes) {
      short_lane_last_col<kOut>(L, p, pl, short_vec_ok(kR, p.qp), po);
      total = seg_merge(total, short_lane_best(L, po));
    }
  }
  int32_t acc[8];
  return seg_finish<kOut, kBanded>(p, mode, total, acc);
}
// One pair of the banded warp form on the host: the ring's G lanes
// stepped in a loop, each reading what its predecessor left at the step
// before (the kernel's shuffle, from a copy taken before the step), for
// G idle steps past the pair's last, as a warp runs to its longest pair.
// The scores are laid out as the kernel has them (BandScores).
template <int32_t kR, class Sc>
inline PairResult band_pair_host(int32_t G, const Sc& sc, const int32_t* q,
                                 const int32_t* ridx, const BandPair& bp,
                                 int32_t mode) {
  std::vector<BandLane<kR>> lanes(G);
  for (int32_t gl = 0; gl < G; ++gl)
    band_lane_start(lanes[gl], bp, gl, G, q, sc);
  std::vector<int32_t> oh(G), oe(G);
  for (int32_t s = -1; s < bp.steps + G; ++s) {
    for (int32_t gl = 0; gl < G; ++gl) {
      oh[gl] = lanes[gl].out_h;
      oe[gl] = lanes[gl].out_e;
    }
    for (int32_t gl = 0; gl < G; ++gl) {
      const int32_t pred = (gl + G - 1) % G;
      band_lane_iter(lanes[gl], bp, G, s, oh[pred], oe[pred], q, ridx, sc);
    }
  }
  SegBest total = band_best_init(bp);
  for (const auto& L : lanes) total = seg_merge(total, L.best);
  return band_finish(bp, mode, total);
}

#endif

}  // namespace ptscore
