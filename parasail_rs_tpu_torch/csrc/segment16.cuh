// The block kernel's score class on Hopper's 16x2 DPX forms (kernel K2's
// segments and K1f's one-shot score launches): two pairs in each lane.
//
// A unit is two pairs of a launch (neighbours after a sort by (qlen,
// rlen), ops/scan_kernel.py::pair_units; an odd one out runs beside a
// copy of itself, whose outputs are dropped).  Every register of a lane
// holds the unit's two pairs as the low and high halves of one word: H,
// E, F, the diagonal and the scores.  Each cell of the recurrence
// (score_cell.cuh's cell()) is one 16x2 DPX instruction for both pairs:
//
//   E = max(H_up - open, E_up - ext)        __viaddmax_s16x2, twice
//   F = max(H_left - open, F - ext)         __viaddmax_s16x2, twice
//   H = max(max(diag + s, F) [, 0], E)      __viaddmax_s16x2(_relu), max
//
// so one __shfl_up_sync of the bottom row's H and E a step, one chain of
// kR rows and one step's bookkeeping serve both pairs.  The sweep covers
// the larger of the two shapes; each half keeps its own state over its
// own rows and columns (lane16_step's masks), so a half's cells past its
// pair are never candidates, extremes or state.
//
// Exactness.  The halves are int16 with wrapping adds, so a value is
// exact only while nothing wraps.  Band16 is the H range [lo, hi] inside
// which nothing can: its guard G = 2 (open + ext + bound) + 2, bound the
// largest |score|, exceeds any change one cell makes (E, F >= H - open >=
// lo - open; diag + s within bound of H), and the "-inf" (E above row 0,
// F before column 0) is -32768 + ext, which no value of a half inside the
// band falls to.  A half whose H leaves [lo, hi] anywhere in its cells,
// or whose borders or carried state lie outside it, sets its `over` bit:
// the first value to leave the band was computed from values inside it,
// so exactly, and is seen.  A half that never sets it has the int32
// form's values cell for cell, so its score, ends, sat8 and sat16 (0)
// and its state are the int32 form's.  The kernel writes `over` beside
// the scores (and carries it over segments in its own state row); the
// caller recomputes every such pair through the int32 form
// (dispatch.PendingResult), so no output bit differs from it.
//
// The end cell: SW keeps each row's first maximum (packed, __vibmax_s16x2
// and its two predicates for the columns), folded at a group's end by
// seg_better as the int32 form does; SW's extremes follow from it (H >= 0,
// every cell a candidate).  NW and SG track the extremes packed (two rows
// an instruction) and take their few candidates (the last row with qe,
// the last column) on a branch that is rarely taken.
//
// This step shares no code with score_cell.cuh's seg_lane_step; only the
// configuration (SegPair, seg_best_init, seg_merge, seg_finish) and the
// launch rule (seg_plan) are the int32 form's.  The CUDA kernel is below
// the lane code; segment16_unit_host, for the CPU tests, steps the same
// lanes in a loop on int16 halves.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "score_cell.cuh"

#if defined(__CUDACC__)
#include "segment_block.cuh"
#endif

namespace ptseg16 {

using ptscore::imax;
using ptscore::imin;
using ptscore::SegBest;

// --- 16x2 max-plus ----------------------------------------------------------

PT_HD uint32_t pk(int32_t lo, int32_t hi) {
  return (uint32_t)(uint16_t)lo | ((uint32_t)(uint16_t)hi << 16);
}

PT_HD int32_t half(uint32_t v, int32_t k) {
  return (int16_t)(uint16_t)(k ? v >> 16 : v);
}

PT_HD uint32_t dup(int32_t v) { return pk(v, v); }

// two 32-bit scores, each in 16 bits, into one word (PRMT)
PT_HD uint32_t pack2(int32_t lo, int32_t hi) {
#if defined(__CUDA_ARCH__)
  return __byte_perm((uint32_t)lo, (uint32_t)hi, 0x5410);
#else
  return pk(lo, hi);
#endif
}

#if !defined(__CUDA_ARCH__)
PT_HD int32_t wrap16(int32_t v) { return (int16_t)(uint16_t)v; }
#endif

// max(a + b, c) per half, the add wrapping
PT_HD uint32_t addmax2(uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  return __viaddmax_s16x2(a, b, c);
#else
  return pk(imax(wrap16(half(a, 0) + half(b, 0)), half(c, 0)),
            imax(wrap16(half(a, 1) + half(b, 1)), half(c, 1)));
#endif
}

// max(a + b, c, 0) per half: SW's clamp
PT_HD uint32_t addmax2_relu(uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  return __viaddmax_s16x2_relu(a, b, c);
#else
  const uint32_t m = addmax2(a, b, c);
  return pk(imax(half(m, 0), 0), imax(half(m, 1), 0));
#endif
}

PT_HD uint32_t max2(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __vmaxs2(a, b);
#else
  return pk(imax(half(a, 0), half(b, 0)), imax(half(a, 1), half(b, 1)));
#endif
}

PT_HD uint32_t min2(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __vmins2(a, b);
#else
  return pk(imin(half(a, 0), half(b, 0)), imin(half(a, 1), half(b, 1)));
#endif
}

PT_HD uint32_t max3_2(uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  return __vimax3_s16x2(a, b, c);
#else
  return max2(max2(a, b), c);
#endif
}

PT_HD uint32_t min3_2(uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  return __vimin3_s16x2(a, b, c);
#else
  return min2(min2(a, b), c);
#endif
}

// min(a, b, c) per unsigned half
PT_HD uint32_t umin3_2(uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  return __vimin3_u16x2(a, b, c);
#else
  auto lo = [](uint32_t v) { return v & 0xffffu; };
  auto hi = [](uint32_t v) { return v >> 16; };
  const uint32_t l = lo(a) < lo(b) ? lo(a) : lo(b);
  const uint32_t h = hi(a) < hi(b) ? hi(a) : hi(b);
  return (l < lo(c) ? l : lo(c)) | ((h < hi(c) ? h : hi(c)) << 16);
#endif
}

// 0xffff in each half where a and b differ, else 0: min(a ^ b, 1) per
// unsigned half, times 0xffff (the halves cannot carry into each other)
PT_HD uint32_t differ2(uint32_t a, uint32_t b) {
  return umin3_2(a ^ b, 0x00010001u, 0x00010001u) * 0xffffu;
}

// lanes of a mask word: half k's 16 bits where `on`
PT_HD uint32_t lanes2(bool on0, bool on1) {
  return (on0 ? 0x0000ffffu : 0u) | (on1 ? 0xffff0000u : 0u);
}

// a where m, else b (one LOP3)
PT_HD uint32_t sel2(uint32_t m, uint32_t a, uint32_t b) {
  return (a & m) | (b & ~m);
}

constexpr uint32_t kFloor = 0x80008000u;    // -32768, both halves
constexpr int32_t kNone16 = -32768;         // no candidate in a row yet

// --- the band ---------------------------------------------------------------

// Scores of up to this |value| and penalties with this sum keep a band:
// larger ones go to the int32 form directly (dispatch).
constexpr int32_t SEG16_MAX_GUARD = 8192;

struct Band16 {
  int32_t lo, hi;       // H of a half that never left [lo, hi] is exact
  uint32_t neg;         // -inf of both halves
};

PT_HD int32_t guard16(int32_t open, int32_t ext, int32_t bound) {
  return 2 * (open + ext + bound) + 2;
}

PT_HD Band16 band16(int32_t open, int32_t ext, int32_t bound) {
  const int32_t g = guard16(open, ext, bound);
  return Band16{-32768 + g, 32767 - g, dup(-32768 + ext)};
}

// Can a launch at these penalties and scores run packed at all?
PT_HD bool seg16_usable(int32_t open, int32_t ext, int32_t bound) {
  return open >= 0 && ext >= 0 && bound >= 0 && open <= SEG16_MAX_GUARD &&
         ext <= SEG16_MAX_GUARD && bound <= SEG16_MAX_GUARD &&
         guard16(open, ext, bound) <= SEG16_MAX_GUARD;
}

// --- a unit -----------------------------------------------------------------

// Two pairs of one segment.  A half that sweeps nothing in the segment
// (an empty side, or a reference that ended before it) has qlen and ncols
// 0 here, so it keeps its state, as the int32 form's pair does.
struct Unit16 {
  int32_t pair[2];      // the batch's pairs; pair[1] == pair[0]: none beside
  bool two;             // the second half is a pair of its own
  int32_t qlen[2], ncols[2], lastc[2];    // lastc: c of the reference's
                                          // last column, else -2
  int32_t row_hi, ncols_max, ncols_min, qmin;
  int32_t off, open, ext;
  bool qb, qe, db, de, resume;
  Band16 band;
  int32_t over;         // bit k: half k's borders leave the band
};

PT_HD Unit16 unit16(const int32_t* units, int32_t u, const int32_t* qlen,
                    const int32_t* rlen, int32_t qp, int32_t off,
                    int32_t rseg, int32_t open, int32_t ext, int32_t mode,
                    int32_t free_bits, bool resume, int32_t A,
                    int32_t bound) {
  Unit16 U;
  U.pair[0] = units[2 * u];
  U.two = units[2 * u + 1] >= 0;
  U.pair[1] = U.two ? units[2 * u + 1] : U.pair[0];
  U.off = off;
  U.open = open;
  U.ext = ext;
  U.resume = resume;
  U.band = band16(open, ext, bound);
  U.over = 0;
  U.row_hi = U.ncols_max = 0;
  U.ncols_min = U.qmin = 1 << 30;
PT_UNROLL
  for (int32_t k = 0; k < 2; ++k) {
    const ptscore::SegPair p =
        ptscore::seg_pair(qlen[U.pair[k]], rlen[U.pair[k]], qp, off, rseg,
                          open, ext, mode, free_bits, resume, A);
    U.qb = p.qb;
    U.qe = p.qe;
    U.db = p.db;
    U.de = p.de;
    const bool sweeps = ptscore::seg_sweeps(p);
    U.qlen[k] = sweeps ? p.qlen : 0;
    U.ncols[k] = sweeps ? p.ncols : 0;
    U.lastc[k] = sweeps && p.rlen - 1 - off < p.ncols ? p.rlen - 1 - off : -2;
    U.row_hi = imax(U.row_hi, U.qlen[k]);
    U.ncols_max = imax(U.ncols_max, U.ncols[k]);
    U.ncols_min = imin(U.ncols_min, U.ncols[k]);
    U.qmin = imin(U.qmin, U.qlen[k]);
    // the borders a half reads, each at its lowest: the top row's at its
    // last column, the left column's (first segment) at its last row
    if (sweeps &&
        (ptscore::border(off + p.ncols, p.qb, open, ext) < U.band.lo ||
         (!resume &&
          ptscore::border(p.qlen, p.db, open, ext) < U.band.lo)))
      U.over |= 1 << k;
  }
  return U;
}

// --- a lane -----------------------------------------------------------------

// One lane: rows i0 .. i0 + kR - 1 of the current group, both halves.
template <int32_t kR, bool kLocal, bool kPair>
struct Lane16 {
  int32_t i0 = 0;
  int32_t nr = 0;                    // rows below the unit's row_hi
  bool full = false;                 // every row in both halves
  bool cand = false;                 // !kLocal: a row with candidates
  uint32_t hl[kR], f[kR], hd[kR];    // H to the left, F, diagonal
  int32_t sa[kR];                    // scores: the pair table's row, or
  int32_t sb[kPair ? 1 : kR];        // each half's row (profile: both)
  uint32_t bh[kLocal ? kR : 1];      // kLocal: each row's first maximum
  uint32_t bj[kLocal ? kR : 1];      // and its columns in the segment
  uint32_t mx = 0, mn = 0;           // !kLocal: extremes of H
  uint32_t oh = 0, oe = 0;           // the bottom row's last cell
  SegBest best[2];
  int32_t over = 0;
};

template <int32_t kR, bool kLocal, bool kPair>
PT_HD void lane16_init(Lane16<kR, kLocal, kPair>& L,
                       const SegBest& init) {
  L.best[0] = L.best[1] = init;
  L.mx = L.mn = 0;
  L.over = 0;
  // rows past the unit's keep what they hold; their score rows must stay
  // inside the staged scores
  for (int32_t k = 0; k < kR; ++k) {
    L.hl[k] = L.f[k] = L.hd[k] = 0;
    L.sa[k] = 0;
    if constexpr (!kPair) L.sb[k] = 0;
    if constexpr (kLocal) {
      L.bh[k] = dup(kNone16);
      L.bj[k] = 0;
    }
  }
}

// A query letter's row of the staged table (seg_col's last row: 0).
PT_HD int32_t qcol(int32_t q, int32_t A) { return (q >= 0 && q < A) ? q : A; }

// Start a lane's rows (score_cell.cuh's seg_lane_begin, both halves):
// their score rows (the pair table: row (q0, q1); the table: each half's
// letter's row; the profile: staged row i - prof_row0), candidates, and
// the column left of the segment: the carried state (checked against the
// band) or the bordered left column.  `old` receives the bottom row's H
// left of the segment, for the lane below.
template <int32_t kR, bool kLocal, bool kPair>
PT_HD void lane16_begin(Lane16<kR, kLocal, kPair>& L, const Unit16& U,
                        int32_t i0, const int32_t* q0, const int32_t* q1,
                        int32_t prof_row0, int32_t A,
                        const int32_t* const (&st_h)[2],
                        const int32_t* const (&st_f)[2], uint32_t& old) {
  const int32_t A1 = A + 1;
  L.i0 = i0;
  L.nr = imax(0, imin(kR, U.row_hi - i0));
  L.full = i0 + kR <= U.qmin;
  L.cand = false;
  old = U.band.neg;
PT_UNROLL
  for (int32_t k = 0; k < kR; ++k) {
    if (k >= L.nr) continue;
    const int32_t i = i0 + k;
    if (q0 == nullptr) {
      L.sa[k] = ptscore::seg_pad(i - prof_row0);
      if constexpr (!kPair) L.sb[k] = L.sa[k];
    } else if constexpr (kPair) {
      L.sa[k] = (qcol(q0[i], A) * A1 + qcol(q1[i], A)) * A1 * A1;
    } else {
      L.sa[k] = qcol(q0[i], A) * A1;
      L.sb[k] = qcol(q1[i], A) * A1;
    }
    int32_t h[2], f[2];
PT_UNROLL
    for (int32_t x = 0; x < 2; ++x) {
      h[x] = f[x] = 0;
      if (i >= U.qlen[x]) continue;
      if (!kLocal && i == U.qlen[x] - 1 && U.qe) L.cand = true;
      if (U.resume) {
        h[x] = st_h[x][i];
        f[x] = st_f[x][i];
        if (h[x] < U.band.lo || h[x] > U.band.hi ||
            f[x] < U.band.lo - U.open || f[x] > U.band.hi)
          L.over |= 1 << x;
      } else {
        h[x] = ptscore::border(i + 1, U.db, U.open, U.ext);
        f[x] = half(U.band.neg, 0);
      }
    }
    L.hl[k] = pk(h[0], h[1]);
    L.f[k] = pk(f[0], f[1]);
    if (k + 1 < kR) L.hd[k + 1] = L.hl[k];
    old = L.hl[k];
  }
}

// The diagonal of the lane's top row: the lane above's `old`.
template <int32_t kR, bool kLocal, bool kPair>
PT_HD void lane16_diag(Lane16<kR, kLocal, kPair>& L, uint32_t above) {
  L.hd[0] = above;
}

// The rows' scores against the letters of word lw (half k's letter column
// in bits 16k..16k+15): sc[sa + c0 * A1 + c1] from the pair table, else
// each half's score from its own row, c * cs past it, packed.
template <int32_t kR, bool kLocal, bool kPair>
PT_HD void lane16_scores(const Lane16<kR, kLocal, kPair>& L,
                         const int32_t* sc, uint32_t lw, int32_t A1,
                         int32_t cs, uint32_t (&s)[kR]) {
  const int32_t c0 = (int32_t)(lw & 0xffffu), c1 = (int32_t)(lw >> 16);
  if constexpr (kPair) {
    const int32_t x = c0 * A1 + c1;
PT_UNROLL
for (int32_t k = 0; k < kR; ++k) s[k] = (uint32_t)sc[L.sa[k] + x];
  } else {
    const int32_t x0 = c0 * cs, x1 = c1 * cs;
PT_UNROLL
    for (int32_t k = 0; k < kR; ++k)
      s[k] = pack2(sc[L.sa[k] + x0], sc[L.sb[k] + x1]);
  }
}

// The candidates of the non-local modes at column c (rare: the last row
// with qe, the last column): each half's in its own cells, scalar, in the
// order cells arrive in a lane (columns, then rows top to bottom).
template <int32_t kR, bool kLocal, bool kPair>
PT_HD void lane16_cands(Lane16<kR, kLocal, kPair>& L, const Unit16& U,
                        int32_t c, const uint32_t (&hv)[kR]) {
  const int32_t jg = U.off + c;
PT_UNROLL
  for (int32_t k = 0; k < kR; ++k) {
    const int32_t i = L.i0 + k;
PT_UNROLL
    for (int32_t x = 0; x < 2; ++x) {
      if (i >= U.qlen[x] || c >= U.ncols[x]) continue;
      const bool last_row = i == U.qlen[x] - 1;
      const bool last_col = c == U.lastc[x];
      if (!((last_row && U.qe) || ((last_row || U.de) && last_col))) continue;
      const int32_t v = half(hv[k], x);
      SegBest& b = L.best[x];
      if (v > b.h || (v == b.h && i < b.i)) {
        b.h = v;
        b.i = i;
        b.j = jg;
      }
    }
  }
}

// The rows' H and F at a half's last column of the segment, widened, into
// its state rows.
template <int32_t kR, bool kLocal, bool kPair>
PT_HD void lane16_state(const Lane16<kR, kLocal, kPair>& L, const Unit16& U,
                        int32_t c, const uint32_t (&hv)[kR],
                        int32_t* const (&st_h)[2],
                        int32_t* const (&st_f)[2]) {
PT_UNROLL
  for (int32_t x = 0; x < 2; ++x) {
    if (c != U.ncols[x] - 1 || (x == 1 && !U.two)) continue;
PT_UNROLL
    for (int32_t k = 0; k < kR; ++k) {
      const int32_t i = L.i0 + k;
      if (i < U.qlen[x]) {
        st_h[x][i] = half(hv[k], x);
        st_f[x][i] = half(L.f[k], x);
      }
    }
  }
}

// One step of a lane: column c of its rows, both halves, the scores s
// (lane16_scores), (uh, ue) the cell above its top row.  Leaves the
// bottom row's cell in L.oh / L.oe.
template <int32_t kR, bool kLocal, bool kPair>
PT_HD void lane16_step(Lane16<kR, kLocal, kPair>& L, const Unit16& U,
                       int32_t c, const uint32_t (&s)[kR], uint32_t uh,
                       uint32_t ue, int32_t* const (&st_h)[2],
                       int32_t* const (&st_f)[2]) {
  const uint32_t nopen = dup(-U.open), next = dup(-U.ext);
  uint32_t hv[kR];
PT_UNROLL
  for (int32_t k = 0; k < kR; ++k) {
    const uint32_t e = addmax2(uh, nopen, addmax2(ue, next, kFloor));
    const uint32_t f = addmax2(L.hl[k], nopen, addmax2(L.f[k], next, kFloor));
    const uint32_t a = kLocal ? addmax2_relu(L.hd[k], s[k], f)
                              : addmax2(L.hd[k], s[k], f);
    const uint32_t h = max2(a, e);
    L.f[k] = f;
    L.hd[k] = uh;
    L.hl[k] = h;
    hv[k] = h;
    uh = h;
    ue = e;
  }
  L.oh = uh;
  L.oe = ue;
  // SW: a row's first maximum moves only on a larger H, and its column
  // with it (in the halves where the maximum changed)
  const uint32_t cc = dup(c);
  if (L.full && c < U.ncols_min) {
    // every row and this column in both halves
    if constexpr (kLocal) {
PT_UNROLL
      for (int32_t k = 0; k < kR; ++k) {
        const uint32_t b = max2(L.bh[k], hv[k]);
        L.bj[k] = sel2(differ2(b, L.bh[k]), cc, L.bj[k]);
        L.bh[k] = b;
      }
    } else {
      uint32_t mx = L.mx, mn = L.mn;
PT_UNROLL
      for (int32_t k = 0; k + 1 < kR; k += 2) {
        mx = max3_2(mx, hv[k], hv[k + 1]);
        mn = min3_2(mn, hv[k], hv[k + 1]);
      }
      L.mx = mx;
      L.mn = mn;
    }
  } else {
    // a half's rows or columns end in the lane: each half over its own
    const uint32_t cm = lanes2(c < U.ncols[0], c < U.ncols[1]);
PT_UNROLL
    for (int32_t k = 0; k < kR; ++k) {
      const int32_t i = L.i0 + k;
      const uint32_t m = cm & lanes2(i < U.qlen[0], i < U.qlen[1]);
      if constexpr (kLocal) {
        const uint32_t b = max2(L.bh[k], sel2(m, hv[k], kFloor));
        L.bj[k] = sel2(differ2(b, L.bh[k]), cc, L.bj[k]);
        L.bh[k] = b;
      } else {
        L.mx = max2(L.mx, sel2(m, hv[k], L.mx));
        L.mn = min2(L.mn, sel2(m, hv[k], L.mn));
      }
    }
  }
  if constexpr (!kLocal)
    if (L.cand || c == U.lastc[0] || c == U.lastc[1]) lane16_cands(L, U, c, hv);
  if (c == U.ncols[0] - 1 || c == U.ncols[1] - 1)
    lane16_state(L, U, c, hv, st_h, st_f);
}

// Fold each row's first maximum of the group into the lane's best of its
// half (kLocal), as seg_lane_fold; at the end of every group of rows.
template <int32_t kR, bool kLocal, bool kPair>
PT_HD void lane16_fold(Lane16<kR, kLocal, kPair>& L, int32_t off) {
  if constexpr (kLocal) {
PT_UNROLL
for (int32_t k = 0; k < kR; ++k) {
PT_UNROLL
PT_UNROLL
      for (int32_t x = 0; x < 2; ++x) {
        const int32_t v = half(L.bh[k], x);
        const int32_t j = off + (int32_t)((x ? L.bj[k] >> 16 : L.bj[k]) &
                                          0xffffu);
        SegBest& b = L.best[x];
        if (v != kNone16 &&
            ptscore::seg_better(v, L.i0 + k, j, b.h, b.i, b.j)) {
          b.h = v;
          b.i = L.i0 + k;
          b.j = j;
        }
        b.hmax = imax(b.hmax, v);
      }
      L.bh[k] = dup(kNone16);
    }
  }
}

// The lane's extremes and band flags once its last group is done: SW's
// maximum is its best's (every cell a candidate, H >= 0), its minimum 0.
template <int32_t kR, bool kLocal, bool kPair>
PT_HD void lane16_finish(Lane16<kR, kLocal, kPair>& L, const Band16& band) {
PT_UNROLL
  for (int32_t x = 0; x < 2; ++x) {
    SegBest& b = L.best[x];
    if constexpr (!kLocal) {
      b.hmax = imax(b.hmax, half(L.mx, x));
      b.hmin = imin(b.hmin, half(L.mn, x));
    }
    if (b.hmax > band.hi || b.hmin < band.lo) L.over |= 1 << x;
  }
}

// --- launch geometry --------------------------------------------------------

// Pair-table scores: the table form whose (A + 1)^4 packed pairs of
// scores fit this many words (DNA's 4 letters: 625); then a row's score
// is one load, else two and a PRMT.
constexpr int32_t SEG16_PAIR_WORDS = 4096;

PT_HD bool seg16_pair_table(bool profile, int32_t A) {
  const int32_t A1 = A + 1;
  return !profile && A1 * A1 * A1 * A1 <= SEG16_PAIR_WORDS;
}

PT_HD int64_t seg16_score_words(bool profile, int32_t rows, int32_t warps,
                                int32_t Qs, int32_t A) {
  const int64_t A1 = A + 1;
  if (seg16_pair_table(profile, A)) return A1 * A1 * A1 * A1;
  return ptscore::seg_score_words(profile, rows, warps, Qs, A);
}

// words of a pair's best in the exchange between warps: per half h, i, j,
// hmax, hmin; then the over bits
constexpr int32_t kBest16 = 11;

PT_HD int64_t seg16_block_bytes(bool profile, int32_t rows, int32_t warps,
                                int32_t cluster, int32_t A, int32_t Qs,
                                int32_t ncols) {
  return 4 * (seg16_score_words(profile, rows, warps, Qs, A) +
              ptscore::seg_letter_ring(ncols) +
              (int64_t)warps * 2 * ptscore::SEG_RING +
              (int64_t)warps * cluster * (1 + kBest16));
}

// The plan of a launch of U units: seg_plan's rule on the units, warps
// halved while the block's shared memory passes SEG_SMEM_BUDGET.
PT_HD ptscore::SegPlan seg16_plan(int32_t U, int32_t Qs, int32_t ncols,
                                  int32_t A, bool profile, int32_t warps,
                                  int32_t rows, int32_t cluster) {
  ptscore::SegPlan p = ptscore::seg_plan(ptscore::OUT_SCORE, U, Qs, ncols, A,
                                         profile, warps, rows, cluster);
  if (warps <= 0)
    while (p.warps > 1 &&
           seg16_block_bytes(profile, p.rows, p.warps, p.cluster, A, Qs,
                             ncols) > ptscore::SEG_SMEM_BUDGET)
      p.warps /= 2;
  return p;
}

// The outputs of half x: seg_finish over its pair's accumulator, its over
// bit (carried in `over`, read if resume) beside them.
PT_HD void unit16_finish(const Unit16& U, int32_t x, const SegBest& swept,
                         int32_t over_bits, const int32_t* qlen,
                         const int32_t* rlen, int32_t qp, int32_t rseg,
                         int32_t mode, int32_t free_bits, int32_t A,
                         int32_t* acc, int32_t* over, int32_t* out,
                         int32_t B) {
  const int32_t b = U.pair[x];
  const ptscore::SegPair p =
      ptscore::seg_pair(qlen[b], rlen[b], qp, U.off, rseg, U.open, U.ext,
                        mode, free_bits, U.resume, A);
  SegBest total = ptscore::seg_best_init(p);
  if (U.qlen[x] > 0) total = ptscore::seg_merge(total, swept);
  const ptscore::PairResult r = ptscore::seg_finish<ptscore::OUT_SCORE>(
      p, mode, total, acc + (int64_t)b * 8);
  const int32_t o =
      ((over_bits >> x) & 1) | (U.resume ? (over[b] != 0 ? 1 : 0) : 0);
  over[b] = o;
  out[b] = r.score;
  out[B + b] = r.end_query;
  out[2 * B + b] = r.end_ref;
  out[3 * B + b] = r.sat8;
  out[4 * B + b] = r.sat16;
  out[5 * B + b] = o;
}

// Everything a launch passes, by value.
struct Seg16Args {
  const int32_t* subs;    // (A, A) table or (1, Qp, A) profile rows
  const int32_t* qidx;    // (Bq, Qp) letters; null: profile
  const int32_t* ridx;    // (B, Rseg): this segment's letters
  const int32_t* qlen;    // (B,)
  const int32_t* rlen;    // (B,) global reference lengths
  const int32_t* units;   // (U, 2) pairs, -1: none beside
  uint32_t* bottom;       // (U, 2, Rseg) scratch
  int32_t* st_h;          // (B, Qp) state, in place
  int32_t* st_f;          // (B, Qp)
  int32_t* acc;           // (B, 8)
  int32_t* over;          // (B,) the band's flag, carried
  int32_t* out;           // (6, B)
  int32_t U, B, Bq, Qp, Rseg, A, open, ext, mode, free_bits, off, resume;
  int32_t bound;          // the largest |score|
  int32_t cluster;        // blocks a unit
};

#if defined(__CUDACC__)

namespace cg = cooperative_groups;
using ptsegblock::kFull;

// kR rows a lane; kLocal SW's clamp and candidates; kPair the pair table.
// The NW / SG forms of 2 rows fit two blocks of eight warps an SM (128
// registers, no spill); the rest take one.
// The chain of warps, their lag and ring, the letters a round ahead, the
// first warp's staged rows above, the groups of rows and the barriers are
// segment_block.cuh's segment_kernel's (its header), on packed words.
template <int32_t kR, bool kLocal, bool kPair>
__global__ void __launch_bounds__(ptsegblock::kMaxThreads,
                                  kR <= 2 && !kLocal ? 2 : 1)
    segment_kernel(const Seg16Args a) {
  constexpr int32_t W = ptscore::SEG_LANES;
  constexpr int32_t RG = ptscore::SEG_RING;
  constexpr int32_t LAG = ptscore::SEG_LAG;
  extern __shared__ int32_t smem[];
  const int32_t C = a.cluster;
  const int32_t warps = blockDim.x / W;
  const int32_t w = threadIdx.x / W;
  const int32_t lane = threadIdx.x & (W - 1);
  const int32_t rank = C > 1 ? (int32_t)cg::this_cluster().block_rank() : 0;
  const int32_t u = blockIdx.x / C;
  const int32_t chain = C * warps;
  const int32_t wg = rank * warps + w;
  const int32_t wg0 = rank * warps;
  const bool profile = a.qidx == nullptr;
  const int32_t A = a.A, A1 = A + 1;
  const int32_t per_warp = W * kR;
  const int32_t per_block = warps * per_warp;
  const int32_t prof_rows = ptscore::seg_prof_rows(kR, warps, a.Qp);
  const int32_t cs = profile ? ptscore::seg_prof_stride(prof_rows) : 1;
  const int32_t LR = ptscore::seg_letter_ring(a.Rseg);
  int32_t* sc = smem;
  int32_t* letters = sc + seg16_score_words(profile, kR, warps, a.Qp, A);
  uint32_t* ring = (uint32_t*)(letters + LR);      // (warps, 2, RG)
  uint32_t* olds = ring + warps * 2 * RG;          // (chain)
  int32_t* bests = (int32_t*)(olds + chain);       // (chain, kBest16)
  const Unit16 U = unit16(a.units, u, a.qlen, a.rlen, a.Qp, a.off, a.Rseg,
                          a.open, a.ext, a.mode, a.free_bits, a.resume != 0,
                          A, a.bound);
  const int32_t Rseg = a.Rseg;
  const int32_t* prow = profile ? a.subs : nullptr;
  const int32_t* q0 =
      profile ? nullptr : a.qidx + (a.Bq == 1 ? 0 : (int64_t)U.pair[0] * a.Qp);
  const int32_t* q1 =
      profile ? nullptr : a.qidx + (a.Bq == 1 ? 0 : (int64_t)U.pair[1] * a.Qp);
  const int32_t* r0 = a.ridx + (int64_t)U.pair[0] * Rseg;
  const int32_t* r1 = a.ridx + (int64_t)U.pair[1] * Rseg;
  uint32_t* bot = a.bottom + (int64_t)u * 2 * Rseg;
  int32_t* const st_h[2] = {a.st_h + (int64_t)U.pair[0] * a.Qp,
                            a.st_h + (int64_t)U.pair[1] * a.Qp};
  int32_t* const st_f[2] = {a.st_f + (int64_t)U.pair[0] * a.Qp,
                            a.st_f + (int64_t)U.pair[1] * a.Qp};
  const int32_t* const ld_h[2] = {st_h[0], st_h[1]};
  const int32_t* const ld_f[2] = {st_f[0], st_f[1]};
  if (!profile) {
    if constexpr (kPair) {
      const int32_t AA = A1 * A1;
      for (int32_t k = threadIdx.x; k < AA * AA; k += blockDim.x) {
        const int32_t qq = k / AA, rr = k % AA;
        sc[k] = (int32_t)pk(
            ptscore::seg_table_at(a.subs, A, (qq / A1) * A1 + rr / A1),
            ptscore::seg_table_at(a.subs, A, (qq % A1) * A1 + rr % A1));
      }
    } else {
      for (int32_t k = threadIdx.x; k < A1 * A1; k += blockDim.x)
        sc[k] = ptscore::seg_table_at(a.subs, A, k);
    }
  }
  ptsegblock::pair_sync(C);
  const uint32_t* rd = ring + w * 2 * RG;
  uint32_t* wr = w < warps - 1
                     ? ring + (w + 1) * 2 * RG
                     : (rank < C - 1 ? (uint32_t*)ptsegblock::at_rank(
                                           (int32_t*)ring, rank + 1, C)
                                     : nullptr);
  // warp 0 loads the letters the block's warps read in round g0 + 1 of
  // both halves (the first warp's lane 0 reads column g - LAG * wg0 at
  // step g) and stores them, packed, at the round's end
  int32_t lcol = -1, la = 0, lb = 0;
  auto load_letters = [&](int32_t g0) {
    lcol = g0 + W - LAG * wg0 + lane;
    if (lcol >= 0 && lcol < U.ncols_max) {
      la = r0[lcol];
      lb = r1[lcol];
    }
  };
  auto store_letters = [&]() {
    if (lcol >= 0 && lcol < U.ncols_max)
      letters[lcol & (LR - 1)] =
          ptscore::seg_col(la, A) | (ptscore::seg_col(lb, A) << 16);
  };

  SegBest total[2];
  int32_t over_bits = U.over;
  const SegBest init = ptscore::seg_best_init(ptscore::seg_pair(
      0, 0, a.Qp, a.off, Rseg, a.open, a.ext, a.mode, a.free_bits, false, A));
  total[0] = total[1] = init;
  if (U.row_hi > 0 && U.ncols_max > 0) {
    Lane16<kR, kLocal, kPair> L;
    lane16_init(L, init);
    uint32_t carry = dup(ptscore::border(U.off, U.qb, U.open, U.ext));
    const int32_t group = chain * per_warp;
    for (int32_t i0 = 0; i0 < U.row_hi; i0 += group) {
      const int32_t blk0 = i0 + rank * per_block;
      if (profile)
        ptscore::seg_stage_profile(
            sc, prow + (int64_t)blk0 * A,
            imax(0, imin(per_block, U.row_hi - blk0)), A, prof_rows,
            threadIdx.x, blockDim.x);
      if (w == 0) {
        load_letters(-W);
        store_letters();
      }
      uint32_t old;
      lane16_begin(L, U, blk0 + (w * W + lane) * kR, q0, q1, blk0, A, ld_h,
                   ld_f, old);
      const uint32_t above = __shfl_up_sync(kFull, old, 1);
      const uint32_t last = __shfl_sync(kFull, old, W - 1);
      if (lane == 0)
        for (int32_t k = 0; k < C; ++k)
          ((uint32_t*)ptsegblock::at_rank((int32_t*)olds, k, C))[wg] = last;
      ptsegblock::pair_sync(C);
      const uint32_t prev = wg > 0 ? olds[wg - 1] : carry;
      lane16_diag(L, lane == 0 ? prev : above);
      carry = olds[chain - 1];
      const int32_t nrows = imin(group, U.row_hi - i0);
      const int32_t nw = (nrows + per_warp - 1) / per_warp;
      const int32_t nl =
          imax(0, imin(W, (nrows - wg * per_warp + kR - 1) / kR));
      const int32_t nsteps = nl > 0 ? U.ncols_max + nl - 1 : -1;
      const bool to_ring = wr != nullptr && nrows > (wg + 1) * per_warp;
      const bool to_bot = wg == chain - 1 && i0 + group < U.row_hi;
      const bool first = i0 == 0;
      // what lane 0 reads above column c: the top border, or the group
      // before's last row (the first warp); the warp above's (the others)
      auto top0 = [&](int32_t c, uint32_t& th, uint32_t& te) {
        th = te = U.band.neg;
        if (c >= U.ncols_max) return;
        if (first) {
          th = dup(ptscore::border(U.off + c + 1, U.qb, U.open, U.ext));
        } else {
          th = bot[c];
          te = bot[Rseg + c];
        }
      };
      uint32_t tbh = 0, tbe = 0, tnh = 0, tne = 0;
      if (wg == 0) {
        top0(lane, tbh, tbe);
        top0(W + lane, tnh, tne);
      }
      uint32_t pre_h = U.band.neg, pre_e = U.band.neg;
      uint32_t s_next[kR];
      lane16_scores(L, sc, 0, A1, cs, s_next);
      const int32_t gsteps = ptscore::seg_group_steps(U.ncols_max, nw);
      const int32_t lo = LAG * wg;
      const int32_t hi = lo + nsteps + 1;
      for (int32_t g0 = 0; g0 < gsteps; g0 += W) {
        if (w == 0) load_letters(g0);
        const int32_t g1 = imin(g0 + W, hi);
#pragma unroll 2
        for (int32_t g = imax(g0, lo); g < g1; ++g) {
          const int32_t t = ptscore::seg_local_step(g, wg);
          uint32_t uh = __shfl_up_sync(kFull, L.oh, 1);
          uint32_t ue = __shfl_up_sync(kFull, L.oe, 1);
          const int32_t c = t - lane;
          if (wg == 0) {
            const uint32_t nh = __shfl_sync(kFull, tbh, g & (W - 1));
            const uint32_t ne = __shfl_sync(kFull, tbe, g & (W - 1));
            if (lane == 0) {
              uh = pre_h;
              ue = pre_e;
              pre_h = nh;
              pre_e = ne;
            }
          } else if (lane == 0) {
            uh = pre_h;
            ue = pre_e;
            if (t + 1 < U.ncols_max) {
              pre_h = rd[(t + 1) & (RG - 1)];
              pre_e = rd[RG + ((t + 1) & (RG - 1))];
            }
          }
          uint32_t s[kR];
#pragma unroll
          for (int32_t k = 0; k < kR; ++k) s[k] = s_next[k];
          if (L.nr > 0 && c + 1 >= 0 && c + 1 < U.ncols_max)
            lane16_scores(L, sc, (uint32_t)letters[(c + 1) & (LR - 1)], A1,
                          cs, s_next);
          if (t >= 0 && L.nr > 0 && c >= 0 && c < U.ncols_max) {
            lane16_step(L, U, c, s, uh, ue, st_h, st_f);
            if (lane == W - 1 && to_ring) {
              wr[c & (RG - 1)] = L.oh;
              wr[RG + (c & (RG - 1))] = L.oe;
            }
            if (lane == W - 1 && to_bot) {
              bot[c] = L.oh;
              bot[Rseg + c] = L.oe;
            }
          }
        }
        if (wg == 0) {
          tbh = tnh;
          tbe = tne;
          top0(g0 + 2 * W + lane, tnh, tne);
        }
        if (w == 0) store_letters();
        ptsegblock::pair_sync(C);
      }
      lane16_fold(L, U.off);
    }
    lane16_finish(L, U.band);
PT_UNROLL
    for (int32_t x = 0; x < 2; ++x) {
      SegBest t = L.best[x];
      for (int m = W / 2; m > 0; m >>= 1) {
        SegBest o;
        o.h = __shfl_xor_sync(kFull, t.h, m);
        o.i = __shfl_xor_sync(kFull, t.i, m);
        o.j = __shfl_xor_sync(kFull, t.j, m);
        o.hmax = __shfl_xor_sync(kFull, t.hmax, m);
        o.hmin = __shfl_xor_sync(kFull, t.hmin, m);
        t = ptscore::seg_merge(t, o);
      }
      total[x] = t;
    }
    const int32_t ov = __reduce_or_sync(kFull, (unsigned)L.over);
    if (lane == 0) {
      int32_t* o = ptsegblock::at_rank(bests, 0, C) + wg * kBest16;
PT_UNROLL
      for (int32_t x = 0; x < 2; ++x) {
        o[5 * x] = total[x].h;
        o[5 * x + 1] = total[x].i;
        o[5 * x + 2] = total[x].j;
        o[5 * x + 3] = total[x].hmax;
        o[5 * x + 4] = total[x].hmin;
      }
      o[10] = ov;
    }
    ptsegblock::pair_sync(C);
    if (rank == 0 && threadIdx.x == 0) {
      for (int32_t k = 1; k < chain; ++k) {
        const int32_t* o = bests + k * kBest16;
PT_UNROLL
        for (int32_t x = 0; x < 2; ++x) {
          SegBest y;
          y.h = o[5 * x];
          y.i = o[5 * x + 1];
          y.j = o[5 * x + 2];
          y.hmax = o[5 * x + 3];
          y.hmin = o[5 * x + 4];
          total[x] = ptscore::seg_merge(total[x], y);
        }
        over_bits |= o[10];
      }
      over_bits |= ov;
    }
  }
  if (rank == 0 && threadIdx.x == 0) {
    unit16_finish(U, 0, total[0], over_bits, a.qlen, a.rlen, a.Qp, Rseg,
                  a.mode, a.free_bits, A, a.acc, a.over, a.out, a.B);
    if (U.two)
      unit16_finish(U, 1, total[1], over_bits, a.qlen, a.rlen, a.Qp, Rseg,
                    a.mode, a.free_bits, A, a.acc, a.over, a.out, a.B);
  }
}

template <int32_t kR, bool kLocal, bool kPair>
int launch16_form(const Seg16Args& a, const ptscore::SegPlan& plan,
                  cudaStream_t stream) {
  auto kernel = segment_kernel<kR, kLocal, kPair>;
  static std::atomic<bool> allowed[ptsegblock::kMaxDevices];
  const cudaError_t smem = ptsegblock::allow_smem(kernel, allowed);
  if (smem != cudaSuccess) return (int)smem;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.U * plan.cluster));
  cfg.blockDim = dim3((unsigned)(plan.warps * ptscore::SEG_LANES));
  cfg.dynamicSmemBytes = (size_t)seg16_block_bytes(
      a.qidx == nullptr, kR, plan.warps, plan.cluster, a.A, a.Qp, a.Rseg);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

template <bool kLocal, bool kPair>
int launch16_rows(const Seg16Args& a, const ptscore::SegPlan& plan,
                  cudaStream_t s) {
  switch (plan.rows) {
    case 2:
      return launch16_form<2, kLocal, kPair>(a, plan, s);
    case 4:
      return launch16_form<4, kLocal, kPair>(a, plan, s);
    case 8:
      return launch16_form<8, kLocal, kPair>(a, plan, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Launches the packed form for the plan of `a` (warps, rows, cluster 0:
// the rule's); a plan outside the compiled forms, a profile of more than
// one row set, or penalties and scores without a band return
// cudaErrorInvalidValue.
inline int launch16(Seg16Args a, int warps, int rows, int cluster,
                    void* stream) {
  if (a.U <= 0) return 0;
  const bool profile = a.qidx == nullptr;
  if ((profile && a.Bq != 1) || !seg16_usable(a.open, a.ext, a.bound))
    return (int)cudaErrorInvalidValue;
  const ptscore::SegPlan plan = seg16_plan(a.U, a.Qp, a.Rseg, a.A, profile,
                                           warps, rows, cluster);
  if (plan.warps < 1 || plan.warps > ptscore::SEG_MAX_WARPS ||
      plan.cluster < 1 || plan.cluster > ptscore::SEG_MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  a.cluster = plan.cluster;
  cudaStream_t s = (cudaStream_t)stream;
  const bool local = a.mode == ptscore::MODE_SW;
  if (seg16_pair_table(profile, a.A))
    return local ? launch16_rows<true, true>(a, plan, s)
                 : launch16_rows<false, true>(a, plan, s);
  return local ? launch16_rows<true, false>(a, plan, s)
               : launch16_rows<false, false>(a, plan, s);
}

#else  // the host twin

// One unit's segment on the host: the kernel's lanes stepped in a loop,
// as segment_pair_host steps the int32 form's (the chain of `warps` *
// `cluster` warps, their lag and ring, warps and lanes last first).  The
// scores are staged as the kernel stages them (the profile rows of the
// whole pair at once).  Writes the unit's pairs' outputs, state, acc and
// over, as the kernel does.
template <int32_t kR, bool kLocal, bool kPair>
inline void segment16_unit_host(const Seg16Args& a, int32_t u,
                                int32_t warps, int32_t cluster,
                                std::vector<uint32_t>& bottom) {
  constexpr int32_t W = ptscore::SEG_LANES;
  const bool profile = a.qidx == nullptr;
  const int32_t A = a.A, A1 = A + 1, Rseg = a.Rseg;
  const Unit16 U = unit16(a.units, u, a.qlen, a.rlen, a.Qp, a.off, Rseg,
                          a.open, a.ext, a.mode, a.free_bits, a.resume != 0,
                          A, a.bound);
  const int32_t cs = profile ? ptscore::seg_prof_stride(a.Qp) : 1;
  std::vector<int32_t> sc;
  if (profile) {
    sc.resize((size_t)(A1 * cs));
    ptscore::seg_stage_profile(sc.data(), a.subs, a.Qp, A, a.Qp, 0, 1);
  } else if (kPair) {
    const int32_t AA = A1 * A1;
    sc.resize((size_t)(AA * AA));
    for (int32_t k = 0; k < AA * AA; ++k) {
      const int32_t qq = k / AA, rr = k % AA;
      sc[k] = (int32_t)pk(
          ptscore::seg_table_at(a.subs, A, (qq / A1) * A1 + rr / A1),
          ptscore::seg_table_at(a.subs, A, (qq % A1) * A1 + rr % A1));
    }
  } else {
    sc.resize((size_t)(A1 * A1));
    for (int32_t k = 0; k < A1 * A1; ++k)
      sc[k] = ptscore::seg_table_at(a.subs, A, k);
  }
  const int32_t* q0 =
      profile ? nullptr : a.qidx + (a.Bq == 1 ? 0 : (int64_t)U.pair[0] * a.Qp);
  const int32_t* q1 =
      profile ? nullptr : a.qidx + (a.Bq == 1 ? 0 : (int64_t)U.pair[1] * a.Qp);
  const int32_t* r0 = a.ridx + (int64_t)U.pair[0] * Rseg;
  const int32_t* r1 = a.ridx + (int64_t)U.pair[1] * Rseg;
  int32_t* const st_h[2] = {a.st_h + (int64_t)U.pair[0] * a.Qp,
                            a.st_h + (int64_t)U.pair[1] * a.Qp};
  int32_t* const st_f[2] = {a.st_f + (int64_t)U.pair[0] * a.Qp,
                            a.st_f + (int64_t)U.pair[1] * a.Qp};
  const int32_t* const ld_h[2] = {st_h[0], st_h[1]};
  const int32_t* const ld_f[2] = {st_f[0], st_f[1]};
  const SegBest init = ptscore::seg_best_init(ptscore::seg_pair(
      0, 0, a.Qp, a.off, Rseg, a.open, a.ext, a.mode, a.free_bits, false, A));
  SegBest total[2] = {init, init};
  int32_t over_bits = U.over;
  if (U.row_hi > 0 && U.ncols_max > 0) {
    const int32_t chain = warps * cluster;
    const int32_t per_warp = W * kR;
    std::vector<Lane16<kR, kLocal, kPair>> lanes(chain * W);
    std::vector<uint32_t> old(chain * W);
    std::vector<uint32_t> ring((size_t)chain * 2 * ptscore::SEG_RING);
    for (auto& L : lanes) lane16_init(L, init);
    bottom.assign((size_t)2 * Rseg, 0);
    uint32_t carry = dup(ptscore::border(U.off, U.qb, U.open, U.ext));
    const int32_t group = chain * per_warp;
    for (int32_t i0 = 0; i0 < U.row_hi; i0 += group) {
      for (int32_t x = 0; x < chain * W; ++x)
        lane16_begin(lanes[x], U, i0 + x * kR, q0, q1, 0, A, ld_h, ld_f,
                     old[x]);
      for (int32_t x = 0; x < chain * W; ++x)
        lane16_diag(lanes[x], x == 0 ? carry : old[x - 1]);
      carry = old[chain * W - 1];
      const int32_t nrows = imin(group, U.row_hi - i0);
      const int32_t nw = (nrows + per_warp - 1) / per_warp;
      const bool feeds = i0 + group < U.row_hi;
      const int32_t steps = ptscore::seg_group_steps(U.ncols_max, nw);
      for (int32_t g = 0; g < steps; ++g) {
        for (int32_t w = nw - 1; w >= 0; --w) {
          const int32_t t = ptscore::seg_local_step(g, w);
          const int32_t nl = imin(W, (nrows - w * per_warp + kR - 1) / kR);
          if (t < 0 || t >= U.ncols_max + nl - 1) continue;
          for (int32_t l = nl - 1; l >= 0; --l) {
            const int32_t c = t - l;
            if (c < 0 || c >= U.ncols_max) continue;
            uint32_t uh, ue;
            if (l > 0) {
              uh = lanes[w * W + l - 1].oh;
              ue = lanes[w * W + l - 1].oe;
            } else if (w > 0) {
              const size_t at = (size_t)w * 2 * ptscore::SEG_RING;
              uh = ring[at + c % ptscore::SEG_RING];
              ue = ring[at + ptscore::SEG_RING + c % ptscore::SEG_RING];
            } else if (i0 == 0) {
              uh = dup(ptscore::border(U.off + c + 1, U.qb, U.open, U.ext));
              ue = U.band.neg;
            } else {
              uh = bottom[c];
              ue = bottom[Rseg + c];
            }
            auto& L = lanes[w * W + l];
            const uint32_t lw = (uint32_t)(ptscore::seg_col(r0[c], A) |
                                           (ptscore::seg_col(r1[c], A) << 16));
            uint32_t s[kR];
            lane16_scores(L, sc.data(), lw, A1, cs, s);
            lane16_step(L, U, c, s, uh, ue, st_h, st_f);
            if (l == W - 1 && w + 1 < nw) {
              const size_t at = (size_t)(w + 1) * 2 * ptscore::SEG_RING;
              ring[at + c % ptscore::SEG_RING] = L.oh;
              ring[at + ptscore::SEG_RING + c % ptscore::SEG_RING] = L.oe;
            }
            if (l == W - 1 && w == chain - 1 && feeds) {
              bottom[c] = L.oh;
              bottom[Rseg + c] = L.oe;
            }
          }
        }
      }
      for (auto& L : lanes) lane16_fold(L, U.off);
    }
    for (auto& L : lanes) {
      lane16_finish(L, U.band);
      for (int32_t x = 0; x < 2; ++x)
        total[x] = ptscore::seg_merge(total[x], L.best[x]);
      over_bits |= L.over;
    }
  }
  unit16_finish(U, 0, total[0], over_bits, a.qlen, a.rlen, a.Qp, Rseg,
                a.mode, a.free_bits, A, a.acc, a.over, a.out, a.B);
  if (U.two)
    unit16_finish(U, 1, total[1], over_bits, a.qlen, a.rlen, a.Qp, Rseg,
                  a.mode, a.free_bits, A, a.acc, a.over, a.out, a.B);
}

#endif

}  // namespace ptseg16
