// The block kernel behind the segment form (scan_segment.cu, kernel K2),
// the tile form (scan_rowseg.cu, kernel K3) and the chunked plane forms
// (scan_chunked.cu, kernel K1f): a block per pair, one to eight warps, a
// query row a lane.  scan_segment.cu's header describes the design; each
// source instantiates its own forms (no two the same), so nvcc builds them
// side by side.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_cell.cuh"

namespace ptsegblock {

using ptscore::Pay;
using ptscore::SegBest;
using ptscore::SegUp;

constexpr unsigned kFull = 0xffffffffu;

template <int32_t kOut>
__device__ __forceinline__ SegUp shfl_up1(const SegUp& v) {
  SegUp r;
  r.h = __shfl_up_sync(kFull, v.h, 1);
  r.e = __shfl_up_sync(kFull, v.e, 1);
  if constexpr (ptscore::Out<kOut>::stats) {
    r.hp.m = __shfl_up_sync(kFull, v.hp.m, 1);
    r.hp.s = __shfl_up_sync(kFull, v.hp.s, 1);
    r.hp.l = __shfl_up_sync(kFull, v.hp.l, 1);
    r.ep.m = __shfl_up_sync(kFull, v.ep.m, 1);
    r.ep.s = __shfl_up_sync(kFull, v.ep.s, 1);
    r.ep.l = __shfl_up_sync(kFull, v.ep.l, 1);
  }
  return r;
}

// H and its payload of one lane, to every lane.
template <int32_t kOut>
__device__ __forceinline__ SegUp shfl_from(const SegUp& v, int src) {
  SegUp r;
  r.h = __shfl_sync(kFull, v.h, src);
  if constexpr (ptscore::Out<kOut>::stats) {
    r.hp.m = __shfl_sync(kFull, v.hp.m, src);
    r.hp.s = __shfl_sync(kFull, v.hp.s, src);
    r.hp.l = __shfl_sync(kFull, v.hp.l, src);
  }
  return r;
}

__device__ __forceinline__ SegBest shfl_xor_best(const SegBest& v, int m) {
  SegBest r;
  r.h = __shfl_xor_sync(kFull, v.h, m);
  r.i = __shfl_xor_sync(kFull, v.i, m);
  r.j = __shfl_xor_sync(kFull, v.j, m);
  r.p.m = __shfl_xor_sync(kFull, v.p.m, m);
  r.p.s = __shfl_xor_sync(kFull, v.p.s, m);
  r.p.l = __shfl_xor_sync(kFull, v.p.l, m);
  r.hmax = __shfl_xor_sync(kFull, v.hmax, m);
  r.hmin = __shfl_xor_sync(kFull, v.hmin, m);
  return r;
}

// What a block keeps in shared memory beyond the table: per warp but the
// last a ring of its last lane's row (kRows values a column), per warp
// that lane's H left of the segment, and per warp its best cell.
constexpr int32_t kOldWords = 4;    // h, hp.m, hp.s, hp.l
constexpr int32_t kBestWords = 8;   // h, i, j, p.m, p.s, p.l, hmax, hmin

inline size_t block_words(int warps, int rows) {
  return (size_t)(warps - 1) * rows * ptscore::SEG_RING +
         (size_t)warps * (kOldWords + kBestWords);
}

// kTile: the tile form (kernel K3, scan_rowseg.cu): rows [r0, r0 + qc) of
// the pairs, every border a read (score_cell.cuh, "the tile form").
template <int32_t kOut, bool kTile>
__global__ void segment_kernel(
    const int32_t* __restrict__ subs,   // (A, A) table or (Bq, Qp, A) rows
    const int32_t* __restrict__ qidx,   // (Bq, Qp) letters; null: profile
    const int32_t* __restrict__ mq,     // stats: (Bm, Qp) letters
    const int32_t* __restrict__ ridx,   // (B, Rseg): this segment's letters
    const int32_t* __restrict__ qlen,   // (B,)
    const int32_t* __restrict__ rlen,   // (B,) global reference lengths
    int32_t* bottom,                    // (B, 2 or 8, Rseg) scratch
    int32_t* down,                      // tile: (B, 2 or 8, Rseg), the
                                        // down-state, in place
    int32_t* st_h,                      // (B, Qs) state, in place
    int32_t* st_f,                      // (B, Qs)
    int32_t* st_pay,                    // stats: (6, B, Qs)
    int32_t* acc,                       // (B, 8)
    int32_t* __restrict__ out,          // (5 or 8, B)
    int8_t* __restrict__ trace,         // trace: (B, Qs, Rseg) flags
    const int32_t* __restrict__ t_in,   // tile: (B, 4) corner words
    int32_t* __restrict__ t_out,        // tile: (B, 4)
    int32_t B, int32_t Bq, int32_t Bm, int32_t Qp, int32_t Rseg, int32_t A,
    int32_t open, int32_t ext, int32_t mode, int32_t free_bits, int32_t off,
    int32_t resume, int32_t table_in_smem,
    int32_t Qs,                         // rows of the state: Qp; tile: qc
    int32_t r0,                         // tile: its first row
    int32_t* __restrict__ tab,          // table forms: (4 or 1, B, Rseg, Qp)
    int32_t* __restrict__ rowp,         // rowcol forms: (4 or 1, B, Rseg)
    int32_t* __restrict__ colp) {       // rowcol forms: (4 or 1, B, Qp)
  using O = ptscore::Out<kOut>;
  constexpr int32_t W = ptscore::SEG_LANES;
  constexpr int32_t R = ptscore::SEG_RING;
  constexpr int32_t kRows = O::stats ? 8 : 2;
  extern __shared__ int32_t smem[];
  const int32_t warps = blockDim.x / W;
  const int32_t w = threadIdx.x / W;
  const int32_t lane = threadIdx.x & (W - 1);
  const int32_t* table = subs;
  int32_t* ring = smem;                 // (warps - 1, kRows, R)
  if (table_in_smem) {
    for (int32_t k = threadIdx.x; k < A * A; k += blockDim.x) smem[k] = subs[k];
    table = smem;
    ring = smem + A * A;
  }
  int32_t* olds = ring + (warps - 1) * kRows * R;   // (warps, kOldWords)
  int32_t* bests = olds + warps * kOldWords;        // (warps, kBestWords)
  const int32_t b = blockIdx.x;         // one block per pair
  const ptscore::SegPair p =
      kTile ? ptscore::tile_pair(qlen[b], rlen[b], Qp, r0, Qs, off, Rseg,
                                 open, ext, mode, free_bits, A)
            : ptscore::seg_pair(qlen[b], rlen[b], Qp, off, Rseg, open, ext,
                                mode, free_bits, resume != 0, A);
  const int64_t bq = Bq == 1 ? 0 : b;
  const int32_t* rows = qidx ? table : subs + bq * Qp * A;
  const int32_t* q = qidx ? qidx + bq * Qp : nullptr;
  const int32_t* mqb = O::stats ? mq + (Bm == 1 ? 0 : (int64_t)b * Qp)
                                : nullptr;
  const int32_t* rseg = ridx + (int64_t)b * Rseg;
  int32_t* bot = bottom + (int64_t)b * kRows * Rseg;
  int32_t* dn = kTile ? down + (int64_t)b * kRows * Rseg : nullptr;
  int32_t* sh = st_h + (int64_t)b * Qs;
  int32_t* sf = st_f + (int64_t)b * Qs;
  int32_t* sp = O::stats ? st_pay + (int64_t)b * Qs : nullptr;
  const int64_t pay_plane = (int64_t)B * Qs;
  int8_t* tr = O::trace ? trace + (int64_t)b * Qs * Rseg : nullptr;
  ptscore::SegPlanes pl;
  if constexpr (O::table) {
    pl.table = tab + (int64_t)b * Rseg * Qp;
    pl.tab_plane = (int64_t)B * Rseg * Qp;
  }
  if constexpr (O::rowcol) {
    pl.row = rowp + (int64_t)b * Rseg;
    pl.row_plane = (int64_t)B * Rseg;
    pl.col = colp + (int64_t)b * Qp;
    pl.col_plane = (int64_t)B * Qp;
  }
  // the tile hands on what it read above its last column, before any lane
  // writes the down-state
  if (kTile && threadIdx.x == 0)
    ptscore::tile_corner_out<kOut>(dn, Rseg, t_out + (int64_t)b * 4);
  __syncthreads();
  // the rings this warp reads (the warp above's) and writes (its own)
  const int32_t* rd = ring + (w > 0 ? w - 1 : 0) * kRows * R;
  int32_t* wr = ring + (w < warps - 1 ? w : 0) * kRows * R;

  SegBest total = ptscore::seg_best_init(p);
  if (ptscore::seg_sweeps(p)) {           // the whole block, or none of it
    ptscore::SegLane<kOut> L;
    L.best = ptscore::seg_best_init(p);
    // the row above's H left of the segment (or tile)
    SegUp carry = kTile ? ptscore::tile_corner(t_in + (int64_t)b * 4)
                        : ptscore::seg_corner(p);
    const int32_t group = warps * W;
    for (int32_t i0 = p.row_lo; i0 < p.row_hi; i0 += group) {
      SegUp old;
      ptscore::seg_row_begin(L, p, i0 + w * W + lane, rows, q, mqb, sh, sf,
                             sp, pay_plane, old);
      // H[i-1][off-1] is the row above's H left of the segment as it was
      // before this call: from the lane above, for a warp's first lane
      // from the last lane of the warp above, for the group's first row
      // from the group before
      const SegUp above = shfl_up1<kOut>(old);
      const SegUp last = shfl_from<kOut>(old, W - 1);
      if (lane == 0) {
        olds[w * kOldWords] = last.h;
        olds[w * kOldWords + 1] = last.hp.m;
        olds[w * kOldWords + 2] = last.hp.s;
        olds[w * kOldWords + 3] = last.hp.l;
      }
      __syncthreads();
      SegUp prev = carry;
      if (w > 0) {
        const int32_t* o = olds + (w - 1) * kOldWords;
        prev.h = o[0];
        prev.hp = Pay{o[1], o[2], o[3]};
      }
      ptscore::seg_row_diag(L, lane == 0 ? prev : above);
      {
        const int32_t* o = olds + (warps - 1) * kOldWords;
        carry.h = o[0];
        carry.hp = Pay{o[1], o[2], o[3]};
      }
      const int32_t nrows = ptscore::imin(group, p.row_hi - i0);
      const int32_t nw = (nrows + W - 1) / W;          // warps with rows
      const int32_t nl = ptscore::imax(0, ptscore::imin(W, nrows - w * W));
      // steps of this warp's own sweep; an idle warp only keeps the rounds
      const int32_t nsteps = nl > 0 ? p.ncols + nl - 1 : -1;
      // where the warp's last lane leaves its row: the next warp's ring,
      // or for the group's last row the scratch of the next group
      const bool to_ring = w < warps - 1 && nrows > (w + 1) * W;
      const bool to_bot = w == warps - 1 && i0 + group < p.row_hi;
      // the tile's last row goes to the down-state from the lane it is on
      const bool to_down = kTile && L.on && L.i == p.down_row;
      const bool first = i0 == p.row_lo;

      // what lane 0 reads above column c: the warp above's last row, the
      // top border (a tile: the down-state it was given), or the group
      // before's last row
      auto top = [&](int32_t c) {
        if (w > 0) return ptscore::seg_up_load<kOut>(rd, R, c & (R - 1));
        if (first)
          return kTile ? ptscore::seg_up_load<kOut>(dn, Rseg, c)
                       : ptscore::seg_top(p, p.off + c);
        return ptscore::seg_up_load<kOut>(bot, Rseg, c);
      };
      SegUp pre;                          // lane 0: one step ahead
      int32_t r_next = 0, s_next = 0;     // every lane: one step ahead
      int8_t* trow =
          O::trace ? tr + (int64_t)(L.i - p.row_lo) * Rseg : nullptr;
      const int32_t gsteps = ptscore::seg_group_steps(p.ncols, nw);
      // the group's steps at which this warp has one of its own, -1 (the
      // fetch ahead) to nsteps - 1
      const int32_t lo = ptscore::SEG_LAG * w;
      const int32_t hi = lo + nsteps + 1;
      for (int32_t g0 = 0; g0 < gsteps; g0 += W) {
        const int32_t g1 = ptscore::imin(g0 + W, hi);
#pragma unroll 4
        for (int32_t g = ptscore::imax(g0, lo); g < g1; ++g) {
          const int32_t t = ptscore::seg_local_step(g, w);
          SegUp up = shfl_up1<kOut>(L.out);
          const int32_t c = t - lane;
          if (lane == 0) {
            up = pre;
            if (t + 1 < p.ncols) pre = top(t + 1);
          }
          const int32_t r = r_next, s = s_next;
          if (L.on && c + 1 >= 0 && c + 1 < p.ncols) {
            r_next = rseg[c + 1];
            s_next = ptscore::seg_score(L, p, r_next);
          }
          if (t >= 0 && L.on && c >= 0 && c < p.ncols) {
            ptscore::seg_cell(L, p, c, r, s, up, trow, sh, sf, sp, pay_plane,
                              pl);
            if (lane == W - 1 && to_ring)
              ptscore::seg_up_store<kOut>(wr, R, c & (R - 1), L.out);
            if (lane == W - 1 && to_bot)
              ptscore::seg_up_store<kOut>(bot, Rseg, c, L.out);
            if (to_down) ptscore::seg_up_store<kOut>(dn, Rseg, c, L.out);
          }
        }
        // one round of W steps: what a warp's last lane wrote in it, the
        // warp below reads a round later; the last round also puts the
        // group's last row and `olds` behind the next group's accesses
        __syncthreads();
      }
    }
    total = L.best;
    for (int m = W / 2; m > 0; m >>= 1)
      total = ptscore::seg_merge(total, shfl_xor_best(total, m));
    if (lane == 0) {
      int32_t* o = bests + w * kBestWords;
      o[0] = total.h;
      o[1] = total.i;
      o[2] = total.j;
      o[3] = total.p.m;
      o[4] = total.p.s;
      o[5] = total.p.l;
      o[6] = total.hmax;
      o[7] = total.hmin;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int32_t k = 1; k < warps; ++k) {
        const int32_t* o = bests + k * kBestWords;
        SegBest x;
        x.h = o[0];
        x.i = o[1];
        x.j = o[2];
        x.p = Pay{o[3], o[4], o[5]};
        x.hmax = o[6];
        x.hmin = o[7];
        total = ptscore::seg_merge(total, x);
      }
    }
  }
  if (threadIdx.x == 0) {
    const ptscore::PairResult r =
        ptscore::seg_finish<kOut>(p, mode, total, acc + (int64_t)b * 8);
    out[b] = r.score;
    out[B + b] = r.end_query;
    out[2 * B + b] = r.end_ref;
    out[3 * B + b] = r.sat8;
    out[4 * B + b] = r.sat16;
    if constexpr (O::stats) {
      out[5 * B + b] = r.matches;
      out[6 * B + b] = r.similar;
      out[7 * B + b] = r.length;
    }
  }
}

constexpr size_t kStaticSmemLimit = 48 * 1024;
// warps the card wants in flight before one warp a pair is enough: eight
// on each of its 132 SMs
constexpr int kWarpsWanted = 132 * 8;
constexpr int kMaxWarps = 8;

// down, Qs, r0, t_in, t_out: the tile form's down-state, state rows (its
// qc), first row and corner words; the segment form passes null, Qp, 0
// and null.  tab_out, rows_out, cols_out: the plane forms' outputs
// (SegPlanes), null elsewhere.
template <int32_t kOut, bool kTile>
int launch(const void* subs, const void* qidx, const void* mq,
           const void* ridx, const void* qlen, const void* rlen, void* bottom,
           void* down, void* st_h, void* st_f, void* st_pay, void* acc,
           void* out, void* trace, const void* t_in, void* t_out, int B,
           int Bq, int Bm,
           int Qp, int Rseg, int A, int open, int ext, int mode,
           int free_bits, int off, int resume, int warps, int Qs, int r0,
           void* stream, void* tab_out = nullptr, void* rows_out = nullptr,
           void* cols_out = nullptr) {
  if (B <= 0) return 0;
  constexpr int rows = ptscore::Out<kOut>::stats ? 8 : 2;
  if (warps <= 0) {
    // a block per pair: as many warps as fill the card, at most one per
    // 32 query rows
    warps = kWarpsWanted / B;
    const int most = (Qs + ptscore::SEG_LANES - 1) / ptscore::SEG_LANES;
    warps = warps > most ? most : warps;
  }
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  size_t smem = block_words(warps, rows) * sizeof(int32_t);
  int in_smem = 0;
  const size_t tab = (size_t)A * A * sizeof(int32_t);
  if (qidx != nullptr && smem + tab <= kStaticSmemLimit) {
    smem += tab;
    in_smem = 1;
  }
  segment_kernel<kOut, kTile>
      <<<B, warps * ptscore::SEG_LANES, smem, (cudaStream_t)stream>>>(
          (const int32_t*)subs, (const int32_t*)qidx, (const int32_t*)mq,
          (const int32_t*)ridx, (const int32_t*)qlen, (const int32_t*)rlen,
          (int32_t*)bottom, (int32_t*)down, (int32_t*)st_h, (int32_t*)st_f,
          (int32_t*)st_pay,
          (int32_t*)acc, (int32_t*)out, (int8_t*)trace, (const int32_t*)t_in,
          (int32_t*)t_out, B, Bq, Bm, Qp, Rseg, A, open, ext, mode, free_bits,
          off, resume, in_smem, Qs, r0, (int32_t*)tab_out, (int32_t*)rows_out,
          (int32_t*)cols_out);
  return (int)cudaGetLastError();
}

}  // namespace ptsegblock
