// The block kernel behind the segment form (scan_segment.cu, kernel K2),
// the tile form (scan_rowseg.cu, kernel K3) and the chunked plane forms
// (scan_chunked.cu, kernel K1f), for Hopper (sm_90a).
//
// A pair is swept by a chain of warps: the one to eight warps of its
// block, or, when the launch holds too few pairs to fill the card, of the
// C blocks of a thread-block cluster one after another.  A lane holds kR
// consecutive query rows (score_cell.cuh, "the segment form"): at step t
// it computes column t - lane of its rows top to bottom on DPX max-plus
// (addmax, max3, max3_relu), E running down the rows in registers, and one
// warp shuffle a step brings the bottom row of the lane above.  Warp w of
// the chain runs SEG_LAG steps behind warp w - 1 and reads that warp's
// last row from a ring of SEG_RING columns in its own shared memory; the
// last warp of block k writes the ring of block k + 1's first warp through
// distributed shared memory (map_shared_rank).  The pair's blocks meet at
// a barrier (the block's, or the cluster's) every SEG_LANES steps, and the
// lag puts one barrier between a column's write and its read and another
// before its slot is reused, so no warp waits on another in a loop.  The
// group's last row goes to a per-pair scratch row of Rseg columns in
// global memory, which the first warp of the next group reads.
//
// Inputs sit in dynamic shared memory: the (A, A) table, or in the
// profile form the profile rows of the block's rows of the group, staged
// at the group's start (score_cell.cuh, seg_stage_profile), each with a
// column of 0 for letters outside the alphabet; and a ring of up to
// SEG_LETTERS reference letters that warp 0 fills by cp.async one round
// of SEG_LANES columns ahead of its use.  Each lane fetches its next
// letter and its rows' scores against it, and lane 0 its next row above,
// one step ahead, off the dependent chain; the chain's first warp, whose
// rows above come from global memory, stages them a round ahead.  The end
// cell's bests cross the warps and blocks through the first block's
// shared memory, whose thread 0 folds them into `acc`.
//
// The launcher (launch, below) takes kR, the warps and the cluster from
// score_cell.cuh's seg_plan, a rule of B, the rows and the class.  A
// launch the card refuses (a cluster it cannot place, shared memory it
// lacks) returns its CUDA error; nothing reruns it another way.
// scan_segment.cu's header says what bounds the kernel now.  Each source
// instantiates its own forms (no two the same), so nvcc builds them side
// by side.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "score_cell.cuh"

namespace ptsegblock {

namespace cg = cooperative_groups;

using ptscore::Pay;
using ptscore::SegBest;
using ptscore::SegUp;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = ptscore::SEG_MAX_WARPS * ptscore::SEG_LANES;

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

// A lane's SegUp (H, E and their payloads), to every lane.
template <int32_t kOut>
__device__ __forceinline__ SegUp shfl_idx(const SegUp& v, int src) {
  SegUp r;
  r.h = __shfl_sync(kFull, v.h, src);
  r.e = __shfl_sync(kFull, v.e, src);
  if constexpr (ptscore::Out<kOut>::stats) {
    r.hp.m = __shfl_sync(kFull, v.hp.m, src);
    r.hp.s = __shfl_sync(kFull, v.hp.s, src);
    r.hp.l = __shfl_sync(kFull, v.hp.l, src);
    r.ep.m = __shfl_sync(kFull, v.ep.m, src);
    r.ep.s = __shfl_sync(kFull, v.ep.s, src);
    r.ep.l = __shfl_sync(kFull, v.ep.l, src);
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

// The barrier of a pair's blocks: the cluster's, or the one block's.
__device__ __forceinline__ void pair_sync(int32_t C) {
  if (C > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// `p`, an address of this block's shared memory, in block `rank` of the
// cluster.
__device__ __forceinline__ int32_t* at_rank(int32_t* p, int32_t rank,
                                            int32_t C) {
  return C > 1 ? cg::this_cluster().map_shared_rank(p, rank) : p;
}

__device__ __forceinline__ void copy_async4(int32_t* dst,
                                            const int32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

constexpr int32_t kOldWords = 4;    // h, hp.m, hp.s, hp.l
constexpr int32_t kBestWords = 8;   // h, i, j, p.m, p.s, p.l, hmax, hmin

// Everything a launch passes, by value.
struct SegArgs {
  const int32_t* subs;    // (A, A) table or (Bq, Qp, A) rows
  const int32_t* qidx;    // (Bq, Qp) letters; null: profile
  const int32_t* mq;      // stats: (Bm, Qp) letters
  const int32_t* ridx;    // (B, Rseg): this segment's letters
  const int32_t* qlen;    // (B,)
  const int32_t* rlen;    // (B,) global reference lengths
  int32_t* bottom;        // (B, 2 or 8, Rseg) scratch
  int32_t* down;          // tile: (B, 2 or 8, Rseg), the down-state, in place
  int32_t* st_h;          // (B, Qs) state, in place
  int32_t* st_f;          // (B, Qs)
  int32_t* st_pay;        // stats: (6, B, Qs)
  int32_t* acc;           // (B, 8)
  int32_t* out;           // (5 or 8, B)
  int8_t* trace;          // trace: (B, Qs, Rseg) flags
  const int32_t* t_in;    // tile: (B, 4) corner words
  int32_t* t_out;         // tile: (B, 4)
  int32_t* tab;           // table forms: (4 or 1, B, Rseg, Qp)
  int32_t* rowp;          // rowcol forms: (4 or 1, B, Rseg)
  int32_t* colp;          // rowcol forms: (4 or 1, B, Qp)
  int32_t B, Bq, Bm, Qp, Rseg, A, open, ext, mode, free_bits, off, resume;
  int32_t Qs;             // rows of the state: Qp; tile: qc
  int32_t r0;             // tile: its first row
  int32_t cluster;        // blocks a pair
  int32_t bw;             // kBanded: the band's half-width
};

// kTile: the tile form (kernel K3, scan_rowseg.cu): rows [r0, r0 + qc) of
// the pairs, every border a read (score_cell.cuh, "the tile form").
// The segment forms of 2 and 4 rows a lane that write no flags or
// payloads fit two blocks of eight warps an SM (128 registers, no spill:
// the many short pairs of a batch like bench.py's headline fill the SMs
// with them); the rest take one.
template <int32_t kOut, bool kTile, int32_t kR>
constexpr int kMinBlocks =
    !kTile && kR <= 4 &&
            (kOut == ptscore::OUT_SCORE || kOut == ptscore::OUT_TABLE ||
             kOut == ptscore::OUT_ROWCOL)
        ? 2
        : 1;

// kBanded: the masked one-shot form of the banded mode (scan_chunked_banded
// .cu: one segment from column 0, never a tile), score_pair<kOut, true>'s
// masked sweep cell by cell (seg_lane_step).
template <int32_t kOut, bool kTile, int32_t kR, bool kBanded>
__global__ void __launch_bounds__(kMaxThreads, (kMinBlocks<kOut, kTile, kR>))
    segment_kernel(const SegArgs a) {
  static_assert(!(kTile && kBanded), "the banded form is one-shot");
  using O = ptscore::Out<kOut>;
  // the first warp of the chain stages what it reads above its rows (the
  // top border, the tile's down-state, the group before's last row) a
  // round ahead in registers; the stats forms, short of registers, read
  // it a step ahead
  constexpr bool kTopAhead = !O::stats;
  constexpr int32_t W = ptscore::SEG_LANES;
  constexpr int32_t RG = ptscore::SEG_RING;
  constexpr int32_t LAG = ptscore::SEG_LAG;
  constexpr int32_t kRows = O::stats ? 8 : 2;
  extern __shared__ int32_t smem[];
  const int32_t C = a.cluster;
  const int32_t warps = blockDim.x / W;
  const int32_t w = threadIdx.x / W;
  const int32_t lane = threadIdx.x & (W - 1);
  const int32_t rank = C > 1 ? (int32_t)cg::this_cluster().block_rank() : 0;
  const int32_t b = blockIdx.x / C;       // C blocks per pair
  const int32_t chain = C * warps;        // the pair's warps
  const int32_t wg = rank * warps + w;    // this warp's place in the chain
  const int32_t wg0 = rank * warps;       // the block's first warp's
  const bool profile = a.qidx == nullptr;
  const int32_t A = a.A, A1 = A + 1;
  const int32_t per_warp = W * kR;        // rows of a warp in a group
  const int32_t per_block = warps * per_warp;
  // the staged scores (score_cell.cuh): a profile row's column c is c * cs
  // past its start, a table row's c
  const int32_t prof_rows = ptscore::seg_prof_rows(kR, warps, a.Qs);
  const int32_t cs = profile ? ptscore::seg_prof_stride(prof_rows) : 1;
  const int32_t LR = ptscore::seg_letter_ring(a.Rseg);
  int32_t* sc = smem;
  int32_t* letters =
      sc + ptscore::seg_score_words(profile, kR, warps, a.Qs, A);
  int32_t* ring = letters + LR;           // (warps, kRows, RG): ring[w]
                                          // is read by warp w
  int32_t* olds = ring + warps * kRows * RG;        // (chain, kOldWords)
  int32_t* bests = olds + chain * kOldWords;        // (chain, kBestWords)
  const ptscore::SegPair p = ptscore::with_band(
      kTile ? ptscore::tile_pair(a.qlen[b], a.rlen[b], a.Qp, a.r0, a.Qs,
                                 a.off, a.Rseg, a.open, a.ext, a.mode,
                                 a.free_bits, A)
            : ptscore::seg_pair(a.qlen[b], a.rlen[b], a.Qp, a.off, a.Rseg,
                                a.open, a.ext, a.mode, a.free_bits,
                                a.resume != 0, A),
      a.bw, a.Rseg);
  const int32_t Rseg = a.Rseg;
  const int64_t bq = a.Bq == 1 ? 0 : b;
  const int32_t* prow = profile ? a.subs + bq * a.Qp * A : nullptr;
  const int32_t* q = profile ? nullptr : a.qidx + bq * a.Qp;
  const int32_t* mqb =
      O::stats ? a.mq + (a.Bm == 1 ? 0 : (int64_t)b * a.Qp) : nullptr;
  const int32_t* rseg = a.ridx + (int64_t)b * Rseg;
  int32_t* bot = a.bottom + (int64_t)b * kRows * Rseg;
  int32_t* dn = kTile ? a.down + (int64_t)b * kRows * Rseg : nullptr;
  int32_t* sh = a.st_h + (int64_t)b * a.Qs;
  int32_t* sf = a.st_f + (int64_t)b * a.Qs;
  int32_t* sp = O::stats ? a.st_pay + (int64_t)b * a.Qs : nullptr;
  const int64_t pay_plane = (int64_t)a.B * a.Qs;
  int8_t* tr = O::trace ? a.trace + (int64_t)b * a.Qs * Rseg : nullptr;
  ptscore::SegPlanes pl;
  if constexpr (O::table) {
    pl.table = a.tab + (int64_t)b * Rseg * a.Qp;
    pl.tab_plane = (int64_t)a.B * Rseg * a.Qp;
  }
  if constexpr (O::rowcol) {
    pl.row = a.rowp + (int64_t)b * Rseg;
    pl.row_plane = (int64_t)a.B * Rseg;
    pl.col = a.colp + (int64_t)b * a.Qp;
    pl.col_plane = (int64_t)a.B * a.Qp;
  }
  if (!profile)
    for (int32_t k = threadIdx.x; k < A1 * A1; k += blockDim.x)
      sc[k] = ptscore::seg_table_at(a.subs, A, k);
  // the tile hands on what it read above its last column, before any lane
  // of any of the pair's blocks writes the down-state
  if (kTile && rank == 0 && threadIdx.x == 0)
    ptscore::tile_corner_out<kOut>(dn, Rseg, a.t_out + (int64_t)b * 4);
  pair_sync(C);
  // the ring this warp reads, and the one it writes: the next warp's, or
  // for the block's last warp the next block's first warp's
  const int32_t* rd = ring + w * kRows * RG;
  int32_t* wr = w < warps - 1 ? ring + (w + 1) * kRows * RG
                              : (rank < C - 1 ? at_rank(ring, rank + 1, C)
                                              : nullptr);
  // warp 0 stages the letters that the block's warps read in round g0 + 1
  // (SEG_LANES steps): the first warp's lane 0 reads column g - LAG * wg0
  // at step g
  auto stage_letters = [&](int32_t g0) {
    const int32_t col = g0 + W - LAG * wg0 + lane;
    if (col >= 0 && col < p.ncols) copy_async4(letters + (col & (LR - 1)),
                                               rseg + col);
  };

  SegBest total = ptscore::seg_best_init(p);
  if (ptscore::seg_sweeps(p)) {           // all of the pair, or none of it
    ptscore::SegLane<kOut, kR> L;
    L.best = ptscore::seg_best_init(p);
    // the row above's H left of the segment (or tile)
    SegUp carry = kTile ? ptscore::tile_corner(a.t_in + (int64_t)b * 4)
                        : ptscore::seg_corner<kBanded>(p);
    const int32_t group = chain * per_warp;
    const bool vec = p.qp % kR == 0;
    const bool pack = Rseg % 4 == 0;
    for (int32_t i0 = p.row_lo; i0 < p.row_hi; i0 += group) {
      const int32_t blk0 = i0 + rank * per_block;   // the block's first row
      if (profile)
        ptscore::seg_stage_profile(
            sc, prow + (int64_t)blk0 * A,
            ptscore::imax(0, ptscore::imin(per_block, p.row_hi - blk0)), A,
            prof_rows, threadIdx.x, blockDim.x);
      if (w == 0) stage_letters(-W);
      SegUp old;
      ptscore::seg_lane_begin<kBanded>(L, p, blk0 + (w * W + lane) * kR, q,
                                       blk0, mqb, sh, sf, sp, pay_plane,
                                       old);
      // H[i0-1][off-1] of a lane's top row is the row above's H left of
      // the segment as it was before this call: from the lane above, for a
      // warp's first lane from the last lane of the warp above (every
      // block keeps every warp's), for the group's first row from the
      // group before
      const SegUp above = shfl_up1<kOut>(old);
      const SegUp last = shfl_from<kOut>(old, W - 1);
      if (lane == 0) {
        for (int32_t k = 0; k < C; ++k) {
          int32_t* o = at_rank(olds, k, C) + wg * kOldWords;
          o[0] = last.h;
          o[1] = last.hp.m;
          o[2] = last.hp.s;
          o[3] = last.hp.l;
        }
      }
      if (w == 0) copy_async_wait();
      pair_sync(C);
      SegUp prev = carry;
      if (wg > 0) {
        const int32_t* o = olds + (wg - 1) * kOldWords;
        prev.h = o[0];
        prev.hp = Pay{o[1], o[2], o[3]};
      }
      ptscore::seg_lane_diag(L, lane == 0 ? prev : above);
      {
        const int32_t* o = olds + (chain - 1) * kOldWords;
        carry.h = o[0];
        carry.hp = Pay{o[1], o[2], o[3]};
      }
      const int32_t nrows = ptscore::imin(group, p.row_hi - i0);
      const int32_t nw = (nrows + per_warp - 1) / per_warp;  // with rows
      const int32_t nl = ptscore::imax(
          0, ptscore::imin(W, (nrows - wg * per_warp + kR - 1) / kR));
      // steps of this warp's own sweep; an idle warp only keeps the rounds
      const int32_t nsteps = nl > 0 ? p.ncols + nl - 1 : -1;
      // where the warp's last lane leaves its bottom row: the next warp's
      // ring, or for the group's last row the scratch of the next group
      const bool to_ring = wr != nullptr && nrows > (wg + 1) * per_warp;
      const bool to_bot = wg == chain - 1 && i0 + group < p.row_hi;
      const bool first = i0 == p.row_lo;

      // what lane 0 reads above column c: the warp above's last row, the
      // top border (a tile: the down-state it was given), or the group
      // before's last row
      auto top0 = [&](int32_t c) {
        if (c >= p.ncols) return SegUp();
        if (first)
          return kTile ? ptscore::seg_up_load<kOut>(dn, Rseg, c)
                       : ptscore::seg_top<kBanded>(p, p.off + c);
        return ptscore::seg_up_load<kOut>(bot, Rseg, c);
      };
      auto top = [&](int32_t c) {
        if (wg > 0) return ptscore::seg_up_load<kOut>(rd, RG, c & (RG - 1));
        return top0(c);
      };
      // the first warp's staged rows above: lane j holds column base + j
      // of this round (tb) and of the next (tb_next), base = the round's
      // first step, which is the column lane 0 fetches at that step
      SegUp tb, tb_next;
      if (kTopAhead && wg == 0) {
        tb = top0(lane);
        tb_next = top0(W + lane);
      }
      SegUp pre;                          // lane 0: one step ahead
      int32_t r_next = 0;                 // every lane: one step ahead
      int32_t s_next[kR];                 // its rows' scores against it
      ptscore::seg_lane_scores(L, sc, A * cs, s_next);
      int8_t* trow =
          O::trace ? tr + (int64_t)(L.i0 - p.row_lo) * Rseg : nullptr;
      const int32_t gsteps = ptscore::seg_group_steps(p.ncols, nw);
      // the group's steps at which this warp has one of its own, -1 (the
      // fetch ahead) to nsteps - 1
      const int32_t lo = LAG * wg;
      const int32_t hi = lo + nsteps + 1;
      for (int32_t g0 = 0; g0 < gsteps; g0 += W) {
        if (w == 0) stage_letters(g0);
        const int32_t g1 = ptscore::imin(g0 + W, hi);
#pragma unroll 2
        for (int32_t g = ptscore::imax(g0, lo); g < g1; ++g) {
          const int32_t t = ptscore::seg_local_step(g, wg);
          SegUp up = shfl_up1<kOut>(L.out);
          const int32_t c = t - lane;
          if (kTopAhead && wg == 0) {
            const SegUp next = shfl_idx<kOut>(tb, g & (W - 1));
            if (lane == 0) {
              up = pre;
              pre = next;
            }
          } else if (lane == 0) {
            up = pre;
            if (t + 1 < p.ncols) pre = top(t + 1);
          }
          const int32_t r = r_next;
          int32_t s[kR];
#pragma unroll
          for (int32_t k = 0; k < kR; ++k) s[k] = s_next[k];
          if (L.nr > 0 && c + 1 >= 0 && c + 1 < p.ncols) {
            r_next = letters[(c + 1) & (LR - 1)];
            ptscore::seg_lane_scores(L, sc, ptscore::seg_col(r_next, A) * cs,
                                     s_next);
          }
          if (t >= 0 && L.nr > 0 && c >= 0 && c < p.ncols) {
            ptscore::seg_lane_step<kOut, kR, kBanded>(
                L, p, c, r, s, up, trow, Rseg, sh, sf, sp, pay_plane, pl, dn,
                vec, pack);
            if (lane == W - 1 && to_ring)
              ptscore::seg_up_store<kOut>(wr, RG, c & (RG - 1), L.out);
            if (lane == W - 1 && to_bot)
              ptscore::seg_up_store<kOut>(bot, Rseg, c, L.out);
          }
        }
        // one round of W steps: what a warp's last lane wrote in it, the
        // warp below reads a round later; the last round also puts the
        // group's last row, `olds` and the staged rows behind the next
        // group's accesses
        if (kTopAhead && wg == 0) {
          tb = tb_next;
          tb_next = top0(g0 + 2 * W + lane);
        }
        if (w == 0) copy_async_wait();
        pair_sync(C);
      }
      ptscore::seg_lane_fold(L);
    }
    total = L.best;
    for (int m = W / 2; m > 0; m >>= 1)
      total = ptscore::seg_merge(total, shfl_xor_best(total, m));
    if (lane == 0) {
      int32_t* o = at_rank(bests, 0, C) + wg * kBestWords;
      o[0] = total.h;
      o[1] = total.i;
      o[2] = total.j;
      o[3] = total.p.m;
      o[4] = total.p.s;
      o[5] = total.p.l;
      o[6] = total.hmax;
      o[7] = total.hmin;
    }
    pair_sync(C);
    if (rank == 0 && threadIdx.x == 0) {
      for (int32_t k = 1; k < chain; ++k) {
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
  if (rank == 0 && threadIdx.x == 0) {
    const ptscore::PairResult r =
        ptscore::seg_finish<kOut, kBanded>(p, a.mode, total,
                                           a.acc + (int64_t)b * 8);
    const int32_t B = a.B;
    a.out[b] = r.score;
    a.out[B + b] = r.end_query;
    a.out[2 * B + b] = r.end_ref;
    a.out[3 * B + b] = r.sat8;
    a.out[4 * B + b] = r.sat16;
    if constexpr (O::stats) {
      a.out[5 * B + b] = r.matches;
      a.out[6 * B + b] = r.similar;
      a.out[7 * B + b] = r.length;
    }
  }
}

constexpr int kMaxDevices = 64;

// Let a form take the whole shared memory a block may opt in to on the
// current device.  The attribute is the device's, so it is set once per
// form and device; `done` is the form's own flags.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<bool> (&done)[kMaxDevices]) {
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && done[dev].load())) return e;
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return e;
}

template <int32_t kOut, bool kTile, int32_t kR, bool kBanded>
int launch_form(const SegArgs& a, const ptscore::SegPlan& plan,
                cudaStream_t stream) {
  auto kernel = segment_kernel<kOut, kTile, kR, kBanded>;
  static std::atomic<bool> allowed[kMaxDevices];
  const cudaError_t smem = allow_smem(kernel, allowed);
  if (smem != cudaSuccess) return (int)smem;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.B * plan.cluster));
  cfg.blockDim = dim3((unsigned)(plan.warps * ptscore::SEG_LANES));
  cfg.dynamicSmemBytes = (size_t)ptscore::seg_block_bytes(
      kOut, a.qidx == nullptr, kR, plan.warps, plan.cluster, a.A, a.Qs,
      a.Rseg);
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

// The plan a launch of class kOut takes (score_cell.cuh's seg_plan):
// warps, rows and cluster 0 leave each to the rule.
inline ptscore::SegPlan plan_of(int32_t out_class, const SegArgs& a,
                                int warps, int rows, int cluster) {
  return ptscore::seg_plan(out_class, a.B, a.Qs, a.Rseg, a.A,
                           a.qidx == nullptr, warps, rows, cluster);
}

// Launches class kOut's form for the plan (kBanded: its masked form, at
// a.bw); a plan outside the compiled forms (rows not among 2, 4, 8, or 8
// for a class other than score and rowcol; warps or a cluster outside
// 1-8) returns cudaErrorInvalidValue.
template <int32_t kOut, bool kTile, bool kBanded = false>
int launch(SegArgs a, int warps, int rows, int cluster, void* stream) {
  if (a.B <= 0) return 0;
  const ptscore::SegPlan plan = plan_of(kOut, a, warps, rows, cluster);
  if (plan.warps < 1 || plan.warps > ptscore::SEG_MAX_WARPS ||
      plan.cluster < 1 || plan.cluster > ptscore::SEG_MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  a.cluster = plan.cluster;
  cudaStream_t s = (cudaStream_t)stream;
  switch (plan.rows) {
    case 2:
      return launch_form<kOut, kTile, 2, kBanded>(a, plan, s);
    case 4:
      return launch_form<kOut, kTile, 4, kBanded>(a, plan, s);
    case 8:
      if constexpr (ptscore::seg_wide_class(kOut))
        return launch_form<kOut, kTile, 8, kBanded>(a, plan, s);
      break;
    default:
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace ptsegblock
