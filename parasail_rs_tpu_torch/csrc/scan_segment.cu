// Resumable segment kernel for Hopper (sm_90a): long pairs, a block each.
//
// Replaces: parasail_rs_tpu/ops/scan_kernel.py::scan_score_segment (the
// pallas_call at scan_kernel.py:1672 over the body _make_kernel with
// stream=True), in its score, stats and trace classes.  One call sweeps
// columns [col_offset, col_offset + Rseg) of every pair of a padded batch
// and carries the sweep's state in and out: H and F of every query row at
// the pair's last column so far, the stats payloads of both, and the
// accumulator (best cell, extremes of H, the best cell's payload); see
// score_cell.cuh, "the segment form".  After the last segment the outputs
// are the one-shot kernel's (scan_score.cu) for the same class, bit for
// bit; the trace class writes the segment's flags, (B, Qp, Rseg) int8.
//
// Design: a block per pair, one to eight warps of 32 lanes, a query row a
// lane.  What bounds the one-shot kernel on long pairs is the dependent
// chain of its one thread per pair (a cell's H needs the cell to its
// left), about 225 ns a cell, while a batch of 128 long pairs leaves all
// but two SMs idle.  Here the lanes of a warp take a stripe of 32 query
// rows and sweep the segment's columns skewed by one: at step t lane l
// computes column t - l of its row, so H and E of the cell above arrive
// from lane l - 1 by one __shfl_up_sync each (with the stats forms, their
// six payloads too), the diagonal is what arrived one step earlier, and H
// to the left and F stay in registers.  The warps of a block take
// consecutive stripes of one group of rows: warp w runs 64 steps behind
// warp w - 1 and reads that warp's last row from a ring of 128 columns in
// shared memory.  The block meets at a barrier every 32 steps, and the lag
// puts one barrier between a column's write and its read and another
// before its slot is reused, so no warp ever waits on another in a loop.
// The group's last row goes to a per-pair scratch row of Rseg columns in
// global memory, which the first warp of the next group reads; lane 0
// fetches what it reads one step ahead of its use, and every lane its
// next letter and substitution score, off the dependent chain.  Each lane
// writes its row's H and F at the pair's last column into the state, in
// place: a lane reads only its own row's state, and the diagonal of the
// row below travels by shuffle (between warps, through shared memory)
// before anything is written.  Each lane keeps the first maximum of its
// own rows; warp and block reduce in the end cell's order (H descending,
// i ascending, j ascending) and thread 0 folds the result into the
// carried accumulator.  The (A, A) table sits in shared memory as in the
// one-shot kernel.  The launcher gives a pair as many warps as fill the
// card (eight for 128 pairs, one from about a thousand pairs on).
//
// What bounds it on this card: still latency, now of one step of a warp
// (two shuffles, the max-plus cell, its predicates and address
// arithmetic: about 110 instructions), which 32 cells share; the batch's
// warps hide it from each other.  Several rows a lane and DPX max-plus
// instructions are the next forms.
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_cell.cuh"

namespace {

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

template <int32_t kOut>
__global__ void segment_kernel(
    const int32_t* __restrict__ subs,   // (A, A) table or (Bq, Qp, A) rows
    const int32_t* __restrict__ qidx,   // (Bq, Qp) letters; null: profile
    const int32_t* __restrict__ mq,     // stats: (Bm, Qp) letters
    const int32_t* __restrict__ ridx,   // (B, Rseg): this segment's letters
    const int32_t* __restrict__ qlen,   // (B,)
    const int32_t* __restrict__ rlen,   // (B,) global reference lengths
    int32_t* bottom,                    // (B, 2 or 8, Rseg) scratch
    int32_t* st_h,                      // (B, Qp) state, in place
    int32_t* st_f,                      // (B, Qp)
    int32_t* st_pay,                    // stats: (6, B, Qp)
    int32_t* acc,                       // (B, 8)
    int32_t* __restrict__ out,          // (5 or 8, B)
    int8_t* __restrict__ trace,         // trace: (B, Qp, Rseg) flags
    int32_t B, int32_t Bq, int32_t Bm, int32_t Qp, int32_t Rseg, int32_t A,
    int32_t open, int32_t ext, int32_t mode, int32_t free_bits, int32_t off,
    int32_t resume, int32_t table_in_smem) {
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
  __syncthreads();
  const int32_t b = blockIdx.x;         // one block per pair
  const ptscore::SegPair p = ptscore::seg_pair(
      qlen[b], rlen[b], Qp, off, Rseg, open, ext, mode, free_bits,
      resume != 0, A);
  const int64_t bq = Bq == 1 ? 0 : b;
  const int32_t* rows = qidx ? table : subs + bq * Qp * A;
  const int32_t* q = qidx ? qidx + bq * Qp : nullptr;
  const int32_t* mqb = O::stats ? mq + (Bm == 1 ? 0 : (int64_t)b * Qp)
                                : nullptr;
  const int32_t* rseg = ridx + (int64_t)b * Rseg;
  int32_t* bot = bottom + (int64_t)b * kRows * Rseg;
  int32_t* sh = st_h + (int64_t)b * Qp;
  int32_t* sf = st_f + (int64_t)b * Qp;
  int32_t* sp = O::stats ? st_pay + (int64_t)b * Qp : nullptr;
  const int64_t pay_plane = (int64_t)B * Qp;
  int8_t* tr = O::trace ? trace + (int64_t)b * Qp * Rseg : nullptr;
  // the rings this warp reads (the warp above's) and writes (its own)
  const int32_t* rd = ring + (w > 0 ? w - 1 : 0) * kRows * R;
  int32_t* wr = ring + (w < warps - 1 ? w : 0) * kRows * R;

  SegBest total = ptscore::seg_best_init(p);
  if (ptscore::seg_sweeps(p)) {           // the whole block, or none of it
    ptscore::SegLane<kOut> L;
    L.best = ptscore::seg_best_init(p);
    SegUp carry = ptscore::seg_corner(p);   // row -1, left of the segment
    const int32_t group = warps * W;
    for (int32_t i0 = 0; i0 < p.qlen; i0 += group) {
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
      const int32_t nrows = ptscore::imin(group, p.qlen - i0);
      const int32_t nw = (nrows + W - 1) / W;          // warps with rows
      const int32_t nl = ptscore::imax(0, ptscore::imin(W, nrows - w * W));
      // steps of this warp's own sweep; an idle warp only keeps the rounds
      const int32_t nsteps = nl > 0 ? p.ncols + nl - 1 : -1;
      // where the warp's last lane leaves its row: the next warp's ring,
      // or for the group's last row the scratch of the next group
      const bool to_ring = w < warps - 1 && nrows > (w + 1) * W;
      const bool to_bot = w == warps - 1 && i0 + group < p.qlen;
      const bool first = i0 == 0;

      // what lane 0 reads above column c: the top border, the group
      // before's last row, or the warp above's last row
      auto top = [&](int32_t c) {
        if (w > 0) return ptscore::seg_up_load<kOut>(rd, R, c & (R - 1));
        if (first) return ptscore::seg_top(p, p.off + c);
        return ptscore::seg_up_load<kOut>(bot, Rseg, c);
      };
      SegUp pre;                          // lane 0: one step ahead
      int32_t r_next = 0, s_next = 0;     // every lane: one step ahead
      int8_t* trow = O::trace ? tr + (int64_t)L.i * Rseg : nullptr;
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
            ptscore::seg_cell(L, p, c, r, s, up, trow, sh, sf, sp, pay_plane);
            if (lane == W - 1) {
              if (to_ring) {
                ptscore::seg_up_store<kOut>(wr, R, c & (R - 1), L.out);
              } else if (to_bot) {
                ptscore::seg_up_store<kOut>(bot, Rseg, c, L.out);
              }
            }
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

template <int32_t kOut>
int launch(const void* subs, const void* qidx, const void* mq,
           const void* ridx, const void* qlen, const void* rlen, void* bottom,
           void* st_h, void* st_f, void* st_pay, void* acc, void* out,
           void* trace, int B, int Bq, int Bm, int Qp, int Rseg, int A,
           int open, int ext, int mode, int free_bits, int off, int resume,
           int warps, void* stream) {
  if (B <= 0) return 0;
  constexpr int rows = ptscore::Out<kOut>::stats ? 8 : 2;
  if (warps <= 0) {
    // a block per pair: as many warps as fill the card, at most one per
    // 32 query rows
    warps = kWarpsWanted / B;
    const int most = (Qp + ptscore::SEG_LANES - 1) / ptscore::SEG_LANES;
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
  segment_kernel<kOut>
      <<<B, warps * ptscore::SEG_LANES, smem, (cudaStream_t)stream>>>(
          (const int32_t*)subs, (const int32_t*)qidx, (const int32_t*)mq,
          (const int32_t*)ridx, (const int32_t*)qlen, (const int32_t*)rlen,
          (int32_t*)bottom, (int32_t*)st_h, (int32_t*)st_f, (int32_t*)st_pay,
          (int32_t*)acc, (int32_t*)out, (int8_t*)trace, B, Bq, Bm, Qp, Rseg,
          A, open, ext, mode, free_bits, off, resume, in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the segment kernel on `stream` and returns cudaGetLastError()
// as an int (0 = launched).  All pointers are device pointers.
//   out_class: 0 score, 1 trace, 2 stats (ptscore::OutClass); any other
//              returns cudaErrorInvalidValue
//   subs/qidx: as pt_scan_score (qidx null: the profile form)
//   mq:        stats: (Bm, Qp) query letters for `matches`
//   ridx:      (B, Rseg) letters of columns [off, off + Rseg)
//   rlen:      the pairs' whole reference lengths
//   bottom:    scratch, (B, 2, Rseg), or (B, 8, Rseg) for stats
//   st_h/st_f: (B, Qp) state, read (if resume) and written in place
//   st_pay:    stats: (6, B, Qp) state payloads
//   acc:       (B, 8) accumulator, read (if resume) and written in place
//   out:       (5, B), or (8, B) for stats
//   trace:     trace: (B, Qp, Rseg) int8, zero-filled by the caller
//   warps:     warps a pair (1 to 8); 0 lets the batch's shape pick
extern "C" int pt_scan_segment(int out_class, const void* subs,
                               const void* qidx, const void* mq,
                               const void* ridx, const void* qlen,
                               const void* rlen, void* bottom, void* st_h,
                               void* st_f, void* st_pay, void* acc, void* out,
                               void* trace, int B, int Bq, int Bm, int Qp,
                               int Rseg, int A, int open, int ext, int mode,
                               int free_bits, int off, int resume, int warps,
                               void* stream) {
#define PT_SEG(k)                                                          \
  launch<k>(subs, qidx, mq, ridx, qlen, rlen, bottom, st_h, st_f, st_pay,  \
            acc, out, trace, B, Bq, Bm, Qp, Rseg, A, open, ext, mode,      \
            free_bits, off, resume, warps, stream)
  switch (out_class) {
    case ptscore::OUT_SCORE:
      return PT_SEG(ptscore::OUT_SCORE);
    case ptscore::OUT_TRACE:
      return PT_SEG(ptscore::OUT_TRACE);
    case ptscore::OUT_STATS:
      return PT_SEG(ptscore::OUT_STATS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PT_SEG
}
