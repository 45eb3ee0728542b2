// The one-shot sweep of short pairs, every output class, for Hopper
// (sm_90a): one warp a pair, several pairs a block.  scan_short.cu
// instantiates it unbanded, scan_short_banded.cu masked to a band (kBanded),
// each in its own nvcc process.
//
// Replaces: parasail_rs_tpu/ops/scan_kernel.py::scan_score_align (the
// pallas_call at scan_kernel.py:1453 over the body _make_kernel) in all
// seven of its output classes, unbanded, for pairs of Qp <= 256 padded
// query rows: score (outputs="score", kernel K1a; the end cell's ties at
// :1011-1101, the width-8/16 flags at :1127-1149), trace (K1b; flags at
// :865-888), stats (K1c; payloads at :844-863, packed as
// stats_pack_params / stats_pack2_params lay them out, :364-402), and the
// plane classes table, stats_table, rowcol and stats_rowcol (K1d;
// :979-999, :1498-1519).  Same outputs, bit for bit: score, end_query,
// end_ref, the width-8/16 saturation flags, each in-sequence cell's flags,
// the winning path's matches / similar / length, every in-sequence cell's
// H (and payload), or the last row's and last column's, in NW, the nine SG
// free-end sets and SW, with an (A, A) table and letters or (1 or B, Qp,
// A) profile rows, at every penalty pair.
//
// Design (score_cell.cuh, "the short form"): lane L of a pair's warp holds
// query rows [L kR, L kR + kR), kR = 4, 5, 6 or 8, the fewest whose warp
// holds Qp, and at step t computes column t - L of them top to bottom on
// DPX max-plus; H, E and F stay in registers, and one shuffle a step
// brings the bottom row of the lane above (H, E and, for the stats
// classes, their packed payloads: four words, or six with the length
// apart).  A pair takes Rp + Qp / kR steps instead of the Qp x Rp
// dependent cells of one thread a pair.  The block stages
// the (A + 1)^2 table (a column and a row of 0 for letters outside the
// alphabet) or a shared profile once, each warp its pair's profile rows
// and all of its reference letters (cp.async): no ring, no refill, no
// barrier after the staging, no cluster.  The end cell is folded across
// the warp by shuffles (seg_merge).  The trace class gathers each row's
// flags four columns a word and 16 columns a 16-byte store into the
// pair's (Qp, Rp) plane (rows Rp bytes apart; Rp a multiple of 16, else a
// byte a cell: short_wide), which the traceback walk reads in place.  A
// warp's store lands on as many rows as it has lanes, so each is a
// transaction of its own; wide stores make them few.  The table classes
// write each lane's kR rows of a column into (nplanes, B, Rp, Qp) planes,
// query-fastest, as one short vector a plane (16 bytes at 4 and 8 rows,
// 8 at 6, word by word at 5 or where Qp does not align it), payloads
// unpacked at the store; the rowcol classes the last row from the lane
// that holds row qlen - 1, a word a step, and every lane's rows of the
// last column once the sweep ends.  A lane with rows past the pair stores
// row by row, masked, so no store lands outside the pair's cells.
//
// What bounds it on this card: the step's dependent chain (kR cells, each
// a few DPX operations, E running down the rows) times Rp + Qp / kR
// steps, and how many warps the SMs hold to hide it; the pairs a block
// (score_cell.cuh, short_plan) put a 512-pair chunk on 128 SMs.  The
// score, stats and rowcol classes write little beyond the scalars; the
// trace class one byte a cell, the table classes 4 or 16 bytes a cell,
// as 32 scattered vectors a warp store (each lane its own column).  Pairs
// of Qp > 256, or whose letters a block cannot stage, are the block
// kernel's (the caller launches its one-shot form instead).
//
// The banded mode (K1e: banded=True, bandwidth; scan_kernel.py:1307-1308,
// masks :602-617) in every class but the ring's (scan_banded.cu: the
// score class within its reach) is the same warp with kBanded: the masked
// full sweep of score_pair<kOut, true>, cell by cell.  Each cell takes
// its flags or payloads from its masked neighbours, then H, E and F
// become NEG_INF32 where |i - j| > bw, before its stores, its shuffle to
// the lane below, the extremes behind the saturation flags and the end
// cell's candidate test; the borders are band_border's and a pair with an
// empty side takes empty_side<true>.  So every output, outside the band
// too, is the plain version's.  A cell costs a compare and three selects
// more; the band is a template parameter, so the unbanded forms carry
// none of it.  Every cell is swept however narrow the band: at bw 16 on
// 192 x 192 pairs 80% of them lie outside it.
#pragma once

#include <type_traits>

#include "segment_block.cuh"

namespace {

using ptscore::SegBest;
using ptscore::ShortLane;
using ptscore::ShortUp;
using ptsegblock::kFull;

struct ShortArgs {
  const int32_t* subs;   // (A, A) table or (Bq, Qp, A) rows
  const int32_t* qidx;   // (Bq, Qp) letters; null: profile
  const int32_t* mq;     // stats: (Bm, Qp) letters
  const int32_t* ridx;   // (B, Rp)
  const int32_t* qlen;   // (B,)
  const int32_t* rlen;   // (B,)
  int32_t* out;          // (5 or 8, B)
  int8_t* trace;         // trace: (B, Qp, Rp) flags, zero-filled
  int32_t* tab;          // table classes: (1 or 4, B, Rp, Qp), zero-filled
  int32_t* row;          // rowcol classes: (1 or 4, B, Rp), zero-filled
  int32_t* col;          //                 (1 or 4, B, Qp), zero-filled
  int32_t B, Bq, Bm, Qp, Rp, A, open, ext, mode, free_bits;
};

// The masked forms' arguments: ShortArgs and the band's half-width.  A
// struct of their own, so that the unbanded forms' parameters stay as
// they are: one more word in ShortArgs moved ptxas's register choice in
// every unbanded form, and the trace form at 6 rows spilled.
struct ShortBandArgs : ShortArgs {
  int32_t bw;
};

template <bool kBanded>
using ShortArgsOf = std::conditional_t<kBanded, ShortBandArgs, ShortArgs>;

__device__ __forceinline__ int32_t shfl_up1(int32_t v) {
  return __shfl_up_sync(kFull, v, 1);
}
__device__ __forceinline__ ptscore::Pay2 shfl_up1(const ptscore::Pay2& v) {
  return ptscore::Pay2{shfl_up1(v.ms), shfl_up1(v.l)};
}
__device__ __forceinline__ ptscore::NoPay shfl_up1(const ptscore::NoPay& v) {
  return v;
}

template <class PO>
__device__ __forceinline__ ShortUp<PO> shfl_up1(const ShortUp<PO>& v) {
  ShortUp<PO> r;
  r.h = shfl_up1(v.h);
  r.e = shfl_up1(v.e);
  r.hp = shfl_up1(v.hp);
  r.ep = shfl_up1(v.ep);
  return r;
}

// One block's pairs, a warp each (the body of both kernels below).
template <int32_t kOut, int32_t kR, bool kBanded, class PO>
__device__ __forceinline__ void short_block(const ShortArgsOf<kBanded>& a,
                                            const PO& po) {
  using O = ptscore::Out<kOut>;
  constexpr int32_t W = ptscore::SEG_LANES;
  extern __shared__ int32_t smem[];
  const int32_t pairs = blockDim.x / W;
  const int32_t w = threadIdx.x / W;
  const int32_t lane = threadIdx.x & (W - 1);
  const int32_t b = blockIdx.x * pairs + w;
  const bool profile = a.qidx == nullptr;
  const bool per_pair = profile && a.Bq != 1;
  const int32_t A = a.A;
  const int32_t cs = profile ? ptscore::seg_prof_stride(ptscore::imax(a.Qp, 1))
                             : 1;
  const int64_t set = ptscore::short_score_words(profile, a.Qp, A);
  int32_t* sc = smem + (per_pair ? w * set : 0);
  int32_t* letters = smem + set * (per_pair ? pairs : 1) +
                     (int64_t)w * ptscore::imax(a.Rp, 1);
  // the block's scores, once: the table, or the profile every pair shares
  if (!profile) {
    for (int32_t k = threadIdx.x; k < (A + 1) * (A + 1); k += blockDim.x)
      smem[k] = ptscore::seg_table_at(a.subs, A, k);
  } else if (!per_pair) {
    ptscore::seg_stage_profile(smem, a.subs, a.Qp, A, ptscore::imax(a.Qp, 1),
                               threadIdx.x, blockDim.x);
  }
  __syncthreads();
  if (b >= a.B) return;                  // whole warps: b is the warp's
  ptscore::SegPair p = ptscore::seg_pair(
      a.qlen[b], a.rlen[b], a.Qp, 0, a.Rp, a.open, a.ext, a.mode,
      a.free_bits, false, A);
  if constexpr (kBanded) p = ptscore::with_band(p, a.bw, a.Rp);
  const int64_t bq = a.Bq == 1 ? 0 : b;
  // the warp's own inputs: its pair's profile rows, and its letters
  if (per_pair)
    ptscore::seg_stage_profile(sc, a.subs + bq * a.Qp * A, a.Qp, A,
                               ptscore::imax(a.Qp, 1), lane, W);
  const int32_t* rb = a.ridx + (int64_t)b * a.Rp;
  for (int32_t k = lane; k < p.ncols; k += W)
    ptsegblock::copy_async4(letters + k, rb + k);
  ptsegblock::copy_async_wait();
  __syncwarp();

  SegBest total = ptscore::seg_best_init(p);
  if (ptscore::seg_sweeps(p)) {          // the whole warp, or none of it
    const int32_t* q = profile ? nullptr : a.qidx + bq * a.Qp;
    const int32_t* mq =
        O::stats ? a.mq + (a.Bm == 1 ? 0 : (int64_t)b * a.Qp) : nullptr;
    ShortLane<kR, PO> L;
    ShortUp<PO> old;
    ptscore::short_lane_begin<kOut, kBanded>(L, p, lane, q, mq, po, old);
    ShortUp<PO> above = shfl_up1(old);
    if (lane == 0) {                     // the corner H[-1][-1]
      above.h = kBanded ? ptscore::seg_border<kBanded>(p, 0, p.qb) : 0;
      above.hp = po.zero();
    }
    ptscore::short_lane_diag(L, above);
    const int32_t nl = ptscore::imin(W, ptscore::seg_div_up(p.qlen, kR));
    int8_t* trow = O::trace ? a.trace + ((int64_t)b * a.Qp + L.i0) * a.Rp
                            : nullptr;
    const bool wide = ptscore::short_wide(a.Rp);
    ptscore::SegPlanes pl;               // the pair's planes, rows, columns
    if constexpr (O::table) {
      pl.table = a.tab + (int64_t)b * a.Rp * a.Qp;
      pl.tab_plane = (int64_t)a.B * a.Rp * a.Qp;
    }
    if constexpr (O::rowcol) {
      pl.row = a.row + (int64_t)b * a.Rp;
      pl.row_plane = (int64_t)a.B * a.Rp;
      pl.col = a.col + (int64_t)b * a.Qp;
      pl.col_plane = (int64_t)a.B * a.Qp;
    }
    const bool vec = ptscore::short_vec_ok(kR, a.Qp);
    // each lane fetches its next letter and its rows' scores a step ahead
    int32_t r_next = 0;
    int32_t s_next[kR];
    ptscore::short_lane_scores(L, sc, A * cs, s_next);
#pragma unroll 2
    for (int32_t t = -1; t < p.ncols + nl - 1; ++t) {
      ShortUp<PO> up = shfl_up1(L.out);
      const int32_t c = t - lane;
      if (lane == 0) up = ptscore::short_top<kBanded>(p, c, po);
      const int32_t r = r_next;
      int32_t s[kR];
#pragma unroll
      for (int32_t k = 0; k < kR; ++k) s[k] = s_next[k];
      if (L.nr > 0 && c + 1 >= 0 && c + 1 < p.ncols) {
        r_next = letters[c + 1];
        ptscore::short_lane_scores(L, sc, ptscore::seg_col(r_next, A) * cs,
                                   s_next);
      }
      if (t >= 0 && L.nr > 0 && c >= 0 && c < p.ncols)
        ptscore::short_lane_step<kOut, kBanded>(L, p, c, r, s, up, trow,
                                                a.Rp, wide, pl, vec, po);
    }
    if (L.nr > 0) ptscore::short_lane_last_col<kOut>(L, p, pl, vec, po);
    total = ptscore::short_lane_best(L, po);
    for (int m = W / 2; m > 0; m >>= 1)
      total = ptscore::seg_merge(total, ptsegblock::shfl_xor_best(total, m));
  }
  if (lane == 0) {
    int32_t acc[8];
    const ptscore::PairResult r =
        ptscore::seg_finish<kOut, kBanded>(p, a.mode, total, acc);
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

constexpr int32_t kThreads = ptscore::SHORT_MAX_PAIRS * ptscore::SEG_LANES;

// The stats classes and the unbanded trace class: ptxas picks the
// registers.
template <int32_t kOut, int32_t kR, bool kBanded, class PO>
__global__ void __launch_bounds__(kThreads)
    short_kernel(const ShortArgsOf<kBanded> a, const PO po) {
  short_block<kOut, kR, kBanded>(a, po);
}

// The score and plane classes, and the masked trace class, ask for one
// block an SM or more: left to itself, ptxas held stats_table's [m | s] +
// l form at 6 rows, and the masked trace form at 6 rows, to 128 registers
// and spilled; asked so, they spill nothing, and the other forms keep
// about the registers they took unbounded.
template <int32_t kOut, int32_t kR, bool kBanded, class PO>
__global__ void __launch_bounds__(kThreads, 1)
    short_kernel_one(const ShortArgsOf<kBanded> a, const PO po) {
  short_block<kOut, kR, kBanded>(a, po);
}

template <int32_t kOut, int32_t kR, bool kBanded, class PO>
int launch_form(const ShortArgsOf<kBanded>& a, const ptscore::ShortPlan& plan,
                const PO& po, cudaStream_t stream) {
  void (*kernel)(const ShortArgsOf<kBanded>, const PO);
  if constexpr ((ptscore::Out<kOut>::trace && !kBanded) ||
                kOut == ptscore::OUT_STATS)
    kernel = short_kernel<kOut, kR, kBanded, PO>;
  else
    kernel = short_kernel_one<kOut, kR, kBanded, PO>;
  static std::atomic<bool> allowed[ptsegblock::kMaxDevices];
  const cudaError_t smem = ptsegblock::allow_smem(kernel, allowed);
  if (smem != cudaSuccess) return (int)smem;
  const bool profile = a.qidx == nullptr;
  const size_t bytes = (size_t)ptscore::short_block_bytes(
      plan.pairs, a.Qp, a.Rp, a.A, profile, profile && a.Bq != 1);
  const int blocks = ptscore::seg_div_up(a.B, plan.pairs);
  kernel<<<blocks, plan.pairs * ptscore::SEG_LANES, bytes, stream>>>(a, po);
  return (int)cudaGetLastError();
}

template <int32_t kOut, bool kBanded, class PO>
int launch_rows(const ShortArgsOf<kBanded>& a,
                const ptscore::ShortPlan& plan, const PO& po,
                cudaStream_t stream) {
  switch (plan.rows) {
    case 4:
      return launch_form<kOut, 4, kBanded>(a, plan, po, stream);
    case 5:
      return launch_form<kOut, 5, kBanded>(a, plan, po, stream);
    case 6:
      return launch_form<kOut, 6, kBanded>(a, plan, po, stream);
    default:
      return launch_form<kOut, 8, kBanded>(a, plan, po, stream);
  }
}

// Launches the short form (kBanded: its masked form at half-width bw) of
// class `out_class` (ptscore::OutClass, 0-6) on `stream` and returns the
// launch's CUDA error as an int (0 = launched); the arguments are
// pt_scan_short's (scan_short.cu).  A batch the rule (score_cell.cuh,
// short_plan) does not give the short form returns cudaErrorInvalidValue.
template <bool kBanded>
int scan_short(int out_class, const void* subs, const void* qidx,
               const void* mq, const void* ridx, const void* qlen,
               const void* rlen, void* out, void* trace, void* tab, void* row,
               void* col, int B, int Bq, int Bm, int Qp, int Rp, int A,
               int open, int ext, int mode, int free_bits, int bw,
               void* stream) {
  if (B <= 0) return 0;
  const bool profile = qidx == nullptr;
  const ptscore::ShortPlan plan = ptscore::short_plan(
      out_class, B, Qp, Rp, A, profile, profile && Bq != 1);
  if (plan.rows == 0) return (int)cudaErrorInvalidValue;
  ShortArgsOf<kBanded> a;
  static_cast<ShortArgs&>(a) = ShortArgs{
      (const int32_t*)subs, (const int32_t*)qidx, (const int32_t*)mq,
      (const int32_t*)ridx, (const int32_t*)qlen, (const int32_t*)rlen,
      (int32_t*)out,        (int8_t*)trace,       (int32_t*)tab,
      (int32_t*)row,        (int32_t*)col,        B, Bq, Bm, Qp, Rp, A, open,
      ext, mode, free_bits};
  if constexpr (kBanded) a.bw = ptscore::clamp_band(bw, Qp, Rp);
  cudaStream_t s = (cudaStream_t)stream;
  const ptscore::NoPayOps none;
  const bool packed = plan.layout == ptscore::SHORT_PACKED;
  // the stats classes in the payload layout of the plan
#define PT_STATS(k)                                                      \
  (packed ? launch_rows<k, kBanded>(a, plan, ptscore::pack_ops(Qp, Rp), s) \
          : launch_rows<k, kBanded>(a, plan, ptscore::pack2_ops(Qp), s))
  switch (out_class) {
    case ptscore::OUT_SCORE:
      return launch_rows<ptscore::OUT_SCORE, kBanded>(a, plan, none, s);
    case ptscore::OUT_TRACE:
      return launch_rows<ptscore::OUT_TRACE, kBanded>(a, plan, none, s);
    case ptscore::OUT_STATS:
      return PT_STATS(ptscore::OUT_STATS);
    case ptscore::OUT_TABLE:
      return launch_rows<ptscore::OUT_TABLE, kBanded>(a, plan, none, s);
    case ptscore::OUT_STATS_TABLE:
      return PT_STATS(ptscore::OUT_STATS_TABLE);
    case ptscore::OUT_ROWCOL:
      return launch_rows<ptscore::OUT_ROWCOL, kBanded>(a, plan, none, s);
    default:
      return PT_STATS(ptscore::OUT_STATS_ROWCOL);
  }
#undef PT_STATS
}

}  // namespace
