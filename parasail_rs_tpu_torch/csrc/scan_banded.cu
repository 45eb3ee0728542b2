// The banded score form for Hopper (sm_90a): a pair's query rows as a ring
// of row blocks over a group of 8, 16 or 32 lanes.
//
// Replaces: parasail_rs_tpu/ops/scan_kernel.py::scan_score_align (the
// pallas_call at scan_kernel.py:1453 over the body _make_kernel) in its
// banded mode, score class (banded=True, bandwidth; kernel K1e; :1307,
// masks at :602-617, :722-725, :890-891), for bands the ring reaches
// (score_cell.cuh, band_plan: 2 bw < (G - 1) kR + G + 1, bw up to 140 at
// G = 32, kR = 8; a band wider than the padded pair counts as the pair).
// Same outputs as the band-only sweep of score_pair<OUT_SCORE, true> (the
// g++-tested recurrence) and the plain version, bit for bit: score,
// end_query, end_ref and the width-8/16 saturation flags, NW, the nine SG
// free-end sets and SW, with an (A, A) table plus query letters or (1 or
// B, Qp, A) profile rows.  Wider bands take the masked full sweep (the
// short form, scan_short_banded.cu, or the block kernel,
// scan_chunked_banded.cu).
//
// Design (score_cell.cuh, "the banded warp form"): a pair's G lanes hold
// its row blocks of kR rows in a ring, block k on lane k mod G, which at
// step s computes column s - k of the block's rows on DPX max-plus (cell),
// H, E and F in registers; one shuffle a step (two words) brings block
// k - 1's bottom row from the ring's predecessor.  A block sweeps only its
// band's columns, [k kR - bw, k kR + kR - 1 + bw] clipped to the pair, and
// masks the cells of those columns outside the band; its last kR columns
// take NEG_INF32 from above themselves (band_lane_iter), since by then the
// predecessor may hold its next block.  Each lane fetches its next
// column's letter and scores a step ahead.  The end cell is folded per
// lane across its blocks and across the group by shuffles (seg_merge);
// lane 0 of the group writes the outputs.  A pair takes about Rp + Qp /
// kR steps, against the qlen x (2 bw + 1) dependent cells of a one-thread
// band-only sweep.
//
// Staging: the block stages the table form's (A + 1)^2 scores (a zero row
// and column for letters outside the alphabet; the rule leaves tables
// past 32 KB to the masked full sweep) and each pair's reference letters
// when the block's letters fit 48 KB (cfg2's 16 pairs of 192 a block and
// the long batch's one pair of 4,096 do); letters that do not fit, and
// every profile (up to Qp x A words a pair), are read through L1.  The
// query letters of a lane's next block are loaded when its current block
// starts, a block ahead of their use.  A block is one to four warps: as
// many as leave no SM without a warp (the long batch's 128 pairs of 32
// lanes run a warp a block on 128 SMs).
//
// What bounds it on this card: the step's dependent chain (kR cells, a
// shuffle) times Rp + Qp / kR steps, when the batch is small; the lanes'
// issue rate when it is large, where a lane is busy (2 bw + kR) of every
// G (kR + 1) steps, so the rule (band_plan) takes the fewest lanes that
// reach the band once the card is full, and the fewest rows a step
// otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_cell.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kMaxThreads = 128;
constexpr int64_t kSmemBytes = 48 * 1024;   // no opt-in needed

struct BandArgs {
  const int32_t* subs;   // (A, A) table or (Bq, Qp, A) rows
  const int32_t* qidx;   // (Bq, Qp) letters; null: profile
  const int32_t* ridx;   // (B, Rp)
  const int32_t* qlen;   // (B,)
  const int32_t* rlen;   // (B,)
  int32_t* out;          // (5, B)
  int32_t B, Bq, Qp, Rp, A, open, ext, mode, free_bits, bw;
  int32_t letters_smem;  // each pair's letters staged
};

template <int32_t G, int32_t kR, bool kProfile>
__global__ void __launch_bounds__(kMaxThreads) band_kernel(const BandArgs a) {
  extern __shared__ int32_t smem[];
  const int32_t pairs = blockDim.x / G;
  const int32_t gl = threadIdx.x & (G - 1);
  const int32_t pb = threadIdx.x / G;
  const int32_t b = blockIdx.x * pairs + pb;
  const bool valid = b < a.B;
  const int32_t A = a.A;
  const int32_t table = kProfile ? 0 : (A + 1) * (A + 1);
  int32_t* letters_s = smem + table;
  for (int32_t k = threadIdx.x; k < table; k += blockDim.x)
    smem[k] = ptscore::seg_table_at(a.subs, A, k);
  const int32_t* rb = a.ridx + (int64_t)(valid ? b : 0) * a.Rp;
  const int32_t rl = valid ? ptscore::imin(a.rlen[b], a.Rp) : 0;
  if (a.letters_smem)
    for (int32_t k = gl; k < rl; k += G)
      letters_s[(int64_t)pb * a.Rp + k] = rb[k];
  __syncthreads();

  const int64_t bq = a.Bq == 1 ? 0 : b;
  const ptscore::BandScores<kProfile> sc{
      kProfile ? a.subs + bq * a.Qp * A : smem, A};
  const int32_t* q = kProfile ? nullptr : a.qidx + bq * a.Qp;
  const int32_t* letters =
      a.letters_smem ? letters_s + (int64_t)pb * a.Rp : rb;
  const ptscore::BandPair bp =
      valid ? ptscore::band_pair(a.qlen[b], rl, a.Qp, a.Rp, a.open, a.ext,
                                 a.mode, a.free_bits, A, a.bw, kR)
            : ptscore::band_pair(0, 0, a.Qp, a.Rp, a.open, a.ext, a.mode,
                                 a.free_bits, A, -1, kR);
  ptscore::BandLane<kR> L;
  ptscore::band_lane_start(L, bp, gl, G, q, sc);
  // the warp runs to its longest pair; a lane past its pair's last block
  // only passes the shuffles on
  const int32_t steps = __reduce_max_sync(kFull, (unsigned)bp.steps);
  const int32_t lane = threadIdx.x & 31;
  const int32_t pred = (lane & ~(G - 1)) | ((gl + G - 1) & (G - 1));
  for (int32_t s = -1; s < steps; ++s) {
    const int32_t raw_h = __shfl_sync(kFull, L.out_h, pred);
    const int32_t raw_e = __shfl_sync(kFull, L.out_e, pred);
    ptscore::band_lane_iter(L, bp, G, s, raw_h, raw_e, q, letters, sc);
  }
  ptscore::SegBest best = L.best;
#pragma unroll
  for (int32_t m = G / 2; m > 0; m >>= 1) {
    ptscore::SegBest o;
    o.h = __shfl_xor_sync(kFull, best.h, m);
    o.i = __shfl_xor_sync(kFull, best.i, m);
    o.j = __shfl_xor_sync(kFull, best.j, m);
    o.hmax = __shfl_xor_sync(kFull, best.hmax, m);
    o.hmin = __shfl_xor_sync(kFull, best.hmin, m);
    best = ptscore::seg_merge(best, o);
  }
  if (valid && gl == 0) {
    const ptscore::PairResult r = ptscore::band_finish(bp, a.mode, best);
    a.out[b] = r.score;
    a.out[a.B + b] = r.end_query;
    a.out[2 * a.B + b] = r.end_ref;
    a.out[3 * a.B + b] = r.sat8;
    a.out[4 * a.B + b] = r.sat16;
  }
}

template <int32_t G, int32_t kR>
int launch_form(const BandArgs& a, cudaStream_t stream) {
  const bool profile = a.qidx == nullptr;
  // warps a block: the fewest (1 to 4) that put a warp on every SM
  const int64_t warps = ((int64_t)a.B * G + 31) / 32;
  const int32_t wb = (int32_t)ptscore::imin(
      kMaxThreads / 32,
      ptscore::imax(1, (int32_t)((warps + ptscore::SEG_SMS - 1) /
                                 ptscore::SEG_SMS)));
  const int32_t threads = 32 * wb, pairs = threads / G;
  BandArgs args = a;
  int64_t words = profile ? 0 : (int64_t)(a.A + 1) * (a.A + 1);
  args.letters_smem = (words + (int64_t)pairs * a.Rp) * 4 <= kSmemBytes;
  if (args.letters_smem) words += (int64_t)pairs * a.Rp;
  const int blocks = (int)ptscore::seg_div_up(a.B, pairs);
  const size_t bytes = (size_t)words * 4;
  if (profile)
    band_kernel<G, kR, true><<<blocks, threads, bytes, stream>>>(args);
  else
    band_kernel<G, kR, false><<<blocks, threads, bytes, stream>>>(args);
  return (int)cudaGetLastError();
}

template <int32_t G>
int launch_rows(const BandArgs& a, int32_t rows, cudaStream_t stream) {
  switch (rows) {
    case 4:
      return launch_form<G, 4>(a, stream);
    case 5:
      return launch_form<G, 5>(a, stream);
    case 6:
      return launch_form<G, 6>(a, stream);
    default:
      return launch_form<G, 8>(a, stream);
  }
}

}  // namespace

// Launches the banded warp form (K1e's score class) on `stream` and
// returns the launch's CUDA error as an int (0 = launched).  All pointers
// are device pointers:
//   subs, qidx: (A, A) table and (Bq, Qp) letters, or (Bq, Qp, A) profile
//               rows and null
//   ridx:       (B, Rp) letters; qlen, rlen: (B,)
//   out:        (5, B) score, end_query, end_ref, sat8, sat16
// `lanes` and `rows` pick the form (G 8, 16 or 32, kR 4, 5, 6 or 8); 0
// and 0 take the rule's (score_cell.cuh, band_plan).  A form that does
// not reach the band, a band no form reaches, or a table past
// BAND_TABLE_BYTES returns cudaErrorInvalidValue: the masked full sweep
// (pt_scan_short_banded, pt_scan_chunked_banded) serves those.
extern "C" int pt_scan_band_ring(const void* subs, const void* qidx,
                                 const void* ridx, const void* qlen,
                                 const void* rlen, void* out, int B, int Bq,
                                 int Qp, int Rp, int A, int open, int ext,
                                 int mode, int free_bits, int bandwidth,
                                 int lanes, int rows, void* stream) {
  const int bw = ptscore::band_eff(bandwidth, Qp, Rp);
  const bool profile = qidx == nullptr;
  if (lanes == 0 && rows == 0) {
    const ptscore::BandPlan plan =
        ptscore::band_plan(B, Qp, Rp, bandwidth, A, profile);
    lanes = plan.lanes;
    rows = plan.rows;
  }
  if (!ptscore::band_form(lanes, rows) ||
      2 * bw >= ptscore::band_reach(lanes, rows) ||
      (!profile && (int64_t)(A + 1) * (A + 1) * 4 > ptscore::BAND_TABLE_BYTES))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const BandArgs a{(const int32_t*)subs, (const int32_t*)qidx,
                   (const int32_t*)ridx, (const int32_t*)qlen,
                   (const int32_t*)rlen, (int32_t*)out, B, Bq, Qp, Rp, A,
                   open, ext, mode, free_bits, bw, 0};
  cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 8:
      return launch_rows<8>(a, rows, s);
    case 16:
      return launch_rows<16>(a, rows, s);
    default:
      return launch_rows<32>(a, rows, s);
  }
}

// The banded warp form's rule (score_cell.cuh, band_plan): lanes a pair
// and rows a block to plan[0..1], 0 and 0 where the masked full sweep
// takes the batch (A letters, `profile` 1 for the profile form).
extern "C" int pt_band_plan(int B, int Qp, int Rp, int bandwidth, int A,
                            int profile, int* plan) {
  const ptscore::BandPlan p =
      ptscore::band_plan(B, Qp, Rp, bandwidth, A, profile != 0);
  plan[0] = p.lanes;
  plan[1] = p.rows;
  return 0;
}
