// Batched alignment kernel for Hopper (sm_90a), score and trace classes.
//
// Replaces: parasail_rs_tpu/ops/scan_kernel.py::scan_score_align in its
// score class (outputs="score") and its trace class (outputs="trace"; the
// pallas_call at scan_kernel.py:1453 over the body _make_kernel, flags at
// :865-888).  Same outputs: score, end_query, end_ref and the width-8/16
// saturation flags, bit for bit, for NW, the nine SG free-end sets and
// SW, with the substitution given as an (A, A) table plus query letters
// or as (1 or B, Qp, A) profile rows; the trace class adds each cell's
// int8 flags.
//
// Design: one thread per pair (inter-task).  Each thread sweeps its own
// qlen x rlen cells row by row with the literal Gotoh recurrence of
// score_cell.cuh, so per-pair loop bounds and the integer tie rules need
// no masking and no cross-thread communication.  One row of H and E per
// pair lives in global scratch laid out [Rp][B], so the 32 threads of a
// warp, which sweep in step, touch 32 neighbouring words.  The (A, A)
// table sits in shared memory; profile rows and reference letters are
// read from global memory and stay in L1 across a row.  The trace plane
// is laid out [Qp][Rp][B] for the same reason: a warp's 32 flag bytes of
// one cell land in one 32-byte sector.  The wrapper hands it on as a
// (B, Qp, Rp) strided view, which the traceback walk reads in place.
//
// What bounds it on this card: with one thread per pair an 8,192-pair
// batch fills only about two warps per SM, so the sweep is bound by the
// latency of the dependent cell chain and of the scratch loads, not by
// bandwidth or by integer throughput (the 2 x 4 bytes of scratch traffic
// per cell stay in the 50 MB L2 at that size; the trace class adds one
// byte per cell, written and never read back by the sweep).  The design's
// answer is to keep the chain short (one max-plus cell per step, the
// loads of the next cell independent of the current one) and to leave
// intra-pair parallelism, DPX max-plus instructions and a fused
// byte-to-letter map to later versions.
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_cell.cuh"

namespace {

template <bool kTrace>
__global__ void scan_kernel(
    const int32_t* __restrict__ subs,  // (A, A) table or (Bq, Qp, A) rows
    const int32_t* __restrict__ qidx,  // (Bq, Qp) letters; null: profile form
    const int32_t* __restrict__ ridx,  // (B, Rp)
    const int32_t* __restrict__ qlen,  // (B,)
    const int32_t* __restrict__ rlen,  // (B,)
    int32_t* __restrict__ hrow,        // (Rp, B) scratch
    int32_t* __restrict__ erow,        // (Rp, B) scratch
    int32_t* __restrict__ out,         // (5, B): score, eq, er, sat8, sat16
    int8_t* __restrict__ trace,        // kTrace: (Qp, Rp, B) flags
    int32_t B, int32_t Bq, int32_t Qp, int32_t Rp, int32_t A, int32_t open,
    int32_t ext, int32_t mode, int32_t free_bits, int32_t table_in_smem) {
  extern __shared__ int32_t smem[];
  const int32_t* table = subs;
  if (table_in_smem) {
    for (int32_t k = threadIdx.x; k < A * A; k += blockDim.x) smem[k] = subs[k];
    __syncthreads();
    table = smem;
  }
  const int32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const ptscore::PairResult r = ptscore::score_batch_pair<kTrace>(
      b, subs, table, qidx, ridx, qlen, rlen, hrow + b, erow + b,
      (int64_t)B, Bq, Qp, Rp, A, open, ext, mode, free_bits,
      kTrace ? trace + b : nullptr, (int64_t)Rp * B, (int64_t)B);
  out[b] = r.score;
  out[B + b] = r.end_query;
  out[2 * B + b] = r.end_ref;
  out[3 * B + b] = r.sat8;
  out[4 * B + b] = r.sat16;
}

constexpr int kThreads = 64;
constexpr size_t kStaticSmemLimit = 48 * 1024;

template <bool kTrace>
int launch(const void* subs, const void* qidx, const void* ridx,
           const void* qlen, const void* rlen, void* hrow, void* erow,
           void* out, void* trace, int B, int Bq, int Qp, int Rp, int A,
           int open, int ext, int mode, int free_bits, void* stream) {
  if (B <= 0) return 0;
  size_t smem = 0;
  int in_smem = 0;
  if (qidx != nullptr && (size_t)A * A * sizeof(int32_t) <= kStaticSmemLimit) {
    smem = (size_t)A * A * sizeof(int32_t);
    in_smem = 1;
  }
  const int blocks = (B + kThreads - 1) / kThreads;
  scan_kernel<kTrace><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)subs, (const int32_t*)qidx, (const int32_t*)ridx,
      (const int32_t*)qlen, (const int32_t*)rlen, (int32_t*)hrow,
      (int32_t*)erow, (int32_t*)out, (int8_t*)trace, B, Bq, Qp, Rp, A, open,
      ext, mode, free_bits, in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the score kernel on `stream` and returns cudaGetLastError()
// as an int (0 = launched).  All pointers are device pointers; `qidx` is
// null for the profile form.
extern "C" int pt_scan_score(const void* subs, const void* qidx,
                             const void* ridx, const void* qlen,
                             const void* rlen, void* hrow, void* erow,
                             void* out, int B, int Bq, int Qp, int Rp, int A,
                             int open, int ext, int mode, int free_bits,
                             void* stream) {
  return launch<false>(subs, qidx, ridx, qlen, rlen, hrow, erow, out,
                       nullptr, B, Bq, Qp, Rp, A, open, ext, mode, free_bits,
                       stream);
}

// pt_scan_score plus the (Qp, Rp, B) int8 flag plane `trace`, of which
// it writes the in-sequence cells (the caller zero-fills it).
extern "C" int pt_scan_trace(const void* subs, const void* qidx,
                             const void* ridx, const void* qlen,
                             const void* rlen, void* hrow, void* erow,
                             void* out, void* trace, int B, int Bq, int Qp,
                             int Rp, int A, int open, int ext, int mode,
                             int free_bits, void* stream) {
  return launch<true>(subs, qidx, ridx, qlen, rlen, hrow, erow, out, trace,
                      B, Bq, Qp, Rp, A, open, ext, mode, free_bits, stream);
}
