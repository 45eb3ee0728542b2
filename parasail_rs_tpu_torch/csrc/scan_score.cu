// The banded mode of the one-shot sweep for Hopper (sm_90a): one thread
// per pair.
//
// Replaces: parasail_rs_tpu/ops/scan_kernel.py::scan_score_align (the
// pallas_call at scan_kernel.py:1453 over the body _make_kernel) in its
// banded mode, every output class (banded=True, bandwidth; kernel K1e;
// :1307-1308, masks at :602-617, :722-725, :890-891): the score form
// sweeps only the band's cells, O(qlen * (2 bw + 1)) per pair, the other
// forms every cell, masked, the trace class's flags (:865-888) and the
// stats classes' payloads (:844-863) among them.  Every unbanded class is
// the short form's (scan_short.cu, one warp a pair) or, for long queries,
// the block kernel's.  Same outputs: score, end_query, end_ref and the
// width-8/16 saturation flags, bit for bit, for NW, the nine SG free-end
// sets and SW, with the substitution given as an (A, A) table plus query
// letters or as (1 or B, Qp, A) profile rows; the trace class adds each
// cell's int8 flags, the stats classes matches / similar / length along
// the winning path, the table classes every cell's H (and payload), the
// rowcol classes the last row's and the last column's.
//
// Design: one thread per pair (inter-task).  Each thread sweeps its own
// qlen x rlen cells row by row with the literal Gotoh recurrence of
// score_cell.cuh (score_pair), so per-pair loop bounds, the band's edges
// and the integer tie rules need no masking across threads and no
// cross-thread communication.  One row of H and E per pair lives in global
// scratch laid out [Rp][B], so the 32 threads of a warp, which sweep in
// step, touch 32 neighbouring words; the stats forms add six such rows
// (H's and E's matches / similar / length) and keep the diagonal's, the
// left cell's and F's payloads in registers.  The (A, A) table sits in
// shared memory; profile rows and reference letters are read from global
// memory and stay in L1 across a row.  The trace plane and the table
// planes are laid out [Qp][Rp][B], the last row [Rp][B] and the last
// column [Qp][B], for the same reason: a warp's 32 values of one cell are
// neighbours.  The wrapper hands them on as strided (B, Qp, Rp), (B, Rp)
// and (B, Qp) views, which the traceback walk reads in place.
//
// What bounds it on this card: with one thread per pair an 8,192-pair
// batch fills only about two warps per SM, so the sweep is bound by the
// latency of the dependent cell chain and of the scratch loads, not by
// bandwidth or by integer throughput.  The design's answer is to keep the
// chain short (one max-plus cell per step, the loads of the next cell
// independent of the current one).  The forms other than score sweep
// every cell and mask (one compare and three selects a cell), so they
// cost what a full sweep costs, however narrow the band: a band-only
// sweep of the other classes, or the band on the short form's warps, is a
// later redesign.
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_cell.cuh"

namespace {

template <int32_t kOut>
__global__ void scan_kernel(
    const int32_t* __restrict__ subs,  // (A, A) table or (Bq, Qp, A) rows
    const int32_t* __restrict__ qidx,  // (Bq, Qp) letters; null: profile form
    const int32_t* __restrict__ ridx,  // (B, Rp)
    const int32_t* __restrict__ qlen,  // (B,)
    const int32_t* __restrict__ rlen,  // (B,)
    int32_t* __restrict__ hrow,        // (Rp, B) scratch
    int32_t* __restrict__ erow,        // (Rp, B) scratch
    int32_t* __restrict__ out,         // (5 or 8, B): score, eq, er, sat8,
                                       // sat16 (, matches, similar, length)
    int8_t* __restrict__ trace,        // OUT_TRACE: (Qp, Rp, B) flags
    int32_t B, int32_t Bq, int32_t Qp, int32_t Rp, int32_t A, int32_t open,
    int32_t ext, int32_t mode, int32_t free_bits, int32_t table_in_smem,
    ptscore::PlaneIO io,               // the batch's rows and planes
    int32_t Bm,                        // stats: io.mq is (Bm, Qp)
    int32_t bw) {                      // the band's half-width
  using O = ptscore::Out<kOut>;
  extern __shared__ int32_t smem[];
  const int32_t* table = subs;
  if (table_in_smem) {
    for (int32_t k = threadIdx.x; k < A * A; k += blockDim.x) smem[k] = subs[k];
    __syncthreads();
    table = smem;
  }
  const int32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ptscore::PlaneIO p;                  // pair b's view of io
  if constexpr (O::stats) {
    p.mq = io.mq + (Bm == 1 ? 0 : (int64_t)b * Qp);
    p.pay = io.pay + b;
    p.pay_plane = io.pay_plane;
  }
  if constexpr (O::table) {
    p.table = io.table + b;
    p.tab_plane = io.tab_plane;
  }
  if constexpr (O::rowcol) {
    p.row = io.row + b;
    p.row_plane = io.row_plane;
    p.col = io.col + b;
    p.col_plane = io.col_plane;
  }
  const ptscore::PairResult r = ptscore::score_batch_pair<kOut, true>(
      b, subs, table, qidx, ridx, qlen, rlen, hrow + b, erow + b,
      (int64_t)B, Bq, Qp, Rp, A, open, ext, mode, free_bits,
      O::trace ? trace + b : nullptr, (int64_t)Rp * B, (int64_t)B, p, bw);
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

constexpr int kThreads = 64;
constexpr size_t kStaticSmemLimit = 48 * 1024;

template <int32_t kOut>
int launch(const void* subs, const void* qidx, const void* ridx,
           const void* qlen, const void* rlen, void* hrow, void* erow,
           void* out, void* trace, int B, int Bq, int Qp, int Rp, int A,
           int open, int ext, int mode, int free_bits, void* stream,
           const ptscore::PlaneIO& io, int Bm, int bw) {
  if (B <= 0) return 0;
  size_t smem = 0;
  int in_smem = 0;
  if (qidx != nullptr && (size_t)A * A * sizeof(int32_t) <= kStaticSmemLimit) {
    smem = (size_t)A * A * sizeof(int32_t);
    in_smem = 1;
  }
  const int blocks = (B + kThreads - 1) / kThreads;
  scan_kernel<kOut>
      <<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
          (const int32_t*)subs, (const int32_t*)qidx, (const int32_t*)ridx,
          (const int32_t*)qlen, (const int32_t*)rlen, (int32_t*)hrow,
          (int32_t*)erow, (int32_t*)out, (int8_t*)trace, B, Bq, Qp, Rp, A,
          open, ext, mode, free_bits, in_smem, io, Bm, bw);
  return (int)cudaGetLastError();
}

// The batch's rows and planes for the stats, table and rowcol forms, over
// the (2 or 8, Rp, B) scratch, the (1 or 4, Qp, Rp, B) planes and the
// (1 or 4, Rp, B) / (1 or 4, Qp, B) last rows and columns.
ptscore::PlaneIO plane_io(const void* mq, int32_t* scratch, void* planes,
                          void* row, void* col, int B, int Qp, int Rp) {
  const int64_t rows = (int64_t)Rp * B;
  ptscore::PlaneIO io;
  io.mq = (const int32_t*)mq;
  io.pay = scratch + 2 * rows;
  io.pay_plane = rows;
  io.table = (int32_t*)planes;
  io.tab_plane = (int64_t)Qp * rows;
  io.row = (int32_t*)row;
  io.row_plane = rows;
  io.col = (int32_t*)col;
  io.col_plane = (int64_t)Qp * B;
  return io;
}

}  // namespace

// The banded forms of every class (K1e; out_class 0-6, ptscore::OutClass),
// launched on `stream`; returns cudaGetLastError() as an int (0 =
// launched).  All pointers are device pointers; `qidx` is null for the
// profile form.
//   mq:      stats classes: (Bm, Qp) query letters for `matches` (the
//            profile form has no other letters)
//   scratch: (2, Rp, B) rows H and E, or (8, Rp, B) with the payload rows
//   out:     (5, B), or (8, B) with matches, similar, length
//   trace:   trace class: (Qp, Rp, B) int8 flags
//   planes:  table classes: (1 or 4, Qp, Rp, B) score (, matches, similar,
//            length) of every in-sequence cell
//   row/col: rowcol classes: (1 or 4, Rp, B) last row, (1 or 4, Qp, B)
//            last column
// The caller zero-fills the planes, rows and columns.  Cells with
// |i - j| > bandwidth, and border cells beyond it, are -2^30.  The score
// form sweeps only the band's cells; the others sweep every cell of a
// pair and set H, E and F outside the band to -2^30 after taking the
// cell's flags and payloads, so every output equals the plain version's.
// NW, the SG free-end sets and SW.  An unknown class returns
// cudaErrorInvalidValue.
extern "C" int pt_scan_banded(int out_class, const void* subs,
                              const void* qidx, const void* mq,
                              const void* ridx, const void* qlen,
                              const void* rlen, void* scratch, void* out,
                              void* trace, void* planes, void* row,
                              void* col, int B, int Bq, int Bm, int Qp,
                              int Rp, int A, int open, int ext, int mode,
                              int free_bits, int bandwidth, void* stream) {
  const int64_t rows = (int64_t)Rp * B;
  int32_t* sc = (int32_t*)scratch;
  const ptscore::PlaneIO io = plane_io(mq, sc, planes, row, col, B, Qp, Rp);
  const int bw = ptscore::clamp_band(bandwidth, Qp, Rp);
#define PT_LAUNCH(k)                                                        \
  launch<k>(subs, qidx, ridx, qlen, rlen, sc, sc + rows, out, trace, B, Bq, \
            Qp, Rp, A, open, ext, mode, free_bits, stream, io, Bm, bw)
  switch (out_class) {
    case ptscore::OUT_SCORE:
      return PT_LAUNCH(ptscore::OUT_SCORE);
    case ptscore::OUT_TRACE:
      return PT_LAUNCH(ptscore::OUT_TRACE);
    case ptscore::OUT_STATS:
      return PT_LAUNCH(ptscore::OUT_STATS);
    case ptscore::OUT_TABLE:
      return PT_LAUNCH(ptscore::OUT_TABLE);
    case ptscore::OUT_STATS_TABLE:
      return PT_LAUNCH(ptscore::OUT_STATS_TABLE);
    case ptscore::OUT_ROWCOL:
      return PT_LAUNCH(ptscore::OUT_ROWCOL);
    case ptscore::OUT_STATS_ROWCOL:
      return PT_LAUNCH(ptscore::OUT_STATS_ROWCOL);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PT_LAUNCH
}
