// Resumable segment kernel for Hopper (sm_90a): long pairs, a chain of warps each.
//
// Replaces: parasail_rs_tpu/ops/scan_kernel.py::scan_score_segment (the
// pallas_call at scan_kernel.py:1672 over the body _make_kernel with
// stream=True), in its score, stats and trace classes.  One call sweeps
// columns [col_offset, col_offset + Rseg) of every pair of a padded batch
// and carries the sweep's state in and out: H and F of every query row at
// the pair's last column so far, the stats payloads of both, and the
// accumulator (best cell, extremes of H, the best cell's payload); see
// score_cell.cuh, "the segment form".  After the last segment the outputs
// are the one-shot sweep's (scan_short.cuh) for the same class, bit for
// bit; the trace class writes the segment's flags, (B, Qp, Rseg) int8.
//
// Design: a chain of warps per pair, kR query rows a lane (2, 4 or 8;
// the trace and stats classes 2 or 4).  What bounds the one-shot kernel on long pairs
// is the dependent chain of its one thread per pair (a cell's H needs the
// cell to its left), about 225 ns a cell, while a batch of 128 long pairs
// leaves all but two SMs idle.  Here the lanes of a warp take a stripe of
// 32 kR query rows and sweep the segment's columns skewed by one: at step
// t lane l computes column t - l of its kR rows top to bottom, E running
// down them in registers, so one __shfl_up_sync of the bottom row's H and
// E (with the stats class, their six payloads too) serves kR cells, the
// diagonal is what arrived one step earlier, and each row's H to the left
// and F stay in registers.  The cells are DPX max-plus (__viaddmax_s32 for
// E and F, __vimax3_s32 for H, __vimax3_s32_relu for SW's clamp); the
// flags and payloads keep golden's >= comparisons.  The warps of a block,
// or of a thread-block cluster of up to eight blocks when the launch
// holds few pairs, take consecutive stripes of one group of rows: warp w
// runs 64 steps behind warp w - 1 and reads that warp's last row from a
// ring of 128 columns in its shared memory (across blocks, written
// through distributed shared memory).  The pair's blocks meet at a
// barrier every 32 steps, and the lag puts one barrier between a column's
// write and its read and another before its slot is reused.  The group's
// last row goes to a per-pair scratch row of Rseg columns in global
// memory, which the first warp of the next group reads; lane 0 fetches
// what it reads one step ahead of its use, and every lane its next letter
// from a ring of letters that warp 0 stages by cp.async a round ahead.
// Each lane writes its rows' H and F at the pair's last column into the
// state, in place: a lane reads only its own rows' state, and the
// diagonal of the row below travels by shuffle (between warps, through
// shared memory) before anything is written.  Each lane keeps the first
// maximum of its own rows in the end cell's order; warps and blocks
// reduce by it, and thread 0 of the pair's first block folds the result
// into the carried accumulator.  The (A, A) table sits in shared memory
// (any size the card's 227 KB hold), the profile form's rows of a group
// too.
//
// The launcher's rule (score_cell.cuh, seg_plan) picks kR, the warps a
// block and the blocks a pair: the largest kR whose eight warps (else
// whose one warp; for the table classes, whose H is a 16-byte store at 4
// rows, one warp at once) the pair's rows fill, at most 4 for the trace,
// table and stats forms; the warps that cover the rows, up to 8; and,
// when the launch leaves SMs idle, the blocks a pair that use them, up
// to 8.
//
// What bounds it on this card: still the latency of the step's dependent
// chain (the shuffle, then E and H down the kR rows) at the few warps a
// batch of 128 pairs gives each SM, and the fill of the chain (64 steps a
// warp a group) against the columns.  Its time beside the bound is in
// PERF.md.
//
// The block kernel itself is in segment_block.cuh, which the tile form
// (scan_rowseg.cu, kernel K3) and the chunked form (scan_chunked.cu,
// kernel K1f) instantiate too.
#include "segment_block.cuh"

// Launches the segment kernel on `stream` and returns the launch's CUDA
// error as an int (0 = launched).  All pointers are device pointers.
//   out_class: 0 score, 1 trace, 2 stats (ptscore::OutClass); any other
//              returns cudaErrorInvalidValue
//   subs/qidx: as pt_scan_short (qidx null: the profile form)
//   mq:        stats: (Bm, Qp) query letters for `matches`
//   ridx:      (B, Rseg) letters of columns [off, off + Rseg)
//   rlen:      the pairs' whole reference lengths
//   bottom:    scratch, (B, 2, Rseg), or (B, 8, Rseg) for stats
//   st_h/st_f: (B, Qp) state, read (if resume) and written in place
//   st_pay:    stats: (6, B, Qp) state payloads
//   acc:       (B, 8) accumulator, read (if resume) and written in place
//   out:       (5, B), or (8, B) for stats
//   trace:     trace: (B, Qp, Rseg) int8, zero-filled by the caller
//   warps, rows, cluster: warps a block (1 to 8), rows a lane (2, 4; 8
//              for score)
//              and blocks a pair (1 to 8); 0 leaves each to seg_plan
extern "C" int pt_scan_segment(int out_class, const void* subs,
                               const void* qidx, const void* mq,
                               const void* ridx, const void* qlen,
                               const void* rlen, void* bottom, void* st_h,
                               void* st_f, void* st_pay, void* acc, void* out,
                               void* trace, int B, int Bq, int Bm, int Qp,
                               int Rseg, int A, int open, int ext, int mode,
                               int free_bits, int off, int resume, int warps,
                               int rows, int cluster, void* stream) {
  const ptsegblock::SegArgs a{
      (const int32_t*)subs, (const int32_t*)qidx, (const int32_t*)mq,
      (const int32_t*)ridx, (const int32_t*)qlen, (const int32_t*)rlen,
      (int32_t*)bottom, nullptr, (int32_t*)st_h, (int32_t*)st_f,
      (int32_t*)st_pay, (int32_t*)acc, (int32_t*)out, (int8_t*)trace,
      nullptr, nullptr, nullptr, nullptr, nullptr, B, Bq, Bm, Qp, Rseg, A,
      open, ext, mode, free_bits, off, resume, Qp, 0, 1};
  switch (out_class) {
    case ptscore::OUT_SCORE:
      return ptsegblock::launch<ptscore::OUT_SCORE, false>(a, warps, rows,
                                                           cluster, stream);
    case ptscore::OUT_TRACE:
      return ptsegblock::launch<ptscore::OUT_TRACE, false>(a, warps, rows,
                                                           cluster, stream);
    case ptscore::OUT_STATS:
      return ptsegblock::launch<ptscore::OUT_STATS, false>(a, warps, rows,
                                                           cluster, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The plan the block kernel takes for a launch of class `out_class` on B
// pairs of Qs rows by ncols columns (score_cell.cuh, seg_plan): writes
// rows a lane, warps a block and blocks a pair to plan[0..2].  Returns 0.
extern "C" int pt_block_plan(int out_class, int B, int Qs, int ncols, int A,
                             int profile, int warps, int rows, int cluster,
                             int* plan) {
  const ptscore::SegPlan p = ptscore::seg_plan(
      out_class, B, Qs, ncols, A, profile != 0, warps, rows, cluster);
  plan[0] = p.rows;
  plan[1] = p.warps;
  plan[2] = p.cluster;
  return 0;
}
