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
//
// The block kernel itself is in segment_block.cuh, which the tile form
// (scan_rowseg.cu, kernel K3) instantiates too.
#include "segment_block.cuh"

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
  ptsegblock::launch<k, false>(                                            \
      subs, qidx, mq, ridx, qlen, rlen, bottom, nullptr, st_h, st_f,       \
      st_pay, acc, out, trace, nullptr, nullptr, B, Bq, Bm, Qp, Rseg, A,   \
      open, ext, mode, free_bits, off, resume, warps, Qp, 0, stream)
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
