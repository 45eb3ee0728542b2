// Tile kernel for Hopper (sm_90a): one row chunk by one column shard of a
// sequence-parallel fill, a chain of warps per pair.
//
// Replaces: parasail_rs_tpu/ops/scan_kernel.py::scan_rowseg_step (the
// pallas_call at scan_kernel.py:1877 over the body _make_kernel with
// rowseg=True), in its score, stats and trace classes.  One call sweeps
// query rows [r0, r0 + qc) by reference columns [off, off + C) of every
// pair of a batch.  State flows two ways.  Rightward, to the tile of the
// next column shard: H and F of the tile's rows at the pair's last column
// here (with the stats class, their payloads), and the corner words `t`.
// Downward, to the tile of the next row chunk on the same shard: H and E
// of the tile's last row per column (and their payloads).  The
// accumulator (best cell, extremes of H, the best's payload) stays with
// the shard and folds over its tiles; the caller merges the shards'.  The
// trace class writes the tile's flags, (B, qc, C) int8.  See
// score_cell.cuh, "the tile form", for what each buffer holds.
//
// Design: this is the segment kernel's block (segment_block.cuh; design
// notes in scan_segment.cu) instantiated with kTile, not a second sweep.
// The segment form already carried the right-going state in and out and
// passed a group's last row to the next group through a per-pair row of C
// columns in global memory; the down-state is a second such row, read
// above the tile's first row and left holding its last row (written by
// whichever lane holds row r0 + qc - 1 among its kR rows: qc need be no
// multiple of 32 kR; a pair that ends above that row keeps what it was
// given, so the scratch between the groups stays a buffer of its own).
// The two closed-form borders of the segment form become reads: the caller fills the state with the bordered left column
// at off == 0 and the down-state with the top border at r0 == 0, so the
// kernel has one path for every tile.  The corner H[r0-1][off-1] arrives
// as four words; a tile hands its right neighbour the down-state it was
// given at its last column, which thread 0 of the pair's first block
// reads before any lane of the pair's blocks writes there.  The TPU kernel's 128-lane layout, VMEM tile plan and prefix scan
// have no counterpart: E follows the literal recurrence, so the down-state
// carries E where the TPU kernel carries a prefix-max seed.  It lives in
// its own source so that nvcc builds it beside scan_segment.cu.
//
// What bounds it on this card: as the segment kernel (kR rows a lane on
// DPX max-plus, the launcher's rule in score_cell.cuh's seg_plan), the
// latency of a step's dependent chain at the warps 128 pairs give each
// SM; a tile of few rows also pays the chain's fill (64 steps a warp a
// group) against its C columns, and each tile is a launch.  The tiles of
// one superstep are independent and could share one launch.
#include "segment_block.cuh"

// Launches the tile kernel on `stream` and returns the launch's CUDA
// error as an int (0 = launched).  All pointers are device pointers.
//   out_class: 0 score, 1 trace, 2 stats; any other returns
//              cudaErrorInvalidValue
//   subs/qidx/mq: as pt_scan_segment, over the WHOLE padded query (Qp)
//   ridx:      (B, C) letters of columns [off, off + C)
//   qlen/rlen: the pairs' whole lengths
//   bottom:    scratch of down's shape
//   down:      (B, 2, C), or (B, 8, C) for stats: in, H and E (and their
//              payloads) of row r0 - 1; out, of row r0 + qc - 1 where the
//              pair has that row and the column
//   st_h/st_f: (B, qc) right-going state of rows [r0, r0 + qc), in place
//   st_pay:    stats: (6, B, qc)
//   acc:       (B, 8) the shard's accumulator, in place
//   out:       (5, B), or (8, B) for stats: read off `acc`
//   trace:     trace: (B, qc, C) int8, zero-filled by the caller
//   t_in/t_out: (B, 4) corner words in, and for the right neighbour
//   warps, rows, cluster: as pt_scan_segment
extern "C" int pt_scan_rowseg(int out_class, const void* subs,
                              const void* qidx, const void* mq,
                              const void* ridx, const void* qlen,
                              const void* rlen, void* bottom, void* down,
                              void* st_h,
                              void* st_f, void* st_pay, void* acc, void* out,
                              void* trace, const void* t_in, void* t_out,
                              int B, int Bq, int Bm, int Qp, int C, int A,
                              int open, int ext, int mode, int free_bits,
                              int off, int r0, int qc, int warps, int rows,
                              int cluster, void* stream) {
  const ptsegblock::SegArgs a{
      (const int32_t*)subs, (const int32_t*)qidx, (const int32_t*)mq,
      (const int32_t*)ridx, (const int32_t*)qlen, (const int32_t*)rlen,
      (int32_t*)bottom, (int32_t*)down, (int32_t*)st_h, (int32_t*)st_f,
      (int32_t*)st_pay, (int32_t*)acc, (int32_t*)out, (int8_t*)trace,
      (const int32_t*)t_in, (int32_t*)t_out, nullptr, nullptr, nullptr, B,
      Bq, Bm, Qp, C, A, open, ext, mode, free_bits, off, 1, qc, r0, 1};
  switch (out_class) {
    case ptscore::OUT_SCORE:
      return ptsegblock::launch<ptscore::OUT_SCORE, true>(a, warps, rows,
                                                          cluster, stream);
    case ptscore::OUT_TRACE:
      return ptsegblock::launch<ptscore::OUT_TRACE, true>(a, warps, rows,
                                                          cluster, stream);
    case ptscore::OUT_STATS:
      return ptsegblock::launch<ptscore::OUT_STATS, true>(a, warps, rows,
                                                          cluster, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
