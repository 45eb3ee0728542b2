// The banded mode's masked full sweep of long pairs for Hopper (sm_90a):
// the block kernel (segment_block.cuh) once over all of a pair's columns,
// masked to a band, in every output class.
//
// Replaces: parasail_rs_tpu/ops/scan_kernel.py::scan_score_align (the
// pallas_call at scan_kernel.py:1453) with banded=True (:1307-1308, masks
// :602-617; the row-chunked K1f body at :477 past the reference's chunk
// point) where the short form (scan_short_banded.cu) does not take the
// batch: past 256 padded query rows, or letters a block cannot stage.  It
// serves the score class there too where the ring (scan_banded.cu) does
// not reach the band (bw past 140 on long pairs, or tables past 32 KB).
// Same outputs as score_pair<kOut, true> and the plain version (the
// wavefront with banded=True), every cell inside and outside the band.
//
// Design: the one-shot block kernel of scan_chunked.cu / scan_segment.cu
// (a chain of warps a pair, kR rows a lane, a cluster of blocks on small
// batches; the launcher's rule seg_plan) with kBanded: each cell's flags
// or payloads come from its masked neighbours, then H, E and F become
// NEG_INF32 where |i - j| > bw, before the planes, the rings, the group's
// scratch row, the extremes and the candidate test see them; the borders
// are band_border's, from column 0 (seg_top, seg_lane_begin, seg_corner),
// and a pair with an empty side takes empty_side<true>.  Every class is
// one launch from column 0: the score, stats and trace classes as one
// segment of Rp columns (the trace buffer is then the whole (B, Qp, Rp)
// plane), the plane classes with their tables, rows and columns.
//
// What bounds it on this card: the unbanded block kernel's step latency
// and the chain's fill, over every cell of the pair however narrow the
// band, plus a compare and three selects a cell.
#include "segment_block.cuh"

// Launches the masked one-shot block kernel of class `out_class` (0-6,
// ptscore::OutClass) on `stream` and returns the launch's CUDA error as
// an int (0 = launched).  All pointers are device pointers; the
// arguments are pt_scan_segment's and pt_scan_chunked's:
//   bottom:    scratch, (B, 2, Rp), or (B, 8, Rp) for the stats classes
//   st_h/st_f: scratch, (B, Qp); st_pay: stats classes, (6, B, Qp)
//   acc:       scratch, (B, 8)
//   out:       (5, B), or (8, B) for the stats classes
//   trace:     trace: (B, Qp, Rp) int8, zero-filled
//   tab:       table classes: (1 or 4, B, Rp, Qp), zero-filled
//   rows/cols: rowcol classes: (1 or 4, B, Rp) and (1 or 4, B, Qp),
//              zero-filled
//   bandwidth: the band's half-width, clamped to [-1, Qp + Rp]
//   warps, lane_rows, cluster: as pt_scan_segment's warps, rows, cluster
extern "C" int pt_scan_chunked_banded(
    int out_class, const void* subs, const void* qidx, const void* mq,
    const void* ridx, const void* qlen, const void* rlen, void* bottom,
    void* st_h, void* st_f, void* st_pay, void* acc, void* out, void* trace,
    void* tab, void* rows, void* cols, int B, int Bq, int Bm, int Qp, int Rp,
    int A, int open, int ext, int mode, int free_bits, int bandwidth,
    int warps, int lane_rows, int cluster, void* stream) {
  const ptsegblock::SegArgs a{
      (const int32_t*)subs, (const int32_t*)qidx, (const int32_t*)mq,
      (const int32_t*)ridx, (const int32_t*)qlen, (const int32_t*)rlen,
      (int32_t*)bottom, nullptr, (int32_t*)st_h, (int32_t*)st_f,
      (int32_t*)st_pay, (int32_t*)acc, (int32_t*)out, (int8_t*)trace,
      nullptr, nullptr, (int32_t*)tab, (int32_t*)rows, (int32_t*)cols, B,
      Bq, Bm, Qp, Rp, A, open, ext, mode, free_bits, 0, 0, Qp, 0, 1,
      ptscore::clamp_band(bandwidth, Qp, Rp)};
#define PT_BANDED(k) \
  ptsegblock::launch<k, false, true>(a, warps, lane_rows, cluster, stream)
  switch (out_class) {
    case ptscore::OUT_SCORE:
      return PT_BANDED(ptscore::OUT_SCORE);
    case ptscore::OUT_TRACE:
      return PT_BANDED(ptscore::OUT_TRACE);
    case ptscore::OUT_STATS:
      return PT_BANDED(ptscore::OUT_STATS);
    case ptscore::OUT_TABLE:
      return PT_BANDED(ptscore::OUT_TABLE);
    case ptscore::OUT_STATS_TABLE:
      return PT_BANDED(ptscore::OUT_STATS_TABLE);
    case ptscore::OUT_ROWCOL:
      return PT_BANDED(ptscore::OUT_ROWCOL);
    case ptscore::OUT_STATS_ROWCOL:
      return PT_BANDED(ptscore::OUT_STATS_ROWCOL);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PT_BANDED
}
