// The one-launch sweep of long pairs for Hopper (sm_90a): a chain of warps
// per pair over all of its reference columns, the forms of the four plane
// classes.
//
// Replaces: parasail_rs_tpu/ops/scan_kernel.py::scan_score_align with the
// query in row chunks (nq > 1: `chunked = nq > 1` in _make_kernel at
// scan_kernel.py:477, the pallas_call at :1453), in all seven output
// classes.  The TPU kernel holds the query in chunks of Qc rows because a
// VMEM tile holds no more, and carries a down-state per column from one
// chunk to the next (dH and the prefix-max seed; dE for the trace class;
// the H and prefix-max payloads for the stats classes, scan_kernel.py:920-
// 952).  One call sweeps columns [0, Rp) of every pair of a padded batch
// and returns what the short form (scan_short.cuh) returns for the class,
// bit for bit: the per-pair scalars, and the trace plane, the H (and
// payload) planes, or the last row and column.
//
// Design: this is the segment kernel's block (segment_block.cuh; design
// notes in scan_segment.cu) run as ONE segment of Rp columns, so it is not
// a second sweep.  A pair's chain of warps sweeps stripes of 32 kR query
// rows, and a group of rows hands its last row to the next group through
// a per-pair scratch row of Rp columns: that row is the counterpart of
// the TPU kernel's down-state, with E in place of the prefix-max seed.
// What the one-shot classes add to the segment form are writes, not
// state:
//
//   - table / stats_table: each lane writes its rows' H (and H's payload
//     m, s, l) at every column of the pair, into planes laid out (nplanes,
//     B, Rp, Qp), query-fastest, so that a lane's kR rows of H at one
//     column are 16-byte vector stores (kR a multiple of 4 and Qp of kR;
//     else a store a row), which is why the launcher gives these two
//     classes 4 rows a lane wherever a warp's 128 rows fill;
//   - rowcol / stats_rowcol: the lane that holds row qlen - 1, in whatever
//     group of rows it sits, writes the last row as it computes it; every
//     row writes its element of the last column at j = rlen - 1;
//   - the planes are zero-filled by the caller and written only in each
//     pair's qlen x rlen cells, so a pair with an empty side keeps zeros.
//
// The score, stats and trace classes need no form here: the caller
// launches the segment form (scan_segment.cu's pt_scan_segment) as one
// segment from column 0, and its (B, Qp, Rp) int8 trace buffer is then the
// whole plane on the card, which the device walk reads in place.  This
// source instantiates only the four plane forms, so no kernel is compiled
// twice.
//
// What bounds it on this card: the segment kernel's step latency and the
// chain's fill.  align_cigars' bins hold few long pairs (16 of 4,096 bp
// under the 2^28-cell cap), which a block a pair would leave on 16 of 132
// SMs; the launcher's rule spreads such a pair over a cluster of blocks,
// whose warps extend the chain, so the pair's groups of rows, and their
// fill, are fewer.  The plane forms add a store a cell (four with
// payloads; the H plane's a 16-byte store of a lane's rows).
#include "segment_block.cuh"

// Launches the chunked sweep of a plane class on `stream` and returns the
// launch's CUDA error as an int (0 = launched).  All pointers are device
// pointers.
//   out_class: 3-6 (ptscore::OutClass: table, stats_table, rowcol,
//              stats_rowcol); any other returns cudaErrorInvalidValue
//   subs/qidx/mq: as pt_scan_segment
//   ridx:      (B, Rp) letters
//   bottom:    scratch, (B, 2, Rp), or (B, 8, Rp) for the stats classes
//   st_h/st_f: scratch, (B, Qp); st_pay: stats classes, (6, B, Qp)
//   acc:       scratch, (B, 8)
//   out:       (5, B), or (8, B) for the stats classes
//   tab:       table classes: (1 or 4, B, Rp, Qp), zero-filled
//   rows/cols: rowcol classes: (1 or 4, B, Rp) and (1 or 4, B, Qp),
//              zero-filled
//   warps, lane_rows, cluster: as pt_scan_segment's warps, rows, cluster
extern "C" int pt_scan_chunked(int out_class, const void* subs,
                               const void* qidx, const void* mq,
                               const void* ridx, const void* qlen,
                               const void* rlen, void* bottom, void* st_h,
                               void* st_f, void* st_pay, void* acc, void* out,
                               void* tab, void* rows, void* cols, int B,
                               int Bq, int Bm, int Qp, int Rp, int A, int open,
                               int ext, int mode, int free_bits, int warps,
                               int lane_rows, int cluster, void* stream) {
  const ptsegblock::SegArgs a{
      (const int32_t*)subs, (const int32_t*)qidx, (const int32_t*)mq,
      (const int32_t*)ridx, (const int32_t*)qlen, (const int32_t*)rlen,
      (int32_t*)bottom, nullptr, (int32_t*)st_h, (int32_t*)st_f,
      (int32_t*)st_pay, (int32_t*)acc, (int32_t*)out, nullptr, nullptr,
      nullptr, (int32_t*)tab, (int32_t*)rows, (int32_t*)cols, B, Bq, Bm, Qp,
      Rp, A, open, ext, mode, free_bits, 0, 0, Qp, 0, 1};
#define PT_CHUNK(k) \
  ptsegblock::launch<k, false>(a, warps, lane_rows, cluster, stream)
  switch (out_class) {
    case ptscore::OUT_TABLE:
      return PT_CHUNK(ptscore::OUT_TABLE);
    case ptscore::OUT_STATS_TABLE:
      return PT_CHUNK(ptscore::OUT_STATS_TABLE);
    case ptscore::OUT_ROWCOL:
      return PT_CHUNK(ptscore::OUT_ROWCOL);
    case ptscore::OUT_STATS_ROWCOL:
      return PT_CHUNK(ptscore::OUT_STATS_ROWCOL);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PT_CHUNK
}
