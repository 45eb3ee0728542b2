// The unbanded one-shot sweep of short pairs, every output class, for
// Hopper (sm_90a): one warp a pair, several pairs a block (kernels
// K1a-K1d).  The kernel, its design and what bounds it are in
// scan_short.cuh; scan_short_banded.cu instantiates its masked forms.
#include "scan_short.cuh"

// Launches the short form of class `out_class` (ptscore::OutClass, 0-6)
// on `stream` and returns the launch's CUDA error as an int (0 =
// launched).  All pointers are device pointers:
//   subs, qidx: (A, A) table and (Bq, Qp) letters, or (Bq, Qp, A) profile
//               rows and null
//   mq:         stats classes: (Bm, Qp) query letters for `matches`
//   ridx:       (B, Rp) letters; qlen, rlen: (B,)
//   out:        (5, B) score, end_query, end_ref, sat8, sat16, or (8, B)
//               with matches, similar, length (stats classes)
//   trace:      trace: (B, Qp, Rp) int8 flags
//   tab:        table, stats_table: (1 or 4, B, Rp, Qp) H (, matches,
//               similar, length) of every cell, query-fastest
//   row, col:   rowcol, stats_rowcol: (1 or 4, B, Rp) last row and
//               (1 or 4, B, Qp) last column
// The caller zero-fills the planes, rows and columns; the kernel writes
// each pair's qlen x rlen cells, its last row's rlen and its last
// column's qlen.  A batch the rule (score_cell.cuh, short_plan) does not
// give the short form returns cudaErrorInvalidValue.
extern "C" int pt_scan_short(int out_class, const void* subs,
                             const void* qidx, const void* mq,
                             const void* ridx, const void* qlen,
                             const void* rlen, void* out, void* trace,
                             void* tab, void* row, void* col, int B, int Bq,
                             int Bm, int Qp, int Rp, int A, int open, int ext,
                             int mode, int free_bits, void* stream) {
  return scan_short<false>(out_class, subs, qidx, mq, ridx, qlen, rlen, out,
                           trace, tab, row, col, B, Bq, Bm, Qp, Rp, A, open,
                           ext, mode, free_bits, 0, stream);
}

// The short form's rule for a launch (score_cell.cuh, short_plan): rows a
// lane (0: the short form does not take the batch), pairs a block and the
// stats classes' payload layout (1 [m | s | l], 2 [m | s] + l; 0 for the
// other classes) to plan[0..2].
extern "C" int pt_short_plan(int out_class, int B, int Bq, int Qp, int Rp,
                             int A, int profile, int* plan) {
  const ptscore::ShortPlan p = ptscore::short_plan(
      out_class, B, Qp, Rp, A, profile != 0, profile != 0 && Bq != 1);
  plan[0] = p.rows;
  plan[1] = p.pairs;
  plan[2] = p.layout;
  return 0;
}
