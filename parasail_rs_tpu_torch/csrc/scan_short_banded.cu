// The banded mode's masked full sweep of short pairs (kernel K1e, every
// class the ring does not take: trace, stats, table, stats_table, rowcol
// and stats_rowcol, and the score class past the ring's reach) for Hopper
// (sm_90a): the short form (scan_short.cuh, one warp a pair) with
// kBanded, in its own translation unit so that nvcc builds it beside the
// unbanded forms.
//
// Replaces: parasail_rs_tpu/ops/scan_kernel.py::scan_score_align (the
// pallas_call at scan_kernel.py:1453) with banded=True (:1307-1308, masks
// :602-617), for pairs of at most 256 padded query rows; past them the
// block kernel's masked form (scan_chunked_banded.cu) runs.  Same outputs
// as score_pair<kOut, true>, the g++-tested recurrence, and so as the
// plain version (the wavefront with banded=True), in every cell inside
// and outside the band.
//
// What bounds it on this card: the unbanded short form's step chain plus
// a compare and three selects a cell, over every cell of the pair.
#include "scan_short.cuh"

// pt_scan_short's launch (scan_short.cu; same arguments and layouts)
// masked to the band of half-width `bandwidth` (clamped to [-1, Qp +
// Rp]): cells with |i - j| > bw and border cells past bw are -2^30 after
// their flags and payloads are taken.
extern "C" int pt_scan_short_banded(int out_class, const void* subs,
                                    const void* qidx, const void* mq,
                                    const void* ridx, const void* qlen,
                                    const void* rlen, void* out, void* trace,
                                    void* tab, void* row, void* col, int B,
                                    int Bq, int Bm, int Qp, int Rp, int A,
                                    int open, int ext, int mode,
                                    int free_bits, int bandwidth,
                                    void* stream) {
  return scan_short<true>(out_class, subs, qidx, mq, ridx, qlen, rlen, out,
                          trace, tab, row, col, B, Bq, Bm, Qp, Rp, A, open,
                          ext, mode, free_bits, bandwidth, stream);
}
