// The segment kernel's score class on 16x2 DPX for Hopper (sm_90a): two
// pairs a lane (segment16.cuh).
//
// Replaces, for the score class of the block kernel (kernel K2's segments
// and kernel K1f's one-shot score launch, which is one segment of Rp
// columns), the int32 form of scan_segment.cu: the same segment, state and
// outputs, with a unit of two pairs in each lane's registers as the low
// and high halves of its words, so each DPX instruction computes a cell
// of both pairs, and one shuffle, one step's letter and bookkeeping and
// one chain of rows serve two pairs.  The launch takes the rule's plan
// (seg_plan) for its ceil(B / 2) units.
//
// What it gives up: range.  A pair whose H leaves the band of 16-bit
// values that cannot wrap (segment16.cuh, Band16) is flagged in `over`,
// and its outputs must be computed again by the int32 form
// (engine/dispatch.py does, at fetch); every other pair's outputs and
// state are the int32 form's, bit for bit.
//
// Forms: rows a lane 2, 4, 8; SW (the clamp, every cell a candidate) or
// NW / SG; the pair table (a table of at most 7 letters: one score load a
// row) or each half's own row (larger tables, the profile of one query).
#include "segment16.cuh"

// Launches the packed score form on `stream`; returns the launch's CUDA
// error as an int (0 = launched).  All pointers are device pointers.
//   subs/qidx: as pt_scan_segment (qidx null: the profile form, whose
//              profile must be one query's, Bq == 1)
//   ridx:      (B, Rseg) letters of columns [off, off + Rseg)
//   units:     (U, 2) the pairs of each unit, -1: none beside
//   bottom:    scratch, (U, 2, Rseg)
//   st_h/st_f: (B, Qp) state, read (if resume) and written in place
//   acc:       (B, 8) accumulator, read (if resume) and written in place
//   over:      (B,) the band's flag, read (if resume) and written
//   out:       (6, B): score, end_query, end_ref, sat8, sat16, over
//   bound:     the largest |score| of the table or profile
//   warps, rows, cluster: as pt_scan_segment, for the units
extern "C" int pt_scan_segment16(const void* subs, const void* qidx,
                                 const void* ridx, const void* qlen,
                                 const void* rlen, const void* units,
                                 void* bottom, void* st_h, void* st_f,
                                 void* acc, void* over, void* out, int U,
                                 int B, int Bq, int Qp, int Rseg, int A,
                                 int open, int ext, int mode, int free_bits,
                                 int off, int resume, int bound, int warps,
                                 int rows, int cluster, void* stream) {
  const ptseg16::Seg16Args a{
      (const int32_t*)subs, (const int32_t*)qidx, (const int32_t*)ridx,
      (const int32_t*)qlen, (const int32_t*)rlen, (const int32_t*)units,
      (uint32_t*)bottom, (int32_t*)st_h, (int32_t*)st_f, (int32_t*)acc,
      (int32_t*)over, (int32_t*)out, U, B, Bq, Qp, Rseg, A, open, ext,
      mode, free_bits, off, resume, bound, 1};
  return ptseg16::launch16(a, warps, rows, cluster, stream);
}

// The plan of a packed launch of U units (segment16.cuh, seg16_plan):
// rows a lane, warps a block and blocks a unit to plan[0..2].  Returns 0.
extern "C" int pt_segment16_plan(int U, int Qs, int ncols, int A,
                                 int profile, int warps, int rows,
                                 int cluster, int* plan) {
  const ptscore::SegPlan p = ptseg16::seg16_plan(U, Qs, ncols, A,
                                                 profile != 0, warps, rows,
                                                 cluster);
  plan[0] = p.rows;
  plan[1] = p.warps;
  plan[2] = p.cluster;
  return 0;
}
