// Host build of the kernels' per-pair code (score_cell.cuh, walk_step.cuh)
// for the CPU tests: the same score_batch_pair and walk_pair the CUDA
// kernels run, one pair at a time, with the row scratch at stride 1.
// Build with
//   g++ -O2 -std=c++17 -shared -fPIC -o libptscore_host.so score_host.cc
#include <stdint.h>

#include <vector>

#include "score_cell.cuh"
#include "walk_step.cuh"

namespace {

template <bool kTrace>
void sweep(const int32_t* subs, const int32_t* qidx, const int32_t* ridx,
           const int32_t* qlen, const int32_t* rlen, int32_t* out,
           int8_t* trace, int B, int Bq, int Qp, int Rp, int A, int open,
           int ext, int mode, int free_bits) {
  std::vector<int32_t> hrow(Rp > 0 ? Rp : 1), erow(Rp > 0 ? Rp : 1);
  for (int b = 0; b < B; ++b) {
    const ptscore::PairResult r = ptscore::score_batch_pair<kTrace>(
        b, subs, subs, qidx, ridx, qlen, rlen, hrow.data(), erow.data(), 1,
        Bq, Qp, Rp, A, open, ext, mode, free_bits,
        kTrace ? trace + (int64_t)b * Qp * Rp : nullptr, Rp, 1);
    out[b] = r.score;
    out[B + b] = r.end_query;
    out[2 * B + b] = r.end_ref;
    out[3 * B + b] = r.sat8;
    out[4 * B + b] = r.sat16;
  }
}

}  // namespace

// Same arguments as pt_scan_score minus the scratch and the stream;
// `out` is (5, B): score, end_query, end_ref, sat8, sat16.
extern "C" int pt_score_host(const int32_t* subs, const int32_t* qidx,
                             const int32_t* ridx, const int32_t* qlen,
                             const int32_t* rlen, int32_t* out, int B, int Bq,
                             int Qp, int Rp, int A, int open, int ext,
                             int mode, int free_bits) {
  sweep<false>(subs, qidx, ridx, qlen, rlen, out, nullptr, B, Bq, Qp, Rp, A,
               open, ext, mode, free_bits);
  return 0;
}

// pt_score_host plus the flags of each in-sequence cell into `trace`, a
// (B, Qp, Rp) int8 plane the caller zero-fills.
extern "C" int pt_trace_host(const int32_t* subs, const int32_t* qidx,
                             const int32_t* ridx, const int32_t* qlen,
                             const int32_t* rlen, int32_t* out, int8_t* trace,
                             int B, int Bq, int Qp, int Rp, int A, int open,
                             int ext, int mode, int free_bits) {
  sweep<true>(subs, qidx, ridx, qlen, rlen, out, trace, B, Bq, Qp, Rp, A,
              open, ext, mode, free_bits);
  return 0;
}

// Same arguments as pt_trace_walk minus the stream, over a contiguous
// (B, Qp, Rp) plane; `ops` (B, Qp + Rp) arrives zero-filled, `beg` is
// (2, B).
extern "C" int pt_walk_host(const int8_t* trace, const int32_t* qsym,
                            const int32_t* rsym, const int32_t* end_q,
                            const int32_t* end_r, uint8_t* ops, int32_t* beg,
                            int B, int Bq, int Qp, int Rp, int local, int qb,
                            int db) {
  const int32_t L = Qp + Rp;
  for (int b = 0; b < B; ++b) {
    ptwalk::walk_pair(trace + (int64_t)b * Qp * Rp, Rp, 1,
                      qsym + (Bq == 1 ? 0 : (int64_t)b * Qp),
                      rsym + (int64_t)b * Rp, end_q[b], end_r[b], L,
                      local != 0, qb != 0, db != 0, ops + (int64_t)b * L,
                      beg[b], beg[B + b]);
  }
  return 0;
}
