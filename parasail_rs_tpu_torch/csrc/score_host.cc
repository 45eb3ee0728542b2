// Host build of the score kernel's per-pair code (score_cell.cuh) for the
// CPU tests: the same score_batch_pair the CUDA kernel runs, one pair at
// a time, with the row scratch at stride 1.  Build with
//   g++ -O2 -std=c++17 -shared -fPIC -o libptscore_host.so score_host.cc
#include <stdint.h>

#include <vector>

#include "score_cell.cuh"

// Same arguments as pt_scan_score minus the scratch and the stream;
// `out` is (5, B): score, end_query, end_ref, sat8, sat16.
extern "C" int pt_score_host(const int32_t* subs, const int32_t* qidx,
                             const int32_t* ridx, const int32_t* qlen,
                             const int32_t* rlen, int32_t* out, int B, int Bq,
                             int Qp, int Rp, int A, int open, int ext,
                             int mode, int free_bits) {
  std::vector<int32_t> hrow(Rp > 0 ? Rp : 1), erow(Rp > 0 ? Rp : 1);
  for (int b = 0; b < B; ++b) {
    const ptscore::PairResult r = ptscore::score_batch_pair(
        b, subs, subs, qidx, ridx, qlen, rlen, hrow.data(), erow.data(), 1,
        Bq, Qp, Rp, A, open, ext, mode, free_bits);
    out[b] = r.score;
    out[B + b] = r.end_query;
    out[2 * B + b] = r.end_ref;
    out[3 * B + b] = r.sat8;
    out[4 * B + b] = r.sat16;
  }
  return 0;
}
