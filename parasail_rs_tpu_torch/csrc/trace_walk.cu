// Batched traceback walk kernel for Hopper (sm_90a).
//
// Replaces: parasail_rs_tpu/ops/trace_walk.py::_walk_impl (one lax.scan
// of Qp + Rp steps over the batch; plain XLA on the TPU, a hand kernel
// here because as torch ops it would cost one launch per step).  Same
// outputs, bit for bit: backward opcodes (B, Qp + Rp) uint8, zero-padded
// after each walk ends, and the begin cells (B,) int32 x 2.
//
// Design: one thread per pair runs walk_step.cuh's state machine from its
// end cell and stops when its walk ends, so a short alignment costs only
// its own steps.  The flag plane is read in place through its strides:
// the trace kernel's [Qp][Rp][B] plane arrives as a (B, Qp, Rp) view, and
// a walk of a contiguous (B, Qp, Rp) plane works the same.
//
// What bounds it on this card: each step is one dependent byte load at an
// address the previous step chose (the path is data-dependent), so a walk
// is a chain of about qlen + rlen memory latencies; a batch of pairs
// overlaps them across threads.  Nothing to reuse, so no shared memory;
// the planes of a 512-pair chunk (19 MB at 192 x 192) stay in L2 after the
// trace kernel wrote them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "walk_step.cuh"

namespace {

__global__ void trace_walk_kernel(
    const int8_t* __restrict__ trace,  // cell (b, i, j) at b*sb + i*si + j*sj
    int64_t sb, int64_t si, int64_t sj,
    const int32_t* __restrict__ qsym,  // (Bq, Qp)
    const int32_t* __restrict__ rsym,  // (B, Rp)
    const int32_t* __restrict__ end_q,  // (B,)
    const int32_t* __restrict__ end_r,  // (B,)
    uint8_t* __restrict__ ops,          // (B, Qp + Rp), zero-filled
    int32_t* __restrict__ beg,          // (2, B): beg_q, beg_r
    int32_t B, int32_t Bq, int32_t Qp, int32_t Rp, int32_t local, int32_t qb,
    int32_t db) {
  const int32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int32_t L = Qp + Rp;
  int32_t bq, br;
  ptwalk::walk_pair(trace + b * sb, si, sj,
                    qsym + (Bq == 1 ? 0 : (int64_t)b * Qp),
                    rsym + (int64_t)b * Rp, end_q[b], end_r[b], Qp, Rp, L,
                    local != 0, qb != 0, db != 0, ops + (int64_t)b * L, bq,
                    br);
  beg[b] = bq;
  beg[B + b] = br;
}

constexpr int kThreads = 64;

}  // namespace

// Launches the walk on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Strides are in elements (bytes) of the int8 plane.
extern "C" int pt_trace_walk(const void* trace, long long sb, long long si,
                             long long sj, const void* qsym, const void* rsym,
                             const void* end_q, const void* end_r, void* ops,
                             void* beg, int B, int Bq, int Qp, int Rp,
                             int local, int qb, int db, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  trace_walk_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)trace, sb, si, sj, (const int32_t*)qsym,
      (const int32_t*)rsym, (const int32_t*)end_q, (const int32_t*)end_r,
      (uint8_t*)ops, (int32_t*)beg, B, Bq, Qp, Rp, local, qb, db);
  return (int)cudaGetLastError();
}
