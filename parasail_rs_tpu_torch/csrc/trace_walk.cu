// Batched traceback walk kernel for Hopper (sm_90a): a warp a pair over
// tiles of the flag plane staged in shared memory.
//
// Replaces: parasail_rs_tpu/ops/trace_walk.py::_walk_impl (one lax.scan
// of Qp + Rp steps over the batch; plain XLA on the TPU, a hand kernel
// here because as torch ops it would cost one launch per step).  Same
// outputs, bit for bit: backward opcodes (B, Qp + Rp) uint8, zero after
// each walk ends (the kernel writes the whole row), and the begin cells
// (B,) int32 x 2.
//
// Design (walk_step.cuh, "the tiled walk"): one warp a pair, four warps a
// block.  The warp copies a 32 x 64 tile of the pair's flags that ends at
// the walk's first cell, with its query and reference symbols, into
// shared memory; lane 0 runs walk_step.cuh's state machine on it, each
// step a shared-memory load instead of a dependent load from L2 or device
// memory, while the other 31 lanes copy the tiles above, to the left and
// above-left of it (cp.async) into the other three slots.  When the walk
// leaves the tile it is in one of those; the warp waits for the copies
// and starts the next three.  Lane 0 loads the flags of the three cells
// a step can move to before it decides, so a step waits for logic and a
// select, not for a load.  The opcodes gather in shared memory and the
// warp stores them together, 16 bytes a lane where the row aligns; the
// leading gaps after one index is exhausted, and the zeros after the
// walk, go out as runs.  The plane is read through its strides: the short
// form's and the chunked sweep's contiguous (B, Qp, Rp) planes, rows a
// multiple of 16 bytes, in 16-byte copies; others (the banded classes'
// [Qp][Rp][B] planes as (B, Qp, Rp) views, rows of any length) a byte a
// cell, 31 lanes at once.
//
// What bounds it on this card: a step's shared-memory loads and the state
// machine's few dependent operations (about qlen + rlen steps a pair on a
// global path), and the copies a walk waits for when it crosses tiles
// faster than they arrive; the plane's bytes are not the bound (a walk
// reads a tile's neighbours, three of 2 KB for every 32 or so steps).
#include <cuda_runtime.h>
#include <stdint.h>

#include "walk_step.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;

// One warp's shared memory: four tiles of flags and symbols, the stage.
struct alignas(16) WarpSmem {
  int8_t flags[ptwalk::WALK_SLOTS][ptwalk::TILE_R * ptwalk::TILE_C];
  int32_t qs[ptwalk::WALK_SLOTS][ptwalk::TILE_R];
  int32_t rs[ptwalk::WALK_SLOTS][ptwalk::TILE_C];
  uint8_t stage[ptwalk::WALK_STAGE];
};

__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

// The IO of walk_pair_tiled for one warp and its pair.
struct WarpIO {
  WarpSmem* sm;
  const int8_t* plane;       // the pair's cell (0, 0)
  int64_t si, sj;
  const int32_t* qsym;       // the pair's symbols
  const int32_t* rsym;
  int32_t qp, rp;
  bool wide;                 // 16-byte copies of rows
  bool wide_q, wide_r;       // 16-byte copies of the symbols
  uint8_t* ops;              // the pair's opcode row
  int32_t lane;

  __device__ bool leader() const { return lane == 0; }
  __device__ int32_t share(int32_t v) const {
    return __shfl_sync(kFull, v, 0);
  }
  __device__ const int8_t* flags(int32_t s) const { return sm->flags[s]; }
  __device__ const int32_t* qs(int32_t s) const { return sm->qs[s]; }
  __device__ const int32_t* rs(int32_t s) const { return sm->rs[s]; }
  __device__ uint8_t* stage() const { return sm->stage; }

  __device__ void load(int32_t s, const ptwalk::Tile& t, bool all) const {
    using ptwalk::TILE_C;
    using ptwalk::TILE_R;
    const int32_t first = all ? lane : lane - 1;
    const int32_t step = all ? 32 : 31;
    if (first >= 0) {
      // the symbols four at a time: a 16-byte copy where all four lie in
      // the pair and the row allows, else word by word
      for (int32_t x = first; x < (TILE_R + TILE_C) / 4; x += step) {
        const bool qx = x < TILE_R / 4;
        const int32_t o = qx ? 4 * x : 4 * x - TILE_R;
        const int32_t at = (qx ? t.r0 : t.c0) + o, end = qx ? qp : rp;
        const int32_t* src = (qx ? qsym : rsym) + at;
        int32_t* dst = qx ? &sm->qs[s][o] : &sm->rs[s][o];
        if (at >= 0 && at + 4 <= end && (qx ? wide_q : wide_r)) {
          copy_async(dst, src, 16);
        } else {
          for (int32_t y = 0; y < 4; ++y)
            if (at + y >= 0 && at + y < end) copy_async(dst + y, src + y, 4);
        }
      }
      if (wide) {
        constexpr int32_t chunks = TILE_C / 16;
        for (int32_t x = first; x < TILE_R * chunks; x += step) {
          const int32_t r = t.r0 + x / chunks;
          const int32_t c = t.c0 + 16 * (x % chunks);
          if (r >= 0 && r < qp && c >= 0 && c < rp)
            copy_async(&sm->flags[s][(x / chunks) * TILE_C + 16 * (x % chunks)],
                       plane + r * si + c, 16);
        }
      } else {
        // consecutive lanes on consecutive columns of a row
        for (int32_t x = first; x < TILE_R * TILE_C; x += step) {
          const int32_t r = t.r0 + x / TILE_C, c = t.c0 + x % TILE_C;
          if (r >= 0 && r < qp && c >= 0 && c < rp)
            sm->flags[s][x] = plane[r * si + c * sj];
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  __device__ void wait(int32_t n) const {
    if (n == 0)
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 3;\n" ::: "memory");
    __syncwarp();
  }

  // bytes [k0, k0 + n) of the row from byte(k), 16 a lane where aligned
  template <class Byte>
  __device__ void put(int32_t k0, int32_t n, Byte byte) const {
    __syncwarp();
    uint8_t* dst = ops + k0;
    const int32_t head =
        (int32_t)((16 - ((uintptr_t)dst & 15)) & 15) < n
            ? (int32_t)((16 - ((uintptr_t)dst & 15)) & 15)
            : n;
    const int32_t body = (n - head) / 16;
    for (int32_t x = lane; x < head; x += 32) dst[x] = byte(x);
    for (int32_t x = lane; x < body; x += 32) {
      uint32_t w[4];
#pragma unroll
      for (int32_t q = 0; q < 4; ++q) {
        const int32_t o = head + 16 * x + 4 * q;
        w[q] = (uint32_t)byte(o) | ((uint32_t)byte(o + 1) << 8) |
               ((uint32_t)byte(o + 2) << 16) | ((uint32_t)byte(o + 3) << 24);
      }
      *reinterpret_cast<uint4*>(dst + head + 16 * x) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    for (int32_t x = head + 16 * body + lane; x < n; x += 32) dst[x] = byte(x);
    __syncwarp();
  }

  __device__ void flush(int32_t k0, int32_t n) const {
    const uint8_t* st = sm->stage;
    put(k0, n, [st](int32_t x) { return st[x]; });
  }

  __device__ void fill(int32_t k0, int32_t n, uint8_t op) const {
    put(k0, n, [op](int32_t) { return op; });
  }
};

__global__ void __launch_bounds__(kWarps * 32) trace_walk_kernel(
    const int8_t* __restrict__ trace,  // cell (b, i, j) at b*sb + i*si + j*sj
    int64_t sb, int64_t si, int64_t sj,
    const int32_t* __restrict__ qsym,  // (Bq, Qp)
    const int32_t* __restrict__ rsym,  // (B, Rp)
    const int32_t* __restrict__ end_q,  // (B,)
    const int32_t* __restrict__ end_r,  // (B,)
    uint8_t* __restrict__ ops,          // (B, Qp + Rp)
    int32_t* __restrict__ beg,          // (2, B): beg_q, beg_r
    int32_t B, int32_t Bq, int32_t Qp, int32_t Rp, int32_t local, int32_t qb,
    int32_t db, int32_t wide, int32_t wide_q, int32_t wide_r) {
  __shared__ WarpSmem smem[kWarps];
  const int32_t w = threadIdx.x / 32;
  const int32_t b = blockIdx.x * kWarps + w;
  if (b >= B) return;                  // whole warps: b is the warp's
  const int32_t L = Qp + Rp;
  WarpIO io{&smem[w], trace + b * sb, si, sj,
            qsym + (Bq == 1 ? 0 : (int64_t)b * Qp), rsym + (int64_t)b * Rp,
            Qp, Rp, wide != 0, wide_q != 0, wide_r != 0,
            ops + (int64_t)b * L, (int32_t)(threadIdx.x & 31)};
  int32_t bq, br;
  ptwalk::walk_pair_tiled(io, end_q[b], end_r[b], Qp, Rp, L, local != 0,
                          qb != 0, db != 0, bq, br);
  if (io.leader()) {
    beg[b] = bq;
    beg[B + b] = br;
  }
}

}  // namespace

// Launches the walk on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Strides are in elements (bytes) of the int8 plane;
// `ops` (B, Qp + Rp) is written whole.  Rows go in 16-byte copies when
// sj is 1 and the pairs' rows start 16-byte aligned, Rp a multiple of 16;
// symbols four words a copy where their rows align.
extern "C" int pt_trace_walk(const void* trace, long long sb, long long si,
                             long long sj, const void* qsym, const void* rsym,
                             const void* end_q, const void* end_r, void* ops,
                             void* beg, int B, int Bq, int Qp, int Rp,
                             int local, int qb, int db, void* stream) {
  if (B <= 0) return 0;
  const int wide = sj == 1 && si % 16 == 0 && sb % 16 == 0 && Rp % 16 == 0 &&
                   (uintptr_t)trace % 16 == 0;
  // symbol rows start on 16 bytes where the base does and rows are
  // multiples of 4 words
  const int wide_q = Qp % 4 == 0 && (uintptr_t)qsym % 16 == 0;
  const int wide_r = Rp % 4 == 0 && (uintptr_t)rsym % 16 == 0;
  const int blocks = (B + kWarps - 1) / kWarps;
  trace_walk_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)trace, sb, si, sj, (const int32_t*)qsym,
      (const int32_t*)rsym, (const int32_t*)end_q, (const int32_t*)end_r,
      (uint8_t*)ops, (int32_t*)beg, B, Bq, Qp, Rp, local, qb, db, wide,
      wide_q, wide_r);
  return (int)cudaGetLastError();
}
