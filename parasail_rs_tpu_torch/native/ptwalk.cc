// Batched traceback walker: trace-flag planes -> CIGAR runs.
//
// The native host-side component of the framework, mirroring the role of
// parasail's C traceback/CIGAR layer reached by the reference through
// parasail_result_get_cigar / parasail_cigar_decode / _get_traceback
// (reference: src/alignment/mod.rs:310-419).  The per-pair walk is
// inherently sequential (O(alignment length) pointer chasing), so it runs
// on the host over the int8 flag planes the TPU kernels emit; this
// implementation batches many pairs per call to amortize the FFI
// boundary.
//
// Semantics are bit-identical to the Python oracle
// (parasail_rs_tpu/golden/model.py::walk_trace): H-state follows the
// H-family bits; entering a gap switches to the E/F family whose current
// cell decides continue (INS_E/DEL_F) vs close (DIAG_E/DIAG_F); free
// leading gaps are unaligned overhang, penalized leading gaps are
// emitted as I/D runs.
//
// CIGAR packing: (length << 4) | op, op indexes "MIDNSHP=XB" (SAM order),
// matching the codec the reference exposes (src/alignment/mod.rs:390-419
// and the SSW raw u32 buffer :537-543).

#include <cstdint>

namespace {

constexpr int8_t T_INS = 1;
constexpr int8_t T_DEL = 2;
constexpr int8_t T_DIAG = 4;
constexpr int8_t T_DIAG_E = 8;
constexpr int8_t T_DIAG_F = 32;
constexpr int8_t T_H_BITS = 7;

constexpr uint32_t OP_M = 0, OP_I = 1, OP_D = 2, OP_EQ = 7, OP_X = 8;

struct Emitter {
  uint32_t* out;
  int cap;
  int n = 0;
  bool overflow = false;

  // Ops are produced in reverse order; push merges with the latest run.
  void push(uint32_t op, uint32_t count = 1) {
    if (n > 0 && (out[n - 1] & 0xF) == op) {
      out[n - 1] += count << 4;
      return;
    }
    if (n >= cap) {
      overflow = true;
      return;
    }
    out[n++] = (count << 4) | op;
  }
};

}  // namespace

extern "C" {

// Walk one pair's trace plane backwards from (end_q, end_r).
//
//   trace:   row-major (qlen, rlen) int8 flag plane
//   local:   1 for sw (stop at ZERO cells), 0 otherwise
//   qb/db:   free-begin flags (suppress the leading boundary run)
//   merge_m: 1 -> emit SAM 'M' for both match/mismatch (SSW style),
//            0 -> emit '='/'X' (parasail style)
//   cigar_out: packed (len<<4)|op runs in REVERSED order (callee walks
//              backwards); pt_walk_trace un-reverses before returning.
//
// Returns the number of runs written, or -1 if cigar_cap was too small.
int pt_walk_trace(const int8_t* trace, int qlen, int rlen,
                  const uint8_t* query, const uint8_t* ref,
                  int end_q, int end_r, int local, int qb, int db,
                  int merge_m,
                  uint32_t* cigar_out, int cigar_cap,
                  int* beg_q_out, int* beg_r_out) {
  Emitter em{cigar_out, cigar_cap};
  int i = end_q, j = end_r;
  int state = 0;  // 0=H, 1=E (vertical/I), 2=F (horizontal/D)

  while (i >= 0 && j >= 0) {
    const int8_t t = trace[i * rlen + j];
    if (state == 0) {
      const int8_t h = t & T_H_BITS;
      if (h == 0 && local) break;
      if (h & T_DIAG) {
        if (merge_m) {
          em.push(OP_M);
        } else {
          em.push(query[i] == ref[j] ? OP_EQ : OP_X);
        }
        --i;
        --j;
      } else if (h & T_INS) {
        em.push(OP_I);
        state = (t & T_DIAG_E) ? 0 : 1;
        --i;
      } else if (h & T_DEL) {
        em.push(OP_D);
        state = (t & T_DIAG_F) ? 0 : 2;
        --j;
      } else {
        break;  // ZERO in a non-local table: should not happen
      }
    } else if (state == 1) {
      em.push(OP_I);
      state = (t & T_DIAG_E) ? 0 : 1;
      --i;
    } else {
      em.push(OP_D);
      state = (t & T_DIAG_F) ? 0 : 2;
      --j;
    }
  }

  int beg_q = i + 1, beg_r = j + 1;
  if (!local) {
    // Penalized leading gaps belong to the alignment; free leading gaps
    // are unaligned overhang recorded via beg_*.
    if (i >= 0 && j < 0 && !db) {
      em.push(OP_I, static_cast<uint32_t>(i + 1));
      beg_q = 0;
    }
    if (j >= 0 && i < 0 && !qb) {
      em.push(OP_D, static_cast<uint32_t>(j + 1));
      beg_r = 0;
    }
  }
  if (em.overflow) return -1;

  // Runs were emitted back-to-front; reverse in place.
  for (int a = 0, b = em.n - 1; a < b; ++a, --b) {
    const uint32_t tmp = cigar_out[a];
    cigar_out[a] = cigar_out[b];
    cigar_out[b] = tmp;
  }
  *beg_q_out = beg_q;
  *beg_r_out = beg_r;
  return em.n;
}

// Run-length encode the device walk's backward opcode rows.
//
//   ops:     row-major (n, L) uint8 rows from ops/trace_walk.device_walk
//            (0=none, 1='=', 2='X', 3=I, 4=D), each a nonzero prefix in
//            BACKWARD order followed by zero padding
//   merge_m: 1 -> emit SAM 'M' for both '='/'X' (SSW style)
//   runs_out: dense (n, cap) packed (len<<4)|op runs, FORWARD order
//   counts_out[k]: pair k's run count (-1 on overflow; cap >= L never
//                  overflows because each run covers >= 1 op)
//
// Replaces the vectorized-numpy ops_to_runs_flat pass, which costs
// ~38 ms for a (4096, 320) batch (five full-array passes + nonzero);
// this single pass is ~1-2 ms with OpenMP.
void pt_rle_ops(int n, int L, const uint8_t* ops, int merge_m,
                uint32_t* runs_out, int cap, int32_t* counts_out) {
  static const uint32_t kMap[5] = {0, OP_EQ, OP_X, OP_I, OP_D};
#pragma omp parallel for schedule(static)
  for (int k = 0; k < n; ++k) {
    const uint8_t* row = ops + static_cast<int64_t>(k) * L;
    uint32_t* out = runs_out + static_cast<int64_t>(k) * cap;
    int ns = 0;
    while (ns < L && row[ns] != 0) ++ns;
    int m = 0;
    bool overflow = false;
    // reverse the backward prefix: forward order is row[ns-1] .. row[0]
    for (int t = ns - 1; t >= 0; --t) {
      uint32_t op = kMap[row[t]];
      if (merge_m && (op == OP_EQ || op == OP_X)) op = OP_M;
      if (m > 0 && (out[m - 1] & 0xF) == op) {
        out[m - 1] += 1u << 4;
      } else if (m >= cap) {
        overflow = true;
        break;
      } else {
        out[m++] = (1u << 4) | op;
      }
    }
    counts_out[k] = overflow ? -1 : m;
  }
}

// Compact the dense (n, cap) run rows into one flat array at the given
// per-row offsets (host computes offsets = cumsum(counts) - counts).
void pt_compact_runs(int n, int cap, const uint32_t* runs,
                     const int32_t* counts, const int64_t* offsets,
                     uint32_t* flat_out) {
#pragma omp parallel for schedule(static)
  for (int k = 0; k < n; ++k) {
    const uint32_t* src = runs + static_cast<int64_t>(k) * cap;
    uint32_t* dst = flat_out + offsets[k];
    const int c = counts[k] < 0 ? 0 : counts[k];
    for (int t = 0; t < c; ++t) dst[t] = src[t];
  }
}

// Batched walk: n independent pairs, each with its own plane/lengths.
// cigar_out is one dense (n, cigar_cap) uint32 buffer; lens_out[k]
// receives pair k's run count (-1 on per-pair overflow).
void pt_walk_batch(int n,
                   const int8_t* const* traces,
                   const int32_t* qlens, const int32_t* rlens,
                   const uint8_t* const* queries,
                   const uint8_t* const* refs,
                   const int32_t* end_qs, const int32_t* end_rs,
                   int local, int qb, int db, int merge_m,
                   uint32_t* cigar_out, int cigar_cap,
                   int32_t* lens_out,
                   int32_t* beg_qs_out, int32_t* beg_rs_out) {
#pragma omp parallel for schedule(dynamic, 16)
  for (int k = 0; k < n; ++k) {
    int bq = 0, br = 0;
    lens_out[k] = pt_walk_trace(
        traces[k], qlens[k], rlens[k], queries[k], refs[k],
        end_qs[k], end_rs[k], local, qb, db, merge_m,
        cigar_out + static_cast<int64_t>(k) * cigar_cap, cigar_cap,
        &bq, &br);
    beg_qs_out[k] = bq;
    beg_rs_out[k] = br;
  }
}

}  // extern "C"
