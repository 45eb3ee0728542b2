// Per-pair affine traceback walk, shared by the CUDA kernel
// (trace_walk.cu) and the host harness the CPU tests build with g++.
//
// Semantics are those of parasail_rs_tpu/ops/trace_walk.py::_walk_impl
// and golden/model.py::walk_trace: a three-state machine (H, E, F) that
// starts at the end cell and emits one opcode per step, backward.
//
//   H: stop on hflag 0 (the local ZERO cell; a non-local plane never has
//      one inside the path); else DIAG emits '=' or 'X' and moves to
//      (i-1, j-1), INS emits 'I', moves up and goes on in E unless the
//      cell's E value opened from H (DIAG_E), DEL emits 'D', moves left
//      and goes on in F unless DIAG_F.  Priority diag, ins, del.
//   E: emit 'I', move up, back to H on DIAG_E.
//   F: emit 'D', move left, back to H on DIAG_F.
//
// Once one index is exhausted, a non-local walk emits the other side's
// penalised leading gaps ('I' while i >= 0 unless db, 'D' while j >= 0
// unless qb); free ones are overhang.  The begin cell is the final
// (i + 1, j + 1).  '=' against 'X' compares the symbols the caller gives
// (raw bytes where it has them).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define PT_HD __host__ __device__ __forceinline__
#else
#define PT_HD inline
#endif

namespace ptwalk {

// step opcodes, as ops/trace_walk.py OP_*
constexpr uint8_t OP_NONE = 0, OP_EQ = 1, OP_X = 2, OP_I = 3, OP_D = 4;
enum State : int32_t { ST_H = 0, ST_E = 1, ST_F = 2, ST_DONE = 3 };

// constants.TRACE_*
constexpr int32_t TRACE_INS = 1, TRACE_DEL = 2, TRACE_DIAG = 4;
constexpr int32_t TRACE_DIAG_E = 8, TRACE_DIAG_F = 32;

// One step from (i, j) in `state`.  `t` is the flag byte at (i, j) and
// `same` whether the symbols there are equal; both are read only while
// i >= 0 and j >= 0.  Returns the opcode and updates i, j and state.
PT_HD uint8_t walk_step(int32_t& i, int32_t& j, int32_t& state, int32_t t,
                        bool same, bool local, bool qb, bool db) {
  if (state == ST_DONE) return OP_NONE;
  if (i >= 0 && j >= 0) {
    if (state == ST_H) {
      if (t & TRACE_DIAG) {
        --i;
        --j;
        return same ? OP_EQ : OP_X;
      }
      if (t & TRACE_INS) {
        --i;
        state = (t & TRACE_DIAG_E) ? ST_H : ST_E;
        return OP_I;
      }
      if (t & TRACE_DEL) {
        --j;
        state = (t & TRACE_DIAG_F) ? ST_H : ST_F;
        return OP_D;
      }
      state = ST_DONE;
      return OP_NONE;
    }
    if (state == ST_E) {
      --i;
      state = (t & TRACE_DIAG_E) ? ST_H : ST_E;
      return OP_I;
    }
    --j;
    state = (t & TRACE_DIAG_F) ? ST_H : ST_F;
    return OP_D;
  }
  if (!local && i >= 0 && !db) {
    --i;
    return OP_I;
  }
  if (!local && j >= 0 && !qb) {
    --j;
    return OP_D;
  }
  state = ST_DONE;
  return OP_NONE;
}

// Walk one pair back from (end_q, end_r).
//
//   trace:  the pair's cell (0, 0); cell (i, j) at trace[i * si + j * sj]
//   qsym, rsym: the pair's query and reference symbols
//   qp, rp: the plane's padded sizes: a cell past them (the end cell
//           (Qp, Rp) of a banded SG pair with no candidate) is read at
//           (min(i, qp - 1), min(j, rp - 1)), as the plain version reads it
//   L:      steps (Qp + Rp); ops[0 .. L) gets the opcodes, backward,
//           and must arrive zero-filled: the walk stops writing when it
//           ends
PT_HD void walk_pair(const int8_t* trace, int64_t si, int64_t sj,
                     const int32_t* qsym, const int32_t* rsym, int32_t end_q,
                     int32_t end_r, int32_t qp, int32_t rp, int32_t L,
                     bool local, bool qb, bool db, uint8_t* ops,
                     int32_t& beg_q, int32_t& beg_r) {
  int32_t i = end_q, j = end_r, state = ST_H;
  for (int32_t k = 0; k < L && state != ST_DONE; ++k) {
    int32_t t = 0;
    bool same = false;
    if (i >= 0 && j >= 0) {
      const int32_t ci = i < qp ? i : qp - 1, cj = j < rp ? j : rp - 1;
      t = trace[ci * si + cj * sj];
      same = state == ST_H && (t & TRACE_DIAG) && qsym[ci] == rsym[cj];
    }
    ops[k] = walk_step(i, j, state, t, same, local, qb, db);
  }
  beg_q = i + 1;
  beg_r = j + 1;
}

}  // namespace ptwalk
