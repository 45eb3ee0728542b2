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

// One step inside the plane (i >= 0, j >= 0, state not ST_DONE) from
// (i, j) in `state`: `t` is the flag byte there and `same` whether the
// symbols there are equal.  Returns the opcode and updates i, j and
// state, from selects without a branch, so that a step of the tiled walk
// costs its loads and a few logic operations.
PT_HD uint8_t walk_step_in(int32_t& i, int32_t& j, int32_t& state, int32_t t,
                           bool same) {
  const bool h = state == ST_H, e = state == ST_E, f = state == ST_F;
  const bool diag = (t & TRACE_DIAG) != 0, ins = (t & TRACE_INS) != 0;
  const bool del = (t & TRACE_DEL) != 0;
  const bool hd = h && diag, hi = h && !diag && ins;
  const bool hl = h && !diag && !ins && del;
  const bool stop = h && !diag && !ins && !del;
  const bool up = hd || hi || e, left = hd || hl || f;
  const bool to_e = (hi || e) && !(t & TRACE_DIAG_E);
  const bool to_f = (hl || f) && !(t & TRACE_DIAG_F);
  const uint8_t op = stop ? OP_NONE
                          : (hd ? (same ? OP_EQ : OP_X) : (up ? OP_I : OP_D));
  state = stop ? ST_DONE : (to_e ? ST_E : (to_f ? ST_F : ST_H));
  i -= up ? 1 : 0;
  j -= left ? 1 : 0;
  return op;
}

// One step from (i, j) in `state`.  `t` is the flag byte at (i, j) and
// `same` whether the symbols there are equal; both are read only while
// i >= 0 and j >= 0.  Returns the opcode and updates i, j and state.
PT_HD uint8_t walk_step(int32_t& i, int32_t& j, int32_t& state, int32_t t,
                        bool same, bool local, bool qb, bool db) {
  if (state == ST_DONE) return OP_NONE;
  if (i >= 0 && j >= 0) return walk_step_in(i, j, state, t, same);
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

// ---------------------------------------------------------------------------
// The tiled walk (trace_walk.cu: a warp a pair).  The walk reads its flags
// and letters from tiles of the plane staged in fast memory: TILE_R rows
// by TILE_C columns with their query and reference symbols.  The first
// tile ends at the walk's first cell (its rows the TILE_R up to the
// cell's, rounded down to a multiple of 4, its columns the cell's
// 16-column chunk and the TILE_C - 16 before it); the walk moves up and
// left by at most one a step, so when it leaves a tile it enters the tile
// above, to the left or above-left of it, and those three are copied
// while it walks the current one (four slots: the current tile and its
// three neighbours).  Tiles start on a multiple of 4 rows and of 16
// columns, so that their symbols and rows go in 16-byte copies where the
// plane allows.  Coordinates are clamped to the plane as walk_pair
// clamps them, which keeps them monotone.  The opcodes gather in a stage
// of WALK_STAGE bytes and leave together; the leading gaps after one
// index is exhausted leave as one run (walk_tail), and the rest of the
// row as zeros, so the opcode row need not arrive zero-filled.
//
// walk_pair_tiled is the one loop of both builds, over an IO that the
// kernel's warp or the host twin supplies:
//   bool leader()                     the lane that walks (the others copy)
//   int32_t share(int32_t v)          the leader's v, to every lane
//   void load(slot, Tile, bool all)   start copying a tile into a slot
//                                     (all: every lane copies, else the
//                                     leader does not) and close a group
//   void wait(int32_t n)              every group but the newest n copied
//                                     and visible
//   const int8_t* flags(slot); const int32_t* qs(slot); const int32_t*
//   rs(slot)                          a slot's flags (TILE_R x TILE_C, row
//                                     major) and symbols
//   uint8_t* stage()                  WALK_STAGE bytes, the leader's
//   void flush(k0, n)                 stage[0, n) to ops[k0, k0 + n)
//   void fill(k0, n, op)              op to ops[k0, k0 + n)
constexpr int32_t TILE_R = 32, TILE_C = 64;
constexpr int32_t WALK_STAGE = 128;
constexpr int32_t WALK_SLOTS = 4;

struct Tile {
  int32_t r0, c0;
};

PT_HD int32_t wmin(int32_t a, int32_t b) { return a < b ? a : b; }

PT_HD Tile first_tile(int32_t ci, int32_t cj) {
  return Tile{(ci - TILE_R + 4) & ~3, (cj & ~15) - (TILE_C - 16)};
}

// The neighbour `x` of a tile: 0 above, 1 left, 2 above-left.
PT_HD Tile tile_next(const Tile& t, int32_t x) {
  return Tile{t.r0 - (x != 1 ? TILE_R : 0), t.c0 - (x != 0 ? TILE_C : 0)};
}

// The neighbour that holds clamped cell (ci, cj), which left tile t.
PT_HD int32_t tile_exit(const Tile& t, int32_t ci, int32_t cj) {
  const bool up = ci < t.r0, left = cj < t.c0;
  return up && left ? 2 : (left ? 1 : 0);
}

struct WalkState {
  int32_t i, j, state, k;
};

enum WalkStop : int32_t { WALK_OUT = 0, WALK_FULL = 1, WALK_TAIL = 2,
                          WALK_END = 3 };

// The leader's steps in tile t (flags fl, symbols qs and rs): walk_step_in
// at each cell until the walk leaves the tile (WALK_OUT), fills the stage
// (WALK_FULL, n == WALK_STAGE), exhausts an index (WALK_TAIL) or ends
// (WALK_END: done, or L steps).  A step loads the flags of the three
// cells it can move to before it decides, so that the next step's flags
// are a select away rather than a load (reads outside the tile land on
// its edge and are never used); every stop is tested at once, the reason
// after.
PT_HD int32_t walk_tile(WalkState& w, const int8_t* fl, const int32_t* qs,
                        const int32_t* rs, const Tile& t, int32_t qp,
                        int32_t rp, int32_t L, uint8_t* stage, int32_t& n) {
  int32_t i = w.i, j = w.j, state = w.state, k = w.k, m = n;
  int32_t ci = wmin(i, qp - 1) - t.r0, cj = wmin(j, rp - 1) - t.c0;
  bool go = (state != ST_DONE) & (k < L) & (i >= 0) & (j >= 0) &
            (m < WALK_STAGE) & (ci >= 0) & (cj >= 0);
  int32_t f = go ? fl[ci * TILE_C + cj] : 0;
  while (go) {
    const int32_t ui = wmin(i - 1, qp - 1) - t.r0;
    const int32_t lj = wmin(j - 1, rp - 1) - t.c0;
    const int32_t ur = (ui > 0 ? ui : 0) * TILE_C, lc = lj > 0 ? lj : 0;
    const int32_t f_d = fl[ur + lc], f_u = fl[ur + cj];
    const int32_t f_l = fl[ci * TILE_C + lc];
    stage[m++] = walk_step_in(i, j, state, f, qs[ci] == rs[cj]);
    ++k;
    const int32_t ni = wmin(i, qp - 1) - t.r0, nj = wmin(j, rp - 1) - t.c0;
    f = ni == ci ? (nj == cj ? f : f_l) : (nj == cj ? f_u : f_d);
    ci = ni;
    cj = nj;
    go = (state != ST_DONE) & (k < L) & (i >= 0) & (j >= 0) &
         (m < WALK_STAGE) & (ci >= 0) & (cj >= 0);
  }
  w = WalkState{i, j, state, k};
  n = m;
  if (state == ST_DONE || k >= L) return WALK_END;
  if (i < 0 || j < 0) return WALK_TAIL;
  if (m >= WALK_STAGE) return WALK_FULL;
  return WALK_OUT;
}

// The leading gaps once an index is exhausted (walk_step's last two
// branches, step after step): a run of `op`, n long, cut at L.
PT_HD void walk_tail(WalkState& w, int32_t L, bool local, bool qb, bool db,
                     uint8_t& op, int32_t& n) {
  op = OP_NONE;
  n = 0;
  if (w.state != ST_DONE && w.k < L) {
    if (!local && w.i >= 0 && !db) {
      op = OP_I;
      n = w.i + 1;
    } else if (!local && w.j >= 0 && !qb) {
      op = OP_D;
      n = w.j + 1;
    }
    n = wmin(n, L - w.k);
    if (op == OP_I) w.i -= n;
    if (op == OP_D) w.j -= n;
    w.k += n;
  }
  w.state = ST_DONE;
}

// walk_pair over tiles: the same opcodes and begin cell, and the whole
// opcode row written (zeros after the walk).  (The kernel's IO is
// device-only; the pragma keeps nvcc from checking a host instance that
// nothing builds.)
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class IO>
PT_HD void walk_pair_tiled(IO& io, int32_t end_q, int32_t end_r, int32_t qp,
                           int32_t rp, int32_t L, bool local, bool qb,
                           bool db, int32_t& beg_q, int32_t& beg_r) {
  WalkState w{end_q, end_r, ST_H, 0};
  int32_t stop = WALK_TAIL;
  if (L > 0 && w.i >= 0 && w.j >= 0) {
    Tile t = first_tile(wmin(w.i, qp - 1), wmin(w.j, rp - 1));
    int32_t cur = 0;
    io.load(0, t, true);
    for (int32_t x = 0; x < 3; ++x) io.load(1 + x, tile_next(t, x), false);
    io.wait(3);
    int32_t n = 0;
    while (true) {
      if (io.leader())
        stop = walk_tile(w, io.flags(cur), io.qs(cur), io.rs(cur), t, qp, rp,
                         L, io.stage(), n);
      stop = io.share(stop);
      w.i = io.share(w.i);
      w.j = io.share(w.j);
      w.state = io.share(w.state);
      w.k = io.share(w.k);
      n = io.share(n);
      if (stop != WALK_OUT) {
        io.flush(w.k - n, n);
        n = 0;
        if (stop == WALK_FULL) continue;
        break;
      }
      // into the neighbour that holds the cell; its own three next
      const int32_t x = tile_exit(t, wmin(w.i, qp - 1), wmin(w.j, rp - 1));
      int32_t others[3], m = 0;
      for (int32_t s = 0; s < WALK_SLOTS; ++s)
        if (s != cur) others[m++] = s;
      io.wait(0);
      cur = others[x];
      t = tile_next(t, x);
      m = 0;
      for (int32_t s = 0; s < WALK_SLOTS; ++s)
        if (s != cur) io.load(s, tile_next(t, m++), false);
    }
  }
  if (stop == WALK_TAIL) {
    uint8_t op;
    int32_t n;
    const int32_t k0 = w.k;
    walk_tail(w, L, local, qb, db, op, n);
    io.fill(k0, n, op);
  }
  io.fill(w.k, L - w.k, OP_NONE);
  beg_q = w.i + 1;
  beg_r = w.j + 1;
}

}  // namespace ptwalk
