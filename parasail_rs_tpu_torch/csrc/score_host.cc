// Host build of the kernels' per-pair code (score_cell.cuh, walk_step.cuh)
// for the CPU tests: the literal recurrence every card form is held to
// (score_batch_pair: score_pair, banded or not), one pair at a time, with
// the row scratch at stride 1, and the segment, tile and chunked kernels'
// lanes (segment_pair_host) and the short form's warp (short_pair_host),
// unbanded or masked to a band, stepped in a loop.
// Build with
//   g++ -O2 -std=c++17 -shared -fPIC -o libptscore_host.so score_host.cc
// and -DPT_HOST_BANDED for the twins of the masked forms
// (pt_short_banded_host, pt_chunked_banded_host), which double the build.
// The packed score form (segment16.cuh) steps on int16 halves here
// (pt_segment16_host).
#include <stdint.h>

#include <vector>

#include "score_cell.cuh"
#include "segment16.cuh"
#include "walk_step.cuh"

namespace {

template <int32_t kOut, bool kBanded = false>
void sweep(const int32_t* subs, const int32_t* qidx, const int32_t* ridx,
           const int32_t* qlen, const int32_t* rlen, int32_t* out,
           int8_t* trace, int B, int Bq, int Qp, int Rp, int A, int open,
           int ext, int mode, int free_bits, const ptscore::PlaneIO& io,
           int Bm, int bw = 0) {
  using O = ptscore::Out<kOut>;
  const int n = Rp > 0 ? Rp : 1;
  std::vector<int32_t> hrow(n), erow(n), pay(6 * n);
  for (int b = 0; b < B; ++b) {
    ptscore::PlaneIO p;               // pair b's view of io, stride 1
    if constexpr (O::stats) {
      p.mq = io.mq + (Bm == 1 ? 0 : (int64_t)b * Qp);
      p.pay = pay.data();
      p.pay_plane = n;
    }
    if constexpr (O::table) {
      p.table = io.table + (int64_t)b * Qp * Rp;
      p.tab_plane = io.tab_plane;
    }
    if constexpr (O::rowcol) {
      p.row = io.row + (int64_t)b * Rp;
      p.row_plane = io.row_plane;
      p.col = io.col + (int64_t)b * Qp;
      p.col_plane = io.col_plane;
    }
    const ptscore::PairResult r = ptscore::score_batch_pair<kOut, kBanded>(
        b, subs, subs, qidx, ridx, qlen, rlen, hrow.data(), erow.data(), 1,
        Bq, Qp, Rp, A, open, ext, mode, free_bits,
        O::trace ? trace + (int64_t)b * Qp * Rp : nullptr, Rp, 1, p, bw);
    out[b] = r.score;
    out[B + b] = r.end_query;
    out[2 * B + b] = r.end_ref;
    out[3 * B + b] = r.sat8;
    out[4 * B + b] = r.sat16;
    if constexpr (O::stats) {
      out[5 * B + b] = r.matches;
      out[6 * B + b] = r.similar;
      out[7 * B + b] = r.length;
    }
  }
}

}  // namespace

// score_pair's score class, unbanded (the literal recurrence, one pair
// at a time): the table or profile, the letters, lengths and penalties of
// pt_scan_short's; `out` is (5, B): score, end_query, end_ref, sat8,
// sat16.  No card kernel runs this form: every class is the short form's
// (pt_short_host below), the block kernel's or, banded, the ring's.
extern "C" int pt_score_host(const int32_t* subs, const int32_t* qidx,
                             const int32_t* ridx, const int32_t* qlen,
                             const int32_t* rlen, int32_t* out, int B, int Bq,
                             int Qp, int Rp, int A, int open, int ext,
                             int mode, int free_bits) {
  sweep<ptscore::OUT_SCORE>(subs, qidx, ridx, qlen, rlen, out, nullptr, B,
                            Bq, Qp, Rp, A, open, ext, mode, free_bits,
                            ptscore::PlaneIO(), 0);
  return 0;
}

// pt_score_host plus the flags of each in-sequence cell into `trace`, a
// (B, Qp, Rp) int8 plane the caller zero-fills: score_pair's trace
// class, unbanded, as pt_score_host.
extern "C" int pt_trace_host(const int32_t* subs, const int32_t* qidx,
                             const int32_t* ridx, const int32_t* qlen,
                             const int32_t* rlen, int32_t* out, int8_t* trace,
                             int B, int Bq, int Qp, int Rp, int A, int open,
                             int ext, int mode, int free_bits) {
  sweep<ptscore::OUT_TRACE>(subs, qidx, ridx, qlen, rlen, out, trace, B, Bq,
                            Qp, Rp, A, open, ext, mode, free_bits,
                            ptscore::PlaneIO(), 0);
  return 0;
}

// The stats, table and rowcol classes (out_class 2-6) of score_pair,
// unbanded, as pt_score_host: pt_scan_short's arguments minus the trace
// plane and the stream, with batch-major planes the caller zero-fills:
// `out` (8, B), `planes` (4, B, Qp, Rp), `row` (4, B, Rp), `col` (4, B,
// Qp).  Returns -1 for an unknown class.
extern "C" int pt_outputs_host(int out_class, const int32_t* subs,
                               const int32_t* qidx, const int32_t* mq,
                               const int32_t* ridx, const int32_t* qlen,
                               const int32_t* rlen, int32_t* out,
                               int32_t* planes, int32_t* row, int32_t* col,
                               int B, int Bq, int Bm, int Qp, int Rp, int A,
                               int open, int ext, int mode, int free_bits) {
  ptscore::PlaneIO io;
  io.mq = mq;
  io.table = planes;
  io.tab_plane = (int64_t)B * Qp * Rp;
  io.row = row;
  io.row_plane = (int64_t)B * Rp;
  io.col = col;
  io.col_plane = (int64_t)B * Qp;
#define PT_SWEEP(k)                                                        \
  sweep<k>(subs, qidx, ridx, qlen, rlen, out, nullptr, B, Bq, Qp, Rp, A,   \
           open, ext, mode, free_bits, io, Bm)
  switch (out_class) {
    case ptscore::OUT_STATS:
      PT_SWEEP(ptscore::OUT_STATS);
      return 0;
    case ptscore::OUT_TABLE:
      PT_SWEEP(ptscore::OUT_TABLE);
      return 0;
    case ptscore::OUT_STATS_TABLE:
      PT_SWEEP(ptscore::OUT_STATS_TABLE);
      return 0;
    case ptscore::OUT_ROWCOL:
      PT_SWEEP(ptscore::OUT_ROWCOL);
      return 0;
    case ptscore::OUT_STATS_ROWCOL:
      PT_SWEEP(ptscore::OUT_STATS_ROWCOL);
      return 0;
    default:
      return -1;
  }
#undef PT_SWEEP
}

// score_pair's banded forms of every class (out_class 0-6; the score form
// sweeps the band alone, the others every cell, masked): pt_outputs_host's
// arguments plus a (B, Qp, Rp) int8 flag plane `trace` for the trace
// class and `bandwidth`.  The card's masked forms (pt_short_banded_host,
// pt_chunked_banded_host below) and the ring are held to it.  `out` is
// (8, B).  Returns -1 for an unknown class.
extern "C" int pt_banded_host(
    int out_class, const int32_t* subs, const int32_t* qidx,
    const int32_t* mq, const int32_t* ridx, const int32_t* qlen,
    const int32_t* rlen, int32_t* out, int8_t* trace, int32_t* planes,
    int32_t* row, int32_t* col, int B, int Bq, int Bm, int Qp, int Rp, int A,
    int open, int ext, int mode, int free_bits, int bandwidth) {
  ptscore::PlaneIO io;
  io.mq = mq;
  io.table = planes;
  io.tab_plane = (int64_t)B * Qp * Rp;
  io.row = row;
  io.row_plane = (int64_t)B * Rp;
  io.col = col;
  io.col_plane = (int64_t)B * Qp;
  const int bw = ptscore::clamp_band(bandwidth, Qp, Rp);
#define PT_SWEEP(k)                                                         \
  sweep<k, true>(subs, qidx, ridx, qlen, rlen, out, trace, B, Bq, Qp, Rp, A, \
                 open, ext, mode, free_bits, io, Bm, bw)
  switch (out_class) {
    case ptscore::OUT_SCORE:
      PT_SWEEP(ptscore::OUT_SCORE);
      return 0;
    case ptscore::OUT_TRACE:
      PT_SWEEP(ptscore::OUT_TRACE);
      return 0;
    case ptscore::OUT_STATS:
      PT_SWEEP(ptscore::OUT_STATS);
      return 0;
    case ptscore::OUT_TABLE:
      PT_SWEEP(ptscore::OUT_TABLE);
      return 0;
    case ptscore::OUT_STATS_TABLE:
      PT_SWEEP(ptscore::OUT_STATS_TABLE);
      return 0;
    case ptscore::OUT_ROWCOL:
      PT_SWEEP(ptscore::OUT_ROWCOL);
      return 0;
    case ptscore::OUT_STATS_ROWCOL:
      PT_SWEEP(ptscore::OUT_STATS_ROWCOL);
      return 0;
    default:
      return -1;
  }
#undef PT_SWEEP
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
                      rsym + (int64_t)b * Rp, end_q[b], end_r[b], Qp, Rp,
                      L, local != 0, qb != 0, db != 0, ops + (int64_t)b * L,
                      beg[b], beg[B + b]);
  }
  return 0;
}

namespace {

// segment_pair_host of class kOut with `rows` rows a lane, one of the
// kernel's forms (the caller checks seg_rows_compiled); kBanded: its
// masked one-shot form.
template <int32_t kOut, bool kBanded = false>
ptscore::PairResult pair_host(int rows, const int32_t* subs,
                              const int32_t* q, const int32_t* mq,
                              const int32_t* ridx, int rseg,
                              const ptscore::SegPair& p, int mode,
                              int32_t* bottom, int32_t* st_h, int32_t* st_f,
                              int32_t* st_pay, int64_t pay_plane,
                              int32_t* acc, int8_t* trace, int warps,
                              int cluster, int32_t* down,
                              const int32_t* t_in, int32_t* t_out,
                              const ptscore::SegPlanes& pl) {
#define PT_ROWS(r)                                                          \
  return ptscore::segment_pair_host<kOut, r, kBanded>(                      \
      subs, q, mq, ridx, rseg, p, mode, bottom, st_h, st_f, st_pay,         \
      pay_plane, acc, trace, warps, cluster, down, t_in, t_out, pl)
  if (rows == 2) PT_ROWS(2);
  if (rows == 4) PT_ROWS(4);
  if constexpr (ptscore::seg_wide_class(kOut)) PT_ROWS(8);
#undef PT_ROWS
  return ptscore::PairResult{};
}

template <bool kBanded = false, typename... Args>
ptscore::PairResult class_host(int out_class, Args... args) {
  using namespace ptscore;
  switch (out_class) {
    case OUT_SCORE: return pair_host<OUT_SCORE, kBanded>(args...);
    case OUT_TRACE: return pair_host<OUT_TRACE, kBanded>(args...);
    case OUT_STATS: return pair_host<OUT_STATS, kBanded>(args...);
    case OUT_TABLE: return pair_host<OUT_TABLE, kBanded>(args...);
    case OUT_STATS_TABLE: return pair_host<OUT_STATS_TABLE, kBanded>(args...);
    case OUT_ROWCOL: return pair_host<OUT_ROWCOL, kBanded>(args...);
    default: return pair_host<OUT_STATS_ROWCOL, kBanded>(args...);
  }
}

// Are (rows, warps, cluster) a form the kernel compiles and launches?
bool form_ok(int out_class, int rows, int warps, int cluster) {
  return ptscore::seg_rows_compiled(out_class, rows) && warps >= 1 &&
         warps <= ptscore::SEG_MAX_WARPS && cluster >= 1 &&
         cluster <= ptscore::SEG_MAX_CLUSTER;
}

void put_result(const ptscore::PairResult& r, int32_t* out, int B, int b) {
  out[b] = r.score;
  out[B + b] = r.end_query;
  out[2 * B + b] = r.end_ref;
  out[3 * B + b] = r.sat8;
  out[4 * B + b] = r.sat16;
  out[5 * B + b] = r.matches;
  out[6 * B + b] = r.similar;
  out[7 * B + b] = r.length;
}

}  // namespace

// One segment of the segment form (pt_scan_segment's arguments minus the
// scratch and the stream, same layouts): out_class 0 score, 1 trace,
// 2 stats; `st_h` / `st_f` (B, Qp), `st_pay` (6, B, Qp) and `acc` (B, 8)
// are read (if resume) and updated in place; `out` is (8, B); `trace`
// (B, Qp, Rseg) arrives zero-filled; `rows` rows a lane, `warps` warps a
// block and `cluster` blocks a pair, as the kernel would take them.
// Returns -1 for another class or a form the kernel has not.
extern "C" int pt_segment_host(int out_class, const int32_t* subs,
                               const int32_t* qidx, const int32_t* mq,
                               const int32_t* ridx, const int32_t* qlen,
                               const int32_t* rlen, int32_t* st_h,
                               int32_t* st_f, int32_t* st_pay, int32_t* acc,
                               int32_t* out, int8_t* trace, int B, int Bq,
                               int Bm, int Qp, int Rseg, int A, int open,
                               int ext, int mode, int free_bits, int off,
                               int resume, int warps, int rows, int cluster) {
  if (out_class > ptscore::OUT_STATS || out_class < 0 ||
      !form_ok(out_class, rows, warps, cluster))
    return -1;
  std::vector<int32_t> bottom(8 * (Rseg > 0 ? Rseg : 1));
  const int64_t pay_plane = (int64_t)B * Qp;
  for (int b = 0; b < B; ++b) {
    const ptscore::SegPair p = ptscore::seg_pair(
        qlen[b], rlen[b], Qp, off, Rseg, open, ext, mode, free_bits,
        resume != 0, A);
    const int64_t bq = Bq == 1 ? 0 : b;
    put_result(
        class_host(out_class, rows, qidx ? subs : subs + bq * Qp * A,
                   qidx ? qidx + bq * Qp : nullptr,
                   mq ? mq + (Bm == 1 ? 0 : (int64_t)b * Qp) : nullptr,
                   ridx + (int64_t)b * Rseg, Rseg, p, mode, bottom.data(),
                   st_h + (int64_t)b * Qp, st_f + (int64_t)b * Qp,
                   st_pay ? st_pay + (int64_t)b * Qp : nullptr, pay_plane,
                   acc + (int64_t)b * 8,
                   trace ? trace + (int64_t)b * Qp * Rseg : nullptr, warps,
                   cluster, (int32_t*)nullptr, (const int32_t*)nullptr,
                   (int32_t*)nullptr, ptscore::SegPlanes()),
        out, B, b);
  }
  return 0;
}

// One tile of the tile form (pt_scan_rowseg's arguments minus the stream,
// same layouts): rows [r0, r0 + qc) by columns [off, off + C).  `down`
// (B, 2, C), or (B, 8, C) for stats, is read above the tile and left
// holding its last row; `st_h` / `st_f` (B, qc), `st_pay` (6, B, qc) and
// `acc` (B, 8) are updated in place; `out` is (8, B); `trace` (B, qc, C)
// arrives zero-filled; `t_in` / `t_out` are (B, 4); rows, warps, cluster
// as pt_segment_host.  Returns -1 for another class or form.
extern "C" int pt_rowseg_host(int out_class, const int32_t* subs,
                              const int32_t* qidx, const int32_t* mq,
                              const int32_t* ridx, const int32_t* qlen,
                              const int32_t* rlen, int32_t* down,
                              int32_t* st_h, int32_t* st_f, int32_t* st_pay,
                              int32_t* acc, int32_t* out, int8_t* trace,
                              const int32_t* t_in, int32_t* t_out, int B,
                              int Bq, int Bm, int Qp, int C, int A, int open,
                              int ext, int mode, int free_bits, int off,
                              int r0, int qc, int warps, int rows,
                              int cluster) {
  if (out_class > ptscore::OUT_STATS || out_class < 0 ||
      !form_ok(out_class, rows, warps, cluster))
    return -1;
  const int64_t pay_plane = (int64_t)B * qc;
  const int down_rows = out_class == ptscore::OUT_STATS ? 8 : 2;
  std::vector<int32_t> bottom((int64_t)down_rows * C);
  for (int b = 0; b < B; ++b) {
    const ptscore::SegPair p = ptscore::tile_pair(
        qlen[b], rlen[b], Qp, r0, qc, off, C, open, ext, mode, free_bits, A);
    const int64_t bq = Bq == 1 ? 0 : b;
    put_result(
        class_host(out_class, rows, qidx ? subs : subs + bq * Qp * A,
                   qidx ? qidx + bq * Qp : nullptr,
                   mq ? mq + (Bm == 1 ? 0 : (int64_t)b * Qp) : nullptr,
                   ridx + (int64_t)b * C, C, p, mode, bottom.data(),
                   st_h + (int64_t)b * qc, st_f + (int64_t)b * qc,
                   st_pay ? st_pay + (int64_t)b * qc : nullptr, pay_plane,
                   acc + (int64_t)b * 8,
                   trace ? trace + (int64_t)b * qc * C : nullptr, warps,
                   cluster, down + (int64_t)b * down_rows * C,
                   t_in + (int64_t)b * 4, t_out + (int64_t)b * 4,
                   ptscore::SegPlanes()),
        out, B, b);
  }
  return 0;
}

namespace {

// The chunked sweep's pairs on the host (pt_chunked_host's arguments),
// kBanded: masked to the band of half-width bw.
template <bool kBanded>
int chunked_host(int out_class, const int32_t* subs, const int32_t* qidx,
                 const int32_t* mq, const int32_t* ridx, const int32_t* qlen,
                 const int32_t* rlen, int32_t* out, int8_t* trace,
                 int32_t* tab, int32_t* rows, int32_t* cols, int B, int Bq,
                 int Bm, int Qp, int Rp, int A, int open, int ext, int mode,
                 int free_bits, int bw, int warps, int lane_rows,
                 int cluster) {
  if (out_class < ptscore::OUT_SCORE ||
      out_class > ptscore::OUT_STATS_ROWCOL ||
      !form_ok(out_class, lane_rows, warps, cluster))
    return -1;
  const int n = Rp > 0 ? Rp : 1;
  std::vector<int32_t> bottom(8 * n), st_h(Qp), st_f(Qp), st_pay(6 * Qp),
      acc(8);
  for (int b = 0; b < B; ++b) {
    const ptscore::SegPair p = ptscore::with_band(
        ptscore::seg_pair(qlen[b], rlen[b], Qp, 0, Rp, open, ext, mode,
                          free_bits, false, A),
        ptscore::clamp_band(bw, Qp, Rp), Rp);
    const int64_t bq = Bq == 1 ? 0 : b;
    ptscore::SegPlanes pl;
    if (tab) {
      pl.table = tab + (int64_t)b * Rp * Qp;
      pl.tab_plane = (int64_t)B * Rp * Qp;
    }
    if (rows) {
      pl.row = rows + (int64_t)b * Rp;
      pl.row_plane = (int64_t)B * Rp;
      pl.col = cols + (int64_t)b * Qp;
      pl.col_plane = (int64_t)B * Qp;
    }
    put_result(
        class_host<kBanded>(
            out_class, lane_rows, qidx ? subs : subs + bq * Qp * A,
            qidx ? qidx + bq * Qp : nullptr,
            mq ? mq + (Bm == 1 ? 0 : (int64_t)b * Qp) : nullptr,
            ridx + (int64_t)b * Rp, Rp, p, mode, bottom.data(), st_h.data(),
            st_f.data(), st_pay.data(), (int64_t)Qp, acc.data(),
            trace ? trace + (int64_t)b * Qp * Rp : nullptr, warps, cluster,
            (int32_t*)nullptr, (const int32_t*)nullptr, (int32_t*)nullptr,
            pl),
        out, B, b);
  }
  return 0;
}

}  // namespace

// The chunked sweep, every class: what score_chunked launches on the card
// (pt_scan_chunked's four plane forms, pt_scan_segment's score, stats and
// trace forms as one segment of Rp columns from column 0), with their
// layouts, minus the scratch and the stream; rows, warps, cluster as
// pt_segment_host.  `out` is (8, B); `trace` (B, Qp, Rp), `tab`
// (4, B, Rp, Qp), `rows` (4, B, Rp) and `cols` (4, B, Qp) arrive
// zero-filled (planes beyond the class's are left alone).  Returns -1 for
// an unknown class or form.
extern "C" int pt_chunked_host(int out_class, const int32_t* subs,
                               const int32_t* qidx, const int32_t* mq,
                               const int32_t* ridx, const int32_t* qlen,
                               const int32_t* rlen, int32_t* out,
                               int8_t* trace, int32_t* tab, int32_t* rows,
                               int32_t* cols, int B, int Bq, int Bm, int Qp,
                               int Rp, int A, int open, int ext, int mode,
                               int free_bits, int warps, int lane_rows,
                               int cluster) {
  return chunked_host<false>(out_class, subs, qidx, mq, ridx, qlen, rlen, out,
                             trace, tab, rows, cols, B, Bq, Bm, Qp, Rp, A,
                             open, ext, mode, free_bits, 0, warps, lane_rows,
                             cluster);
}

#if defined(PT_HOST_BANDED)
// The block kernel's masked one-shot form (pt_scan_chunked_banded on the
// card), every class: pt_chunked_host's arguments with `bandwidth` before
// the form's.
extern "C" int pt_chunked_banded_host(
    int out_class, const int32_t* subs, const int32_t* qidx,
    const int32_t* mq, const int32_t* ridx, const int32_t* qlen,
    const int32_t* rlen, int32_t* out, int8_t* trace, int32_t* tab,
    int32_t* rows, int32_t* cols, int B, int Bq, int Bm, int Qp, int Rp,
    int A, int open, int ext, int mode, int free_bits, int bandwidth,
    int warps, int lane_rows, int cluster) {
  return chunked_host<true>(out_class, subs, qidx, mq, ridx, qlen, rlen, out,
                            trace, tab, rows, cols, B, Bq, Bm, Qp, Rp, A,
                            open, ext, mode, free_bits, bandwidth, warps,
                            lane_rows, cluster);
}
#endif

// The block kernel's launcher's rule (score_cell.cuh, seg_plan), as
// pt_block_plan on the card: rows a lane, warps a block and blocks a pair
// to plan[0..2].
extern "C" int pt_block_plan_host(int out_class, int B, int Qs, int ncols,
                                  int A, int profile, int warps, int rows,
                                  int cluster, int32_t* plan) {
  const ptscore::SegPlan p = ptscore::seg_plan(
      out_class, B, Qs, ncols, A, profile != 0, warps, rows, cluster);
  plan[0] = p.rows;
  plan[1] = p.warps;
  plan[2] = p.cluster;
  return 0;
}

namespace {

template <bool kLocal, bool kPair>
int units16_host(const ptseg16::Seg16Args& a, int warps, int rows,
                 int cluster) {
  std::vector<uint32_t> bottom;
  for (int32_t u = 0; u < a.U; ++u) {
    if (rows == 2)
      ptseg16::segment16_unit_host<2, kLocal, kPair>(a, u, warps, cluster,
                                                     bottom);
    else if (rows == 4)
      ptseg16::segment16_unit_host<4, kLocal, kPair>(a, u, warps, cluster,
                                                     bottom);
    else
      ptseg16::segment16_unit_host<8, kLocal, kPair>(a, u, warps, cluster,
                                                     bottom);
  }
  return 0;
}

}  // namespace

// One segment of the packed score form (pt_scan_segment16's arguments
// minus the scratch and the stream, same layouts), its units' lanes on
// int16 halves: `out` (6, B) and the state (st_h, st_f, acc, over) of the
// units' pairs are written as the kernel writes them; rows, warps and
// cluster as the kernel would take them for the units.  Returns -1 for a
// form the kernel has not, a profile of several queries, or penalties and
// scores without a band.
extern "C" int pt_segment16_host(const int32_t* subs, const int32_t* qidx,
                                 const int32_t* ridx, const int32_t* qlen,
                                 const int32_t* rlen, const int32_t* units,
                                 int32_t* st_h, int32_t* st_f, int32_t* acc,
                                 int32_t* over, int32_t* out, int U, int B,
                                 int Bq, int Qp, int Rseg, int A, int open,
                                 int ext, int mode, int free_bits, int off,
                                 int resume, int bound, int warps, int rows,
                                 int cluster) {
  const bool profile = qidx == nullptr;
  if (!(rows == 2 || rows == 4 || rows == 8) || warps < 1 ||
      warps > ptscore::SEG_MAX_WARPS || cluster < 1 ||
      cluster > ptscore::SEG_MAX_CLUSTER || (profile && Bq != 1) ||
      !ptseg16::seg16_usable(open, ext, bound))
    return -1;
  const ptseg16::Seg16Args a{subs, qidx, ridx, qlen, rlen, units, nullptr,
                             st_h, st_f, acc, over, out, U, B, Bq, Qp, Rseg,
                             A, open, ext, mode, free_bits, off, resume,
                             bound, cluster};
  const bool local = mode == ptscore::MODE_SW;
  if (ptseg16::seg16_pair_table(profile, A))
    return local ? units16_host<true, true>(a, warps, rows, cluster)
                 : units16_host<false, true>(a, warps, rows, cluster);
  return local ? units16_host<true, false>(a, warps, rows, cluster)
               : units16_host<false, false>(a, warps, rows, cluster);
}

// The packed form's launch rule (segment16.cuh, seg16_plan), as
// pt_segment16_plan on the card.
extern "C" int pt_segment16_plan_host(int U, int Qs, int ncols, int A,
                                      int profile, int warps, int rows,
                                      int cluster, int32_t* plan) {
  const ptscore::SegPlan p = ptseg16::seg16_plan(U, Qs, ncols, A,
                                                 profile != 0, warps, rows,
                                                 cluster);
  plan[0] = p.rows;
  plan[1] = p.warps;
  plan[2] = p.cluster;
  return 0;
}

namespace {

// short_pair_host of class kOut at kR rows a lane (kBanded: its masked
// form), each pair's payloads in `layout` (the stats classes) with the
// ops of its padded shape.
template <int32_t kOut, int32_t kR, bool kBanded>
ptscore::PairResult short_host(int layout, const int32_t* subs,
                               const int32_t* q, const int32_t* mq,
                               const int32_t* ridx, const ptscore::SegPair& p,
                               int mode, int8_t* trace, int64_t rstride,
                               bool wide, int Rp,
                               const ptscore::SegPlanes& pl) {
  using ptscore::short_pair_host;
  if constexpr (!ptscore::Out<kOut>::stats) {
    return short_pair_host<kOut, kR, kBanded>(subs, q, mq, ridx, p, mode,
                                              trace, rstride, wide,
                                              ptscore::NoPayOps(), pl);
  } else if (layout == ptscore::SHORT_PACKED) {
    return short_pair_host<kOut, kR, kBanded>(subs, q, mq, ridx, p, mode,
                                              trace, rstride, wide,
                                              ptscore::pack_ops(p.qp, Rp),
                                              pl);
  } else {
    return short_pair_host<kOut, kR, kBanded>(subs, q, mq, ridx, p, mode,
                                              trace, rstride, wide,
                                              ptscore::pack2_ops(p.qp), pl);
  }
}

template <int32_t kOut, bool kBanded>
ptscore::PairResult short_rows_host(int rows, int layout,
                                    const int32_t* subs, const int32_t* q,
                                    const int32_t* mq, const int32_t* ridx,
                                    const ptscore::SegPair& p, int mode,
                                    int8_t* trace, int Rp,
                                    const ptscore::SegPlanes& pl) {
  const bool wide = ptscore::short_wide(Rp);
#define PT_ROWS(r)                                                       \
  return short_host<kOut, r, kBanded>(layout, subs, q, mq, ridx, p, mode, \
                                      trace, Rp, wide, Rp, pl)
  switch (rows) {
    case 4:
      PT_ROWS(4);
    case 5:
      PT_ROWS(5);
    case 6:
      PT_ROWS(6);
    default:
      PT_ROWS(8);
  }
#undef PT_ROWS
}

// The short form's pairs on the host (pt_short_host's arguments), kBanded:
// masked to the band of half-width bw.
template <bool kBanded>
int short_batch_host(int out_class, const int32_t* subs, const int32_t* qidx,
                     const int32_t* mq, const int32_t* ridx,
                     const int32_t* qlen, const int32_t* rlen, int32_t* out,
                     int8_t* trace, int32_t* tab, int32_t* row, int32_t* col,
                     int B, int Bq, int Bm, int Qp, int Rp, int A, int open,
                     int ext, int mode, int free_bits, int bw, int rows,
                     int layout) {
  const bool stats = ptscore::seg_stats_class(out_class);
  if (out_class < ptscore::OUT_SCORE ||
      out_class > ptscore::OUT_STATS_ROWCOL ||
      (rows < 4 || rows > 8 || rows == 7) ||
      (stats && layout != ptscore::SHORT_PACKED &&
       layout != ptscore::SHORT_PACKED2))
    return -1;
  for (int b = 0; b < B; ++b) {
    const ptscore::SegPair p = ptscore::with_band(
        ptscore::seg_pair(qlen[b], rlen[b], Qp, 0, Rp, open, ext, mode,
                          free_bits, false, A),
        ptscore::clamp_band(bw, Qp, Rp), Rp);
    const int64_t bq = Bq == 1 ? 0 : b;
    const int32_t* s = qidx ? subs : subs + bq * Qp * A;
    const int32_t* q = qidx ? qidx + bq * Qp : nullptr;
    const int32_t* m = mq ? mq + (Bm == 1 ? 0 : (int64_t)b * Qp) : nullptr;
    int8_t* tr = trace ? trace + (int64_t)b * Qp * Rp : nullptr;
    const int32_t* r = ridx + (int64_t)b * Rp;
    ptscore::SegPlanes pl;             // pair b's, as the kernel sets them
    if (tab) {
      pl.table = tab + (int64_t)b * Rp * Qp;
      pl.tab_plane = (int64_t)B * Rp * Qp;
    }
    if (row) {
      pl.row = row + (int64_t)b * Rp;
      pl.row_plane = (int64_t)B * Rp;
      pl.col = col + (int64_t)b * Qp;
      pl.col_plane = (int64_t)B * Qp;
    }
#define PT_SHORT(k) \
  short_rows_host<k, kBanded>(rows, layout, s, q, m, r, p, mode, tr, Rp, pl)
    ptscore::PairResult res;
    switch (out_class) {
      case ptscore::OUT_SCORE:
        res = PT_SHORT(ptscore::OUT_SCORE);
        break;
      case ptscore::OUT_TRACE:
        res = PT_SHORT(ptscore::OUT_TRACE);
        break;
      case ptscore::OUT_STATS:
        res = PT_SHORT(ptscore::OUT_STATS);
        break;
      case ptscore::OUT_TABLE:
        res = PT_SHORT(ptscore::OUT_TABLE);
        break;
      case ptscore::OUT_STATS_TABLE:
        res = PT_SHORT(ptscore::OUT_STATS_TABLE);
        break;
      case ptscore::OUT_ROWCOL:
        res = PT_SHORT(ptscore::OUT_ROWCOL);
        break;
      default:
        res = PT_SHORT(ptscore::OUT_STATS_ROWCOL);
        break;
    }
#undef PT_SHORT
    put_result(res, out, B, b);
  }
  return 0;
}

}  // namespace

// The short form (pt_scan_short's arguments minus the stream, same
// layouts): every class (out_class 0-6); `out` is (8, B); `trace`
// (B, Qp, Rp), `tab` (1 or 4, B, Rp, Qp), `row` (1 or 4, B, Rp) and `col`
// (1 or 4, B, Qp) arrive zero-filled (null where the class has none);
// `rows` rows a lane (4, 5, 6 or 8) and the stats classes' `layout` (1
// packed, 2 [m | s] + l), as the kernel would take them.  Returns -1 for
// another class, rows or layout.
extern "C" int pt_short_host(int out_class, const int32_t* subs,
                             const int32_t* qidx, const int32_t* mq,
                             const int32_t* ridx, const int32_t* qlen,
                             const int32_t* rlen, int32_t* out, int8_t* trace,
                             int32_t* tab, int32_t* row, int32_t* col, int B,
                             int Bq, int Bm, int Qp, int Rp, int A, int open,
                             int ext, int mode, int free_bits, int rows,
                             int layout) {
  return short_batch_host<false>(out_class, subs, qidx, mq, ridx, qlen, rlen,
                                 out, trace, tab, row, col, B, Bq, Bm, Qp, Rp,
                                 A, open, ext, mode, free_bits, 0, rows,
                                 layout);
}

#if defined(PT_HOST_BANDED)
// The short form's masked form (pt_scan_short_banded on the card):
// pt_short_host's arguments with `bandwidth` before the form's.
extern "C" int pt_short_banded_host(
    int out_class, const int32_t* subs, const int32_t* qidx,
    const int32_t* mq, const int32_t* ridx, const int32_t* qlen,
    const int32_t* rlen, int32_t* out, int8_t* trace, int32_t* tab,
    int32_t* row, int32_t* col, int B, int Bq, int Bm, int Qp, int Rp, int A,
    int open, int ext, int mode, int free_bits, int bandwidth, int rows,
    int layout) {
  return short_batch_host<true>(out_class, subs, qidx, mq, ridx, qlen, rlen,
                                out, trace, tab, row, col, B, Bq, Bm, Qp, Rp,
                                A, open, ext, mode, free_bits, bandwidth,
                                rows, layout);
}
#endif

// The short form's launcher's rule (score_cell.cuh, short_plan), as
// pt_short_plan on the card: rows a lane (0: the batch is the block
// kernel's), pairs a block and the stats classes' layout to plan[0..2].
extern "C" int pt_short_plan_host(int out_class, int B, int Bq, int Qp,
                                  int Rp, int A, int profile,
                                  int32_t* plan) {
  const ptscore::ShortPlan p = ptscore::short_plan(
      out_class, B, Qp, Rp, A, profile != 0, profile != 0 && Bq != 1);
  plan[0] = p.rows;
  plan[1] = p.pairs;
  plan[2] = p.layout;
  return 0;
}

namespace {

template <class Sc>
ptscore::PairResult band_rows_host(int rows, int G, const Sc& sc,
                                   const int32_t* q, const int32_t* ridx,
                                   const ptscore::BandPair& bp, int mode) {
  switch (rows) {
    case 4:
      return ptscore::band_pair_host<4>(G, sc, q, ridx, bp, mode);
    case 5:
      return ptscore::band_pair_host<5>(G, sc, q, ridx, bp, mode);
    case 6:
      return ptscore::band_pair_host<6>(G, sc, q, ridx, bp, mode);
    default:
      return ptscore::band_pair_host<8>(G, sc, q, ridx, bp, mode);
  }
}

}  // namespace

// The banded warp form (pt_scan_band_ring's arguments minus the stream,
// same layouts): the ring's lanes stepped in a loop, `lanes` G and `rows`
// kR as the kernel would take them (0 and 0: the rule's, band_plan);
// `out` is (5, B).  Returns -1 where the kernel's launcher refuses: a
// form it has not, one that does not reach the band, a table too large.
extern "C" int pt_band_host(const int32_t* subs, const int32_t* qidx,
                            const int32_t* ridx, const int32_t* qlen,
                            const int32_t* rlen, int32_t* out, int B, int Bq,
                            int Qp, int Rp, int A, int open, int ext,
                            int mode, int free_bits, int bandwidth, int lanes,
                            int rows) {
  const int bw = ptscore::band_eff(bandwidth, Qp, Rp);
  const bool profile = qidx == nullptr;
  if (lanes == 0 && rows == 0) {
    const ptscore::BandPlan plan =
        ptscore::band_plan(B, Qp, Rp, bandwidth, A, profile);
    lanes = plan.lanes;
    rows = plan.rows;
  }
  if (!ptscore::band_form(lanes, rows) ||
      2 * bw >= ptscore::band_reach(lanes, rows) ||
      (!profile && (int64_t)(A + 1) * (A + 1) * 4 > ptscore::BAND_TABLE_BYTES))
    return -1;
  // the table as a block stages it: (A + 1)^2, a zero row and column
  std::vector<int32_t> table(profile ? 0 : (A + 1) * (A + 1));
  for (int32_t k = 0; k < (int32_t)table.size(); ++k)
    table[k] = ptscore::seg_table_at(subs, A, k);
  for (int b = 0; b < B; ++b) {
    const int64_t bq = Bq == 1 ? 0 : b;
    const int32_t* q = qidx ? qidx + bq * Qp : nullptr;
    const ptscore::BandPair bp = ptscore::band_pair(
        qlen[b], ptscore::imin(rlen[b], Rp), Qp, Rp, open, ext, mode,
        free_bits, A, bw, rows);
    const int32_t* r = ridx + (int64_t)b * Rp;
    const ptscore::PairResult res =
        profile ? band_rows_host(rows, lanes,
                                 ptscore::BandScores<true>{subs + bq * Qp * A,
                                                           A},
                                 q, r, bp, mode)
                : band_rows_host(rows, lanes,
                                 ptscore::BandScores<false>{table.data(), A},
                                 q, r, bp, mode);
    out[b] = res.score;
    out[B + b] = res.end_query;
    out[2 * B + b] = res.end_ref;
    out[3 * B + b] = res.sat8;
    out[4 * B + b] = res.sat16;
  }
  return 0;
}

// The banded warp form's rule (score_cell.cuh, band_plan), as pt_band_plan
// on the card: lanes a pair and rows a block to plan[0..1] (0 and 0: the
// one-thread form's batch).
extern "C" int pt_band_plan_host(int B, int Qp, int Rp, int bandwidth, int A,
                                 int profile, int32_t* plan) {
  const ptscore::BandPlan p =
      ptscore::band_plan(B, Qp, Rp, bandwidth, A, profile != 0);
  plan[0] = p.lanes;
  plan[1] = p.rows;
  return 0;
}

namespace {

// The IO of walk_pair_tiled on the host: the slots in vectors, copied
// whole when loaded (cells outside the plane poisoned, so a read the walk
// should not make shows), the stage flushed into the opcode row.
struct HostWalkIO {
  const int8_t* plane;
  int64_t si, sj;
  const int32_t* qsym;
  const int32_t* rsym;
  int32_t qp, rp;
  uint8_t* ops;
  std::vector<int8_t> fl[ptwalk::WALK_SLOTS];
  std::vector<int32_t> q[ptwalk::WALK_SLOTS], r[ptwalk::WALK_SLOTS];
  uint8_t st[ptwalk::WALK_STAGE];

  bool leader() const { return true; }
  int32_t share(int32_t v) const { return v; }
  const int8_t* flags(int32_t s) const { return fl[s].data(); }
  const int32_t* qs(int32_t s) const { return q[s].data(); }
  const int32_t* rs(int32_t s) const { return r[s].data(); }
  uint8_t* stage() { return st; }
  void load(int32_t s, const ptwalk::Tile& t, bool) {
    using ptwalk::TILE_C;
    using ptwalk::TILE_R;
    fl[s].assign(TILE_R * TILE_C, (int8_t)0x7f);
    q[s].assign(TILE_R, -7);
    r[s].assign(TILE_C, -9);
    for (int32_t x = 0; x < TILE_R; ++x) {
      const int32_t i = t.r0 + x;
      if (i < 0 || i >= qp) continue;
      q[s][x] = qsym[i];
      for (int32_t y = 0; y < TILE_C; ++y) {
        const int32_t j = t.c0 + y;
        if (j >= 0 && j < rp) fl[s][x * TILE_C + y] = plane[i * si + j * sj];
      }
    }
    for (int32_t y = 0; y < TILE_C; ++y) {
      const int32_t j = t.c0 + y;
      if (j >= 0 && j < rp) r[s][y] = rsym[j];
    }
  }
  void wait(int32_t) const {}
  void flush(int32_t k0, int32_t n) {
    for (int32_t x = 0; x < n; ++x) ops[k0 + x] = st[x];
  }
  void fill(int32_t k0, int32_t n, uint8_t op) {
    for (int32_t x = 0; x < n; ++x) ops[k0 + x] = op;
  }
};

}  // namespace

// The tiled walk (pt_trace_walk's arguments minus the stream): the
// kernel's loop, walk_pair_tiled, over tiles copied on the host from a
// plane of any strides (in bytes).  `ops` (B, Qp + Rp) is written whole.
extern "C" int pt_walk_tiled_host(const int8_t* trace, long long sb,
                                  long long si, long long sj,
                                  const int32_t* qsym, const int32_t* rsym,
                                  const int32_t* end_q, const int32_t* end_r,
                                  uint8_t* ops, int32_t* beg, int B, int Bq,
                                  int Qp, int Rp, int local, int qb, int db) {
  const int32_t L = Qp + Rp;
  for (int b = 0; b < B; ++b) {
    HostWalkIO io;
    io.plane = trace + (int64_t)b * sb;
    io.si = si;
    io.sj = sj;
    io.qsym = qsym + (Bq == 1 ? 0 : (int64_t)b * Qp);
    io.rsym = rsym + (int64_t)b * Rp;
    io.qp = Qp;
    io.rp = Rp;
    io.ops = ops + (int64_t)b * L;
    ptwalk::walk_pair_tiled(io, end_q[b], end_r[b], Qp, Rp, L, local != 0,
                            qb != 0, db != 0, beg[b], beg[B + b]);
  }
  return 0;
}
