// Host build of the kernels' per-pair code (score_cell.cuh, walk_step.cuh)
// for the CPU tests: the same score_batch_pair and walk_pair the CUDA
// kernels run, one pair at a time, with the row scratch at stride 1, and
// the segment, tile and chunked kernels' lanes stepped in a loop
// (segment_pair_host).
// Build with
//   g++ -O2 -std=c++17 -shared -fPIC -o libptscore_host.so score_host.cc
#include <stdint.h>

#include <vector>

#include "score_cell.cuh"
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

// Same arguments as pt_scan_score minus the scratch and the stream;
// `out` is (5, B): score, end_query, end_ref, sat8, sat16.
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
// (B, Qp, Rp) int8 plane the caller zero-fills.
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

// The stats, table and rowcol classes (out_class 2-6): pt_scan_outputs's
// arguments minus the scratch and the stream, with batch-major planes the
// caller zero-fills: `out` (8, B), `planes` (4, B, Qp, Rp), `row`
// (4, B, Rp), `col` (4, B, Qp).  Returns -1 for an unknown class.
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

// The banded forms of every class (out_class 0-6): pt_outputs_host's
// arguments plus a (B, Qp, Rp) int8 flag plane `trace` for the trace
// class and `bandwidth`, as pt_scan_banded.  `out` is (8, B).  Returns -1
// for an unknown class.
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

// One segment of the segment form (pt_scan_segment's arguments minus the
// scratch and the stream, same layouts): out_class 0 score, 1 trace,
// 2 stats; `st_h` / `st_f` (B, Qp), `st_pay` (6, B, Qp) and `acc` (B, 8)
// are read (if resume) and updated in place; `out` is (8, B); `trace`
// (B, Qp, Rseg) arrives zero-filled; `warps` is the number of warps the
// kernel's block would put on a pair.  Returns -1 for another class.
extern "C" int pt_segment_host(int out_class, const int32_t* subs,
                               const int32_t* qidx, const int32_t* mq,
                               const int32_t* ridx, const int32_t* qlen,
                               const int32_t* rlen, int32_t* st_h,
                               int32_t* st_f, int32_t* st_pay, int32_t* acc,
                               int32_t* out, int8_t* trace, int B, int Bq,
                               int Bm, int Qp, int Rseg, int A, int open,
                               int ext, int mode, int free_bits, int off,
                               int resume, int warps) {
  if ((out_class != ptscore::OUT_SCORE && out_class != ptscore::OUT_TRACE &&
       out_class != ptscore::OUT_STATS) || warps < 1)
    return -1;
  std::vector<int32_t> bottom(8 * (Rseg > 0 ? Rseg : 1));
  const int64_t pay_plane = (int64_t)B * Qp;
  for (int b = 0; b < B; ++b) {
    const ptscore::SegPair p = ptscore::seg_pair(
        qlen[b], rlen[b], Qp, off, Rseg, open, ext, mode, free_bits,
        resume != 0, A);
    const int64_t bq = Bq == 1 ? 0 : b;
    const int32_t* rows = qidx ? subs : subs + bq * Qp * A;
    const int32_t* q = qidx ? qidx + bq * Qp : nullptr;
    const int32_t* mqb = mq ? mq + (Bm == 1 ? 0 : (int64_t)b * Qp) : nullptr;
    const int32_t* rseg = ridx + (int64_t)b * Rseg;
    int32_t* sh = st_h + (int64_t)b * Qp;
    int32_t* sf = st_f + (int64_t)b * Qp;
    int32_t* sp = st_pay ? st_pay + (int64_t)b * Qp : nullptr;
    int32_t* ac = acc + (int64_t)b * 8;
    int8_t* tr = trace ? trace + (int64_t)b * Qp * Rseg : nullptr;
    ptscore::PairResult r;
    if (out_class == ptscore::OUT_SCORE) {
      r = ptscore::segment_pair_host<ptscore::OUT_SCORE>(
          rows, q, mqb, rseg, Rseg, p, mode, bottom.data(), sh, sf, sp,
          pay_plane, ac, tr, warps);
    } else if (out_class == ptscore::OUT_TRACE) {
      r = ptscore::segment_pair_host<ptscore::OUT_TRACE>(
          rows, q, mqb, rseg, Rseg, p, mode, bottom.data(), sh, sf, sp,
          pay_plane, ac, tr, warps);
    } else {
      r = ptscore::segment_pair_host<ptscore::OUT_STATS>(
          rows, q, mqb, rseg, Rseg, p, mode, bottom.data(), sh, sf, sp,
          pay_plane, ac, tr, warps);
    }
    out[b] = r.score;
    out[B + b] = r.end_query;
    out[2 * B + b] = r.end_ref;
    out[3 * B + b] = r.sat8;
    out[4 * B + b] = r.sat16;
    out[5 * B + b] = r.matches;
    out[6 * B + b] = r.similar;
    out[7 * B + b] = r.length;
  }
  return 0;
}

// One tile of the tile form (pt_scan_rowseg's arguments minus the stream,
// same layouts): rows [r0, r0 + qc) by columns [off, off + C).  `down`
// (B, 2, C), or (B, 8, C) for stats, is read above the tile and left
// holding its last row; `st_h` / `st_f`
// (B, qc), `st_pay` (6, B, qc) and `acc` (B, 8) are updated in place;
// `out` is (8, B); `trace` (B, qc, C) arrives zero-filled; `t_in` /
// `t_out` are (B, 4).  Returns -1 for another class.
extern "C" int pt_rowseg_host(int out_class, const int32_t* subs,
                              const int32_t* qidx, const int32_t* mq,
                              const int32_t* ridx, const int32_t* qlen,
                              const int32_t* rlen, int32_t* down,
                              int32_t* st_h, int32_t* st_f, int32_t* st_pay,
                              int32_t* acc, int32_t* out, int8_t* trace,
                              const int32_t* t_in, int32_t* t_out, int B,
                              int Bq, int Bm, int Qp, int C, int A, int open,
                              int ext, int mode, int free_bits, int off,
                              int r0, int qc, int warps) {
  if ((out_class != ptscore::OUT_SCORE && out_class != ptscore::OUT_TRACE &&
       out_class != ptscore::OUT_STATS) || warps < 1)
    return -1;
  const int64_t pay_plane = (int64_t)B * qc;
  const int down_rows = out_class == ptscore::OUT_STATS ? 8 : 2;
  std::vector<int32_t> bottom((int64_t)down_rows * C);
  for (int b = 0; b < B; ++b) {
    const ptscore::SegPair p = ptscore::tile_pair(
        qlen[b], rlen[b], Qp, r0, qc, off, C, open, ext, mode, free_bits, A);
    const int64_t bq = Bq == 1 ? 0 : b;
    const int32_t* rows = qidx ? subs : subs + bq * Qp * A;
    const int32_t* q = qidx ? qidx + bq * Qp : nullptr;
    const int32_t* mqb = mq ? mq + (Bm == 1 ? 0 : (int64_t)b * Qp) : nullptr;
    const int32_t* rseg = ridx + (int64_t)b * C;
    int32_t* dn = down + (int64_t)b * down_rows * C;
    int32_t* sh = st_h + (int64_t)b * qc;
    int32_t* sf = st_f + (int64_t)b * qc;
    int32_t* sp = st_pay ? st_pay + (int64_t)b * qc : nullptr;
    int32_t* ac = acc + (int64_t)b * 8;
    int8_t* tr = trace ? trace + (int64_t)b * qc * C : nullptr;
    const int32_t* ti = t_in + (int64_t)b * 4;
    int32_t* to = t_out + (int64_t)b * 4;
    ptscore::PairResult r;
    if (out_class == ptscore::OUT_SCORE) {
      r = ptscore::segment_pair_host<ptscore::OUT_SCORE>(
          rows, q, mqb, rseg, C, p, mode, bottom.data(), sh, sf, sp,
          pay_plane, ac, tr, warps, dn, ti, to);
    } else if (out_class == ptscore::OUT_TRACE) {
      r = ptscore::segment_pair_host<ptscore::OUT_TRACE>(
          rows, q, mqb, rseg, C, p, mode, bottom.data(), sh, sf, sp,
          pay_plane, ac, tr, warps, dn, ti, to);
    } else {
      r = ptscore::segment_pair_host<ptscore::OUT_STATS>(
          rows, q, mqb, rseg, C, p, mode, bottom.data(), sh, sf, sp,
          pay_plane, ac, tr, warps, dn, ti, to);
    }
    out[b] = r.score;
    out[B + b] = r.end_query;
    out[2 * B + b] = r.end_ref;
    out[3 * B + b] = r.sat8;
    out[4 * B + b] = r.sat16;
    out[5 * B + b] = r.matches;
    out[6 * B + b] = r.similar;
    out[7 * B + b] = r.length;
  }
  return 0;
}

namespace {

template <int32_t kOut>
ptscore::PairResult chunked_pair(const int32_t* rows, const int32_t* q,
                                 const int32_t* mq, const int32_t* ridx,
                                 int Rp, const ptscore::SegPair& p, int mode,
                                 int32_t* bottom, int32_t* st_h,
                                 int32_t* st_f, int32_t* st_pay,
                                 int32_t* acc, int8_t* trace, int warps,
                                 const ptscore::SegPlanes& pl) {
  return ptscore::segment_pair_host<kOut>(rows, q, mq, ridx, Rp, p, mode,
                                          bottom, st_h, st_f, st_pay, p.qp,
                                          acc, trace, warps, nullptr,
                                          nullptr, nullptr, pl);
}

}  // namespace

// The chunked sweep, every class: what score_chunked launches on the card
// (pt_scan_chunked's four plane forms, pt_scan_segment's score, stats and
// trace forms as one segment of Rp columns from column 0), with their
// layouts, minus the scratch and the stream; `warps` warps on a pair as
// the kernel's block would have.
// `out` is (8, B); `trace` (B, Qp, Rp), `tab` (4, B, Rp, Qp), `rows`
// (4, B, Rp) and `cols` (4, B, Qp) arrive zero-filled (planes beyond the
// class's are left alone).  Returns -1 for an unknown class.
extern "C" int pt_chunked_host(int out_class, const int32_t* subs,
                               const int32_t* qidx, const int32_t* mq,
                               const int32_t* ridx, const int32_t* qlen,
                               const int32_t* rlen, int32_t* out,
                               int8_t* trace, int32_t* tab, int32_t* rows,
                               int32_t* cols, int B, int Bq, int Bm, int Qp,
                               int Rp, int A, int open, int ext, int mode,
                               int free_bits, int warps) {
  if (out_class < ptscore::OUT_SCORE || out_class > ptscore::OUT_STATS_ROWCOL
      || warps < 1)
    return -1;
  const int n = Rp > 0 ? Rp : 1;
  std::vector<int32_t> bottom(8 * n), st_h(Qp), st_f(Qp), st_pay(6 * Qp),
      acc(8);
  for (int b = 0; b < B; ++b) {
    const ptscore::SegPair p = ptscore::seg_pair(
        qlen[b], rlen[b], Qp, 0, Rp, open, ext, mode, free_bits, false, A);
    const int64_t bq = Bq == 1 ? 0 : b;
    const int32_t* srows = qidx ? subs : subs + bq * Qp * A;
    const int32_t* q = qidx ? qidx + bq * Qp : nullptr;
    const int32_t* mqb = mq ? mq + (Bm == 1 ? 0 : (int64_t)b * Qp) : nullptr;
    const int32_t* rb = ridx + (int64_t)b * Rp;
    int8_t* tr = trace ? trace + (int64_t)b * Qp * Rp : nullptr;
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
    ptscore::PairResult r;
#define PT_CHUNK(k)                                                        \
  r = chunked_pair<k>(srows, q, mqb, rb, Rp, p, mode, bottom.data(),       \
                      st_h.data(), st_f.data(), st_pay.data(), acc.data(), \
                      tr, warps, pl)
    switch (out_class) {
      case ptscore::OUT_SCORE: PT_CHUNK(ptscore::OUT_SCORE); break;
      case ptscore::OUT_TRACE: PT_CHUNK(ptscore::OUT_TRACE); break;
      case ptscore::OUT_STATS: PT_CHUNK(ptscore::OUT_STATS); break;
      case ptscore::OUT_TABLE: PT_CHUNK(ptscore::OUT_TABLE); break;
      case ptscore::OUT_STATS_TABLE: PT_CHUNK(ptscore::OUT_STATS_TABLE); break;
      case ptscore::OUT_ROWCOL: PT_CHUNK(ptscore::OUT_ROWCOL); break;
      default: PT_CHUNK(ptscore::OUT_STATS_ROWCOL); break;
    }
#undef PT_CHUNK
    out[b] = r.score;
    out[B + b] = r.end_query;
    out[2 * B + b] = r.end_ref;
    out[3 * B + b] = r.sat8;
    out[4 * B + b] = r.sat16;
    out[5 * B + b] = r.matches;
    out[6 * B + b] = r.similar;
    out[7 * B + b] = r.length;
  }
  return 0;
}
