"""The port's SSW (``ssw``, ``ssw_batch``, the windowed three-pass
pipeline) on the CPU against the reference's.

The same pairs go through ``parasail_rs_tpu_torch`` (``device="cpu"``:
the plain versions of the SW trace kernel, the NW trace kernel and the
walk) and ``parasail_rs_tpu``: score1, begins, ends and the merged-M
CIGAR must be equal, on the one-pass and the windowed route, with and
without a profile at every ``score_size``, and on a zero-score pair.  The
automatic choice of the windowed route must be the reference's.  The
cases are those of tests/test_engine.py:307-353, :484-499 and :630-695.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parasail_rs_tpu as ref  # noqa: E402
from parasail_rs_tpu.golden import model as golden  # noqa: E402

import parasail_rs_tpu_torch as port  # noqa: E402
from parasail_rs_tpu_torch import convert  # noqa: E402

from test_torch_engine import (  # noqa: E402
    BLOSUM62,
    PROTEIN,
    _seqs,
    port_matrix,
)
from test_torch_engine_stats import CPU_ROUTE  # noqa: E402


def _ssw(results):
    return [(s.score1, s.score(), s.read_begin1, s.read_end1, s.ref_begin1,
             s.ref_end1, s.cigar_string(), s.cigar().tolist())
            for s in results]


def _both(matrix, open_, ext):
    r = ref.Aligner.new().matrix(matrix).gap_open(open_).gap_extend(ext)
    p = (port.Aligner.new().matrix(port_matrix(matrix)).gap_open(open_)
         .gap_extend(ext))
    return r.build(), p.device("cpu").build()


def _port_profile(r_prof):
    p = convert.profile_from_reference(
        query=r_prof.query, matrix=port_matrix(r_prof.matrix),
        rows=r_prof.rows, qidx=r_prof.qidx, use_stats=r_prof.use_stats)
    p.score_size = r_prof.score_size
    return p


def test_ssw_alignment():
    # tests/test_engine.py:307-318 (reference test_parasail.rs:738-765)
    r, p = _both(ref.Matrix.default(), 0, 0)
    got = p.ssw(b"ACGT", b"ACGT")
    assert (got.score(), got.query_end(), got.ref_end(), got.query_start(),
            got.ref_start(), got.cigar_string()) == (4, 3, 3, 0, 0, "4M")
    assert got.cigar_len() == 1
    assert _ssw([got]) == _ssw([r.ssw(b"ACGT", b"ACGT")])
    assert set(p.route_counter) == CPU_ROUTE


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("size,want_big", [(0, 255), (1, 800), (2, 800)])
def test_ssw_profile_score_size(size, want_big, windowed):
    # tests/test_engine.py:325-339: 0 = 8-bit, a saturated pair reports the
    # SSW cap 255; 1 and 2 exact up to 65535
    m = ref.Matrix.create(b"ACGT", 5, -4)
    q = b"ACGT" * 40
    refs = [q, q[:20]]
    r_prof = ref.Profile.new_ssw(q, m, size)
    r = ref.Aligner.new().profile(r_prof).gap_open(10).gap_extend(1).build()
    p = (port.Aligner.new().profile(_port_profile(r_prof)).gap_open(10)
         .gap_extend(1).device("cpu").build())
    got = p.ssw_batch(None, refs, windowed=windowed)
    assert [s.score() for s in got] == [want_big, 100]
    assert _ssw(got) == _ssw(r.ssw_batch(None, refs, windowed=windowed))
    assert _ssw([p.ssw(None, refs[1])]) == _ssw(got[1:])


def test_ssw_profile_matches_query_path():
    # tests/test_engine.py:342-353
    m = ref.Matrix.create(b"ACGT", 2, -3)
    q = b"ACGTTACGGT"
    refs = [b"ACGTACGT", b"TTTTACGTT", b"GGACGTTACG"]
    r_prof = ref.Profile.new_ssw(q, m, 2)
    p = (port.Aligner.new().profile(_port_profile(r_prof)).gap_open(4)
         .gap_extend(1).device("cpu").build())
    via_profile = p.ssw_batch(None, refs)
    _, pq = _both(m, 4, 1)
    assert _ssw(via_profile) == _ssw(pq.ssw_batch([q] * len(refs), refs))
    r = ref.Aligner.new().profile(r_prof).gap_open(4).gap_extend(1).build()
    assert _ssw(via_profile) == _ssw(r.ssw_batch(None, refs))
    with pytest.raises(port.errors.QueryRequired):
        pq.ssw_batch(None, refs)


def test_ssw_batch():
    # tests/test_engine.py:484-499
    rng = np.random.default_rng(31)
    r, p = _both(BLOSUM62, 11, 1)
    alpha = list(PROTEIN)
    qs = [rng.choice(alpha, size=rng.integers(5, 30)).astype("uint8")
          .tobytes() for _ in range(12)]
    rs = [rng.choice(alpha, size=rng.integers(5, 30)).astype("uint8")
          .tobytes() for _ in range(12)]
    batch = p.ssw_batch(qs, rs)
    assert _ssw(batch) == _ssw(r.ssw_batch(qs, rs))
    for q, rr, res in zip(qs, rs, batch):
        assert _ssw([p.ssw(q, rr)]) == _ssw([res])
        g = golden.align_seqs(q, rr, BLOSUM62, 11, 1, "sw")
        assert (res.score(), res.query_end(), res.ref_end()) == \
            (g.score, g.end_query, g.end_ref)


def _planted(seed, n=6):
    """tests/test_engine.py:637-650: pairs with a planted homologous
    region, so the local alignments are not trivial."""
    rng = np.random.default_rng(seed)
    qs, rs = [], []
    for _ in range(n):
        q = rng.choice(list(PROTEIN), size=int(rng.integers(30, 70))) \
            .astype("uint8").tobytes()
        r = bytearray(rng.choice(list(PROTEIN), size=int(
            rng.integers(80, 160))).astype("uint8").tobytes())
        at = int(rng.integers(0, len(r) - len(q) // 2))
        r[at:at + len(q) // 2] = q[: len(q) // 2]
        qs.append(q)
        rs.append(bytes(r))
    return qs, rs


def _rescore(cig, q, r, m, open_, ext):
    """A CIGAR's score over q and r from their begins."""
    import re

    qi = ri = score = 0
    for cnt, op in re.findall(r"(\d+)([MIDNSHP=XB])", cig):
        cnt = int(cnt)
        if op in "M=X":
            for _ in range(cnt):
                score += int(m.data[m.mapper[q[qi]], m.mapper[r[ri]]])
                qi += 1
                ri += 1
        else:
            score -= open_ + (cnt - 1) * ext
            qi += cnt if op == "I" else 0
            ri += cnt if op == "D" else 0
    return score


def test_ssw_windowed_matches_one_pass_and_reference():
    # tests/test_engine.py:630-695
    qs, rs = _planted(7)
    r, p = _both(BLOSUM62, 11, 1)
    one = p.ssw_batch(qs, rs, windowed=False)
    win = p.ssw_batch(qs, rs, windowed=True)
    assert _ssw(one) == _ssw(r.ssw_batch(qs, rs, windowed=False))
    assert _ssw(win) == _ssw(r.ssw_batch(qs, rs, windowed=True))
    assert _ssw(p.ssw_batch(qs, rs)) == _ssw(one)       # auto: one pass
    for q, rr, o, w in zip(qs, rs, one, win):
        assert (w.score1, w.read_end1, w.ref_end1) == \
            (o.score1, o.read_end1, o.ref_end1)
        g = golden.align_seqs(q[w.read_begin1:w.read_end1 + 1],
                              rr[w.ref_begin1:w.ref_end1 + 1], BLOSUM62, 11,
                              1, mode="nw")
        assert g.score == o.score1
        assert _rescore(w.cigar_string(), q[w.read_begin1:],
                        rr[w.ref_begin1:], BLOSUM62, 11, 1) == o.score1


@pytest.mark.parametrize("windowed", [False, True])
def test_ssw_zero_score_pair(windowed):
    # tests/test_engine.py:689-695
    r, p = _both(ref.Matrix.create(b"ACGT", 1, -1), 5, 2)
    got = p.ssw_batch([b"AAAA", b"ACGT"], [b"TTTT", b"ACGT"],
                      windowed=windowed)
    assert got[0].score1 == 0 and got[0].cigar_len() == 0
    assert _ssw(got) == _ssw(r.ssw_batch([b"AAAA", b"ACGT"],
                                         [b"TTTT", b"ACGT"],
                                         windowed=windowed))


class _Pass(Exception):
    pass


# (pairs, qlen, rlen): around the reference's bound, 128-rounded pairs
# times the padded lengths > 4 << 30 cells
AUTO = [(1, 8192, 4500, True), (1, 4096, 6144, False),
        (129, 4096, 4096, False), (129, 4097, 4096, True)]


@pytest.mark.parametrize("n,ql,rl,windowed", AUTO)
def test_ssw_auto_windowed_rule_is_the_reference(n, ql, rl, windowed,
                                                 monkeypatch):
    # stop each package at the pass it picks, before it aligns anything
    def stop(name):
        def fn(*a, **k):
            raise _Pass(name)
        return fn

    for pkg in (ref, port):
        monkeypatch.setattr(pkg.Aligner, "_ssw_windowed", stop("windowed"))
        monkeypatch.setattr(pkg.Aligner, "_pack", stop("one pass"))
    qs, rs = [b"A" * ql] * n, [b"C" * rl] * n
    r, p = _both(ref.Matrix.default(), 1, 1)
    for al in (r, p):
        with pytest.raises(_Pass, match="windowed" if windowed
                           else "one pass"):
            al.ssw_batch(qs, rs)


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("windowed", [False, True])
def test_ssw_on_card_matches_cpu(windowed, cuda_device):
    qs, rs = _planted(9, 40)
    cpu = (port.Aligner.new().matrix(port_matrix(BLOSUM62)).gap_open(11)
           .gap_extend(1).device("cpu").build())
    card = (port.Aligner.new().matrix(port_matrix(BLOSUM62)).gap_open(11)
            .gap_extend(1).device(cuda_device).build())
    assert _ssw(card.ssw_batch(qs, rs, windowed=windowed)) == \
        _ssw(cpu.ssw_batch(qs, rs, windowed=windowed))
    assert set(card.route_counter) == {("cuda_kernel", "")}


@pytest.mark.cuda
def test_ssw_profile_on_card_matches_cpu(cuda_device):
    m = ref.Matrix.create(b"ACGT", 5, -4)
    q = b"ACGT" * 40
    refs = _seqs(5, b"ACGT", 30, 10, 200) + [q]
    for size in (0, 2):
        prof = port.Profile.new_ssw(q, port_matrix(m), size)
        got = [port.Aligner.new().profile(prof).gap_open(10).gap_extend(1)
               .device(d).build().ssw_batch(None, refs)
               for d in (cuda_device, "cpu")]
        assert _ssw(got[0]) == _ssw(got[1])
