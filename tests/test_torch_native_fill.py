"""The port's streamed row fill (native/ptfill.cc + fill.py).

Streamed or not it must write exactly the native packer's rows, keep
its return codes (non-bytes, row past P, interior NUL), and
``dispatch.pack_pairs`` must give the same planes with it as without it.
"""

import numpy as np
import pytest

from parasail_rs_tpu_torch.engine import dispatch
from parasail_rs_tpu_torch.errors import InteriorNulByte
from parasail_rs_tpu_torch.matrices import Matrix
from parasail_rs_tpu_torch.native import fill, packer
from parasail_rs_tpu_torch.utils.shapes import length_bucket


def _seqs(n, hi=300, seed=5):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    return [rng.choice(alpha, size=int(l)).tobytes()
            for l in rng.integers(0, hi, n)]


@pytest.fixture
def native():
    if not (fill._load() and packer.available()):
        pytest.skip("no compiler in this environment")


def _stream(monkeypatch, on):
    monkeypatch.setattr(fill, "MIN_STREAM_BYTES", 0 if on else 1 << 62)


@pytest.mark.parametrize("stream", [0, 1])
@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 333])
def test_rows_equal_the_packer(native, monkeypatch, n, stream):
    _stream(monkeypatch, stream)
    seqs = _seqs(n)
    P = length_bucket(max([len(s) for s in seqs] + [1]))
    out = np.full((n, P), 7, np.uint8)
    assert fill.fill(seqs, P, out) == 0
    want = (packer.pack_side(seqs, P, length_bucket)[0] if n
            else np.empty((0, P), np.uint8))
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("P", [8, 24, 40, 136])
@pytest.mark.parametrize("offset", [0, 1, 5, 8])
def test_streamed_rows_at_any_alignment(native, monkeypatch, P, offset):
    # rows that start off a 16-byte boundary, rows shorter than a store
    # and rows that fill P: the streamed stores write what memcpy would
    _stream(monkeypatch, True)
    seqs = _seqs(37, hi=P + 1, seed=P + offset)
    buf = np.full(37 * P + offset, 9, np.uint8)
    out = buf[offset:].reshape(37, P)
    assert fill.fill(seqs, P, out) == 0
    np.testing.assert_array_equal(
        out, packer.pack_side(seqs, P, length_bucket)[0])
    assert (buf[:offset] == 9).all()


@pytest.mark.parametrize("stream", [0, 1])
@pytest.mark.parametrize("case,rc", [
    ("nul", -2), ("not_bytes", -1), ("past_p", -3)])
def test_return_codes(native, monkeypatch, case, rc, stream):
    # the packer's codes at the same rows: the first bad row decides
    _stream(monkeypatch, stream)
    seqs = _seqs(40, hi=60)
    seqs[29] = {"nul": b"AC\x00GT", "not_bytes": bytearray(b"ACGT"),
                "past_p": b"A" * 65}[case]
    assert fill.fill(seqs, 64, np.empty((40, 64), np.uint8)) == rc
    seqs[35] = b"AC\x00GT"
    assert fill.fill(seqs, 64, np.empty((40, 64), np.uint8)) == rc
    lib = packer._load()
    assert lib.pt_pack_fill(seqs, 40, 64,
                            np.empty((40, 64), np.uint8).ctypes.data) == rc


@pytest.mark.parametrize("stream", [0, 1])
def test_pack_pairs_same_planes_with_and_without(native, monkeypatch,
                                                 stream):
    m = Matrix.create(b"ACGT", 2, -3)
    qs, rs = _seqs(100, seed=6), _seqs(100, seed=7)
    _stream(monkeypatch, stream)
    b1, ql1, rl1 = dispatch.pack_pairs(m, qs, rs, device="cpu")
    monkeypatch.setattr(fill, "_lib", None)
    monkeypatch.setattr(fill, "_tried", True)
    b2, ql2, rl2 = dispatch.pack_pairs(m, qs, rs, device="cpu")
    assert ql1 == ql2 and rl1 == rl2
    np.testing.assert_array_equal(b1.qbytes.numpy(), b2.qbytes.numpy())
    np.testing.assert_array_equal(b1.rbytes.numpy(), b2.rbytes.numpy())


@pytest.mark.parametrize("side", ["query", "reference"])
def test_pack_pairs_nul_raises_through_the_fill(native, monkeypatch, side):
    _stream(monkeypatch, True)
    m = Matrix.create(b"ACGT", 2, -3)
    bad, good = [b"ACGT", b"AC\x00GT"], [b"ACGT", b"ACGT"]
    qs, rs = (bad, good) if side == "query" else (good, bad)
    with pytest.raises(InteriorNulByte):
        dispatch.pack_pairs(m, qs, rs, device="cpu")


def test_pack_pairs_longer_than_p_falls_back(native, monkeypatch):
    # a row past an explicit padded width leaves the fill (-3) for the
    # generic path, which keeps its own answer
    _stream(monkeypatch, True)
    m = Matrix.create(b"ACGT", 2, -3)
    with pytest.raises(Exception) as got:
        dispatch.pack_pairs(m, [b"ACGT" * 10], [b"ACGT"], Qp=16,
                            device="cpu")
    monkeypatch.setattr(fill, "_lib", None)
    monkeypatch.setattr(fill, "_tried", True)
    with pytest.raises(Exception) as want:
        dispatch.pack_pairs(m, [b"ACGT" * 10], [b"ACGT"], Qp=16,
                            device="cpu")
    assert type(got.value) is type(want.value)
