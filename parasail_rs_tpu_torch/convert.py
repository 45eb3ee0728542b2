"""Carry the reference package's state across to the port.

The system has no weights.  Its state is the substitution table and byte
mapper of a ``Matrix`` (the port has its own class, so a matrix is
carried across field by field: :func:`matrix_from_reference`), the rows
and letters of a ``Profile``, and a packed batch: ``PairBatch.profile``, ``table``,
``qbytes``, ``rbytes``, ``qidx``, ``ridx``, ``qlen`` and ``rlen``.  These
functions take those fields as numpy arrays, so both packages can be fed
identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine.dispatch import PairBatch
from .engine.profile import Profile
from .matrices import Matrix


def _tensor(a, dtype, device):
    if a is None:
        return None
    arr = np.ascontiguousarray(np.asarray(a), dtype=dtype)
    return torch.from_numpy(arr).to(device)


def batch_from_reference(*, qlen, rlen, ridx=None, qidx=None, profile=None,
                         table=None, qbytes=None, rbytes=None, mapper=None,
                         device) -> PairBatch:
    """A reference batch's fields (numpy) -> the port's PairBatch on
    ``device``.

    Give ``ridx`` or ``rbytes`` + ``mapper``; give ``table`` with ``qidx``
    (or ``qbytes`` + ``mapper``) for a square matrix, or ``profile``
    (1 or B, Qp, A) rows.
    """
    device = torch.device(device)
    i32 = np.int32
    return PairBatch(
        profile=_tensor(profile, i32, device),
        qidx=_tensor(qidx, i32, device),
        ridx=_tensor(ridx, i32, device),
        qlen=np.asarray(qlen, i32), rlen=np.asarray(rlen, i32),
        table=_tensor(table, i32, device),
        qbytes=_tensor(qbytes, np.uint8, device),
        rbytes=_tensor(rbytes, np.uint8, device),
        mapper=_tensor(mapper, i32, device),
        device=device)


def matrix_from_reference(*, data, mapper, alphabet, kind="square",
                          name=None, builtin=False, approximate=False,
                          query=None) -> Matrix:
    """A reference Matrix's fields (its dataclass fields, as numpy arrays
    and plain values) -> the port's Matrix.  A builtin matrix stays
    frozen, as ``Matrix.from_name`` builds it."""
    return Matrix(
        data=np.array(data, dtype=np.int32), mapper=np.array(mapper, np.int32),
        alphabet=bytes(alphabet), kind=str(kind), name=name,
        builtin=bool(builtin), approximate=bool(approximate),
        query=None if query is None else bytes(query),
        _frozen=bool(builtin))


def profile_from_reference(*, query: bytes, matrix: Matrix, rows, qidx,
                           use_stats: bool = False) -> Profile:
    """A reference Profile's fields -> the port's Profile; ``matrix`` is
    the port's Matrix (:func:`matrix_from_reference`).

    A profile is host state in both packages (the dataclass is the same
    code); its rows move to the device with each batch packed against it.
    """
    return Profile(query=bytes(query), matrix=matrix, use_stats=use_stats,
                   rows=np.asarray(rows, np.int32),
                   qidx=np.asarray(qidx, np.int32))
