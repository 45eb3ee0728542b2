"""Carry the reference package's state across to the port.

The system has no weights.  Its state is the substitution table and byte
mapper of a ``Matrix`` (the port has its own class, so a matrix is
carried across field by field: :func:`matrix_from_reference`), the rows
and letters of a ``Profile``, and a packed batch: ``PairBatch.profile``, ``table``,
``qbytes``, ``rbytes``, ``qidx``, ``ridx``, ``qlen`` and ``rlen``; and,
between the tiles of a sequence-parallel fill, the boundary state of a
tile (:func:`rowseg_state_from_reference`).  These functions take those
fields as numpy arrays, so both packages can be fed identical inputs.
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


def _lanes_to_batch(a, B):
    """The reference's lane layout (nb, ..., 128), pairs on the last axis
    within blocks of 128 -> batch-major (B, ...)."""
    a = np.asarray(a)
    a = np.moveaxis(a, -1, 1)                       # (nb, 128, ...)
    return a.reshape((-1,) + a.shape[2:])[:B]


def rowseg_state_from_reference(state: dict, B: int, *,
                                device="cpu") -> dict:
    """The right-going state of a reference tile
    (``scan_rowseg_step``'s ``state`` / ``new_state``: ``h``, ``f``
    (nb, 1, Qc, 128), ``t`` (nb, 1, 1 or 4, 128), ``acc`` (nb, 8, 128),
    ``stats`` six (nb, 1, Qc, 128) planes) -> the port's
    (:func:`~.ops.scan_kernel.score_rowseg`'s ``state``): ``h``, ``f``
    (B, Qc), ``t`` (B, 4), ``acc`` (B, 8), ``stats`` (6, B, Qc).

    ``acc`` keeps the best cell, its coordinates and its payload.  The
    reference carries saturation FLAGS in rows 3 and 4 where the port
    carries the extremes of H; flags do not say the extremes, so they
    become 0 (the extremes before any cell) and a test compares those
    two rows through the outputs, not here.
    """
    i32 = np.int32
    out = {k: _lanes_to_batch(state[k], B)[:, 0].astype(i32)
           for k in ("h", "f")}
    t = _lanes_to_batch(state["t"], B)[:, 0]
    out["t"] = np.zeros((B, 4), i32)
    out["t"][:, :t.shape[1]] = t
    acc = _lanes_to_batch(state["acc"], B).astype(i32)
    acc[:, 3:5] = 0
    out["acc"] = acc
    if "stats" in state:
        out["stats"] = np.stack(
            [_lanes_to_batch(p, B)[:, 0] for p in state["stats"]]).astype(i32)
    return {k: _tensor(v, i32, torch.device(device)) for k, v in out.items()}


def rowseg_down_from_reference(down: dict, B: int) -> dict:
    """What of a reference tile's down-state (``h`` and, with stats, six
    planes, each (nb, C, 128)) corresponds to the port's: ``h`` (B, C),
    row 0 of the port's ``down``, and ``pay`` (3, B, C), H's payload, its
    rows 2-4.  The reference's ``pm`` (a prefix-max seed) and the port's
    E rows do not correspond and are not converted."""
    out = {"h": _lanes_to_batch(down["h"], B).astype(np.int32)}
    if "stats" in down:
        out["pay"] = np.stack([_lanes_to_batch(p, B)
                               for p in down["stats"][:3]]).astype(np.int32)
    return out
