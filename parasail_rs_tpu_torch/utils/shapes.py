"""Shape/padding helpers for static-shape (XLA-friendly) kernels."""

from __future__ import annotations

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_to(arr: np.ndarray, length: int, axis: int = -1, fill=0) -> np.ndarray:
    """Pad ``arr`` along ``axis`` to ``length`` with ``fill``."""
    cur = arr.shape[axis]
    if cur == length:
        return arr
    if cur > length:
        raise ValueError(f"cannot pad axis {axis} from {cur} down to {length}")
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, length - cur)
    return np.pad(arr, widths, constant_values=fill)


def length_bucket(n: int, *, minimum: int = 16) -> int:
    """Static-shape bucket for a sequence length.

    Buckets lengths to {16, 24, 32, 48, 64, 96, 128, 192, 256, 384, ...}
    — powers of two interleaved with 1.5x powers of two — so jit caches a
    small number of shapes while keeping padding waste under ~33%.  Every
    bucket is a multiple of 8 (int32 sublane tile).
    """
    if n <= minimum:
        return minimum
    b = minimum
    while b < n:
        # powers of two interleaved with their 1.5x midpoints
        b = b + b // 2 if b & (b - 1) == 0 else b + b // 3
    return b
