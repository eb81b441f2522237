"""torch-exact bicubic resampling matrices, host-side numpy (the port's
copy of ``bicubic_matrix`` in ``fantasy_world_tpu/ops/bicubic.py``).

``F.interpolate(mode='bicubic', align_corners=False)`` uses the Keys cubic
kernel (a = -0.75), the half-pixel mapping src = (dst + 0.5) / s - 0.5 and
edge clamping. One axis of it is a dense (n_out, n_in) matrix, so a resize
is two matmuls.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    return np.where(ax <= 1, (a + 2) * ax3 - (a + 3) * ax2 + 1,
                    np.where(ax < 2,
                             a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a,
                             0.0))


def _axis_weights(n_in: int, n_out: int, scale: Optional[float]):
    if scale is None:
        scale = n_out / n_in
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) / scale - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    idx = np.stack([base - 1, base, base + 1, base + 2], axis=1)
    w = _cubic_kernel(np.stack([frac + 1, frac, 1 - frac, 2 - frac], axis=1))
    return np.clip(idx, 0, n_in - 1), w


def bicubic_matrix(n_in: int, n_out: int, scale: Optional[float] = None
                   ) -> np.ndarray:
    """Dense (n_out, n_in) f64 one-axis resample matrix of the torch bicubic
    kernel, ``out = A @ x``; edge-clamped taps accumulate onto the clamped
    index."""
    idx, w = _axis_weights(n_in, n_out, scale)
    A = np.zeros((n_out, n_in), np.float64)
    np.add.at(A, (np.arange(n_out)[:, None], idx), w)
    return A
