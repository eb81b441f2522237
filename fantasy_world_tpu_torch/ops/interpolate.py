"""Bilinear interpolation with align_corners=True (``ops/interpolate.py``):
two dense matmuls with banded two-tap interpolation matrices, in f32."""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) f32 matrix of the align_corners lerp; rows sum to 1."""
    A = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        A[:, 0] = 1.0
        return A
    coords = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.minimum(np.floor(coords).astype(np.int32), n_in - 2)
    frac = (coords - lo).astype(np.float32)
    rows = np.arange(n_out)
    np.add.at(A, (rows, lo), 1.0 - frac)
    np.add.at(A, (rows, lo + 1), frac)
    return A


def bilinear_align_corners(x: torch.Tensor, size) -> torch.Tensor:
    """x: (..., H, W) -> (..., h_out, w_out), computed in f32."""
    h_out, w_out = size
    H, W = x.shape[-2:]
    if (h_out, w_out) == (H, W):
        return x
    out = x.float()
    if h_out != H:
        ah = torch.as_tensor(_interp_matrix(H, h_out), device=x.device)
        out = torch.matmul(ah, out)
    if w_out != W:
        aw = torch.as_tensor(_interp_matrix(W, w_out), device=x.device)
        out = torch.matmul(out, aw.t())
    return out.to(x.dtype)
