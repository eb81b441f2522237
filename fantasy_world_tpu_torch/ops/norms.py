"""Normalization primitives with f32 statistics (``ops/norms.py``).

Plain PyTorch, as the JAX package left these to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """AdaLN modulation x * (1 + scale) + shift."""
    return x * (1 + scale) + shift


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """f32 statistics, normed value rounded to x.dtype before the scale."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y.to(x.dtype) * weight).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis in f32, optional affine applied in f32,
    returned in x.dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def layer_norm_modulate(x: torch.Tensor, shift: torch.Tensor,
                        scale_mod: torch.Tensor,
                        weight: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        eps: float = 1e-6) -> torch.Tensor:
    """``modulate(layer_norm(x), shift, scale_mod)`` in x.dtype: the normed
    value is rounded to x.dtype, then modulated in f32. shift/scale_mod
    (B', 1, D) with B' dividing x's batch (frame-folded batches repeat)."""
    B = x.shape[0]
    if shift.shape[0] != B:
        reps = B // shift.shape[0]
        shift = shift.repeat_interleave(reps, dim=0)
        scale_mod = scale_mod.repeat_interleave(reps, dim=0)
    y = layer_norm(x, weight, bias, eps)
    return modulate(y.float(), shift.float(), scale_mod.float()).to(x.dtype)
