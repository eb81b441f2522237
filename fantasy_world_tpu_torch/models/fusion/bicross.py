"""Bidirectional cross-modal attention between the DiT and VGGT streams
(``models/fusion/bicross.py``, overall mode): one shared q/k projection
pair drives attention both ways,

    dx1 = softmax(q k^T / sqrt(d)) v2     (video attends geometry)
    dx2 = softmax(k q^T / sqrt(d)) v1     (geometry attends video)

with rotate-half RoPE on q (DiT 3D angles) and k (aggregator angles, zero
for the special tokens) and zero-init per-channel gates on both residuals.
Both directions run the same attention kernel with q/k swapped, reading
them in place.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from ...core.params import linear
from ...ops import rope as rope_ops
from ...ops.attention import dot_product_attention
from ...ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class BicrossConfig:
    m1_dim: int = 5120       # DiT stream
    m2_dim: int = 1024       # aggregator stream
    hidden: int = 1152
    num_heads: int = 12

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads


class _CrossAttn(nn.Module):
    def __init__(self, cfg: BicrossConfig):
        super().__init__()
        self.m1_proj = nn.Linear(cfg.m1_dim, cfg.hidden)
        self.m2_proj = nn.Linear(cfg.m2_dim, cfg.hidden)
        self.values_m1_proj = nn.Linear(cfg.m1_dim, cfg.hidden)
        self.values_m2_proj = nn.Linear(cfg.m2_dim, cfg.hidden)
        self.out_m1_proj = nn.Linear(cfg.hidden, cfg.m1_dim)
        self.out_m2_proj = nn.Linear(cfg.hidden, cfg.m2_dim)


class Bicross(nn.Module):
    def __init__(self, cfg: BicrossConfig):
        super().__init__()
        self.cfg = cfg
        self.cross_attn = _CrossAttn(cfg)
        self.gamma_m1 = nn.Parameter(torch.empty(cfg.m1_dim))
        self.gamma_m2 = nn.Parameter(torch.empty(cfg.m2_dim))

    def init_extra_(self, generator):
        self.gamma_m1.data.zero_()
        self.gamma_m2.data.zero_()

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                rope_dit: Tuple, rope_agg: Tuple
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``bicross_apply``: x1 (B, L1, m1) DiT tokens, x2 (B, L2, m2)
        aggregator tokens -> the gated-residual-updated streams."""
        n, ca = self.cfg.num_heads, self.cross_attn
        B = x1.shape[0]
        x1n = layer_norm(x1, eps=1e-6)
        x2n = layer_norm(x2, eps=1e-6)

        def heads(t):
            return t.view(B, t.shape[1], n, -1)

        q = rope_ops.apply_rope_half(heads(linear(x1n, ca.m1_proj)), *rope_dit)
        k = rope_ops.apply_rope_half(heads(linear(x2n, ca.m2_proj)), *rope_agg)
        v1 = heads(linear(x1n, ca.values_m1_proj))
        v2 = heads(linear(x2n, ca.values_m2_proj))
        o1 = dot_product_attention(q, k, v2)
        o2 = dot_product_attention(k, q, v1)
        dx1 = linear(o1.reshape(B, -1, self.cfg.hidden), ca.out_m1_proj)
        dx2 = linear(o2.reshape(B, -1, self.cfg.hidden), ca.out_m2_proj)
        x1 = x1 + (self.gamma_m1.float() * dx1.float()).to(x1.dtype)
        x2 = x2 + (self.gamma_m2.float() * dx2.float()).to(x2.dtype)
        return x1, x2
