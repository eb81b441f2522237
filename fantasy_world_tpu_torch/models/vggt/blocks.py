"""VGGT transformer block with timestep AdaLN (``models/vggt/blocks.py``).

Fused-QKV attention with per-head LayerNorm qk-norm and 2D RoPE, pre-norm
residuals with LayerScale, and the e0 modulation; split into
``attn_half``/``ffn_half`` for the fusion model's IRG loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.params import linear, normal_
from ...ops import rope as rope_ops
from ...ops.attention import dot_product_attention
from ...ops.norms import layer_norm, layer_norm_modulate


@dataclasses.dataclass(frozen=True)
class VGGTBlockConfig:
    dim: int = 1024
    num_heads: int = 16
    mlp_ratio: float = 4.0
    qk_norm: bool = True
    init_values: float = 0.01      # LayerScale
    rope_frequency: float = 100.0  # <=0 disables rope (camera-head trunk)
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.empty(dim))

    def init_extra_(self, generator):
        self.gamma.data.fill_(self.init_values)


class Attention(nn.Module):
    def __init__(self, cfg: VGGTBlockConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = nn.Linear(cfg.dim, cfg.dim * 3)
        self.proj = nn.Linear(cfg.dim, cfg.dim)
        if cfg.qk_norm:
            self.q_norm = nn.LayerNorm(cfg.head_dim, eps=cfg.ln_eps)
            self.k_norm = nn.LayerNorm(cfg.head_dim, eps=cfg.ln_eps)

    def forward(self, x: torch.Tensor,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
                seq=None):
        """``vggt_attention``: x (B, N, C); rope a precomputed (cos, sin)
        table pair or None; ``seq``: x's token split over the seq group.
        v stays a strided view of the fused qkv."""
        B, N, C = x.shape
        H, D = self.cfg.num_heads, self.cfg.head_dim
        qkv = linear(x, self.qkv).view(B, N, 3, H, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.cfg.qk_norm:
            q = layer_norm(q, self.q_norm.weight, self.q_norm.bias,
                           self.cfg.ln_eps)
            k = layer_norm(k, self.k_norm.weight, self.k_norm.bias,
                           self.cfg.ln_eps)
        if rope is not None and self.cfg.rope_frequency > 0:
            q = rope_ops.apply_rope_2d_tables(q, *rope)
            k = rope_ops.apply_rope_2d_tables(k, *rope)
        o = dot_product_attention(q, k, v, q_split=seq, kv_split=seq)
        return linear(o.reshape(B, N, C), self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


def modulation_from_e0(table: torch.Tensor, e0: Optional[torch.Tensor],
                       batch: int):
    """(1, 6, C) table + e0 (B, 6, C) -> six f32 (B', 1, C) modifiers,
    e0's batch repeated over frame-folded batches."""
    if e0 is None:
        return None
    if e0.shape[0] != batch:
        e0 = e0.repeat_interleave(batch // e0.shape[0], dim=0)
    m = table.float() + e0.float()
    return tuple(m[:, i:i + 1] for i in range(6))


class VGGTBlock(nn.Module):
    def __init__(self, cfg: VGGTBlockConfig, with_modulation: bool = True):
        super().__init__()
        self.cfg = cfg
        hidden = int(cfg.dim * cfg.mlp_ratio)
        self.norm1 = nn.LayerNorm(cfg.dim, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.ls1 = LayerScale(cfg.dim, cfg.init_values)
        self.norm2 = nn.LayerNorm(cfg.dim, eps=cfg.ln_eps)
        self.mlp = Mlp(cfg.dim, hidden)
        self.ls2 = LayerScale(cfg.dim, cfg.init_values)
        self.modulation = (nn.Parameter(torch.empty(1, 6, cfg.dim))
                           if with_modulation else None)

    def init_extra_(self, generator):
        if self.modulation is not None:
            normal_(self.modulation, 1.0 / math.sqrt(self.cfg.dim), generator)

    def attn_half(self, x, rope=None, e0=None, seq=None):
        """Attention residual; returns (x, e) -- the reference Block's
        return_partial. ``seq``: x's token split over the seq group."""
        e = (modulation_from_e0(self.modulation, e0, x.shape[0])
             if self.modulation is not None else None)
        eps = self.cfg.ln_eps
        if e is not None:
            h = layer_norm_modulate(x, e[0], e[1], self.norm1.weight,
                                    self.norm1.bias, eps)
        else:
            h = layer_norm(x, self.norm1.weight, self.norm1.bias, eps)
        x = x + self.attn(h, rope, seq) * self.ls1.gamma.to(x.dtype)
        return x, e

    def ffn_half(self, x, e):
        """FFN residual with the saved modifiers -- run_remaining."""
        h = layer_norm(x, self.norm2.weight, self.norm2.bias, self.cfg.ln_eps)
        h = linear(F.gelu(linear(h, self.mlp.fc1)), self.mlp.fc2)
        gamma = self.ls2.gamma.to(x.dtype)
        if e is None:
            return x + h * gamma
        out = (h.float() * (1 + e[4]) + e[3]).to(x.dtype) * gamma
        return x + (out.float() * e[5]).to(x.dtype)

    def forward(self, x, rope=None, e0=None, seq=None):
        x, e = self.attn_half(x, rope, e0, seq)
        return self.ffn_half(x, e)
