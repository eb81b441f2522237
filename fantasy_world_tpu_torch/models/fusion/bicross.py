"""Bidirectional cross-modal attention between the DiT and VGGT streams
(``models/fusion/bicross.py``, overall mode): one shared q/k projection
pair drives attention both ways,

    dx1 = softmax(q k^T / sqrt(d)) v2     (video attends geometry)
    dx2 = softmax(k q^T / sqrt(d)) v1     (geometry attends video)

with rotate-half RoPE on q (DiT 3D angles) and k (aggregator angles, zero
for the special tokens) and zero-init per-channel gates on both residuals.
Both directions run the same attention kernel with q/k swapped, reading
them in place.

``forward_temporal`` is the 'temporal' mode (``bicross_apply_temporal``):
the R geometry frames are windowed over the T video frames
(``temporal_slice_plan``) and each video frame's tokens attend only their
window, both ways, with no RoPE. No model path calls it; it is a module
entry point, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
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


def temporal_slice_plan(R: int, window_num: int):
    """The windows of ``auto_temporal_slice`` without a pad mask: R
    geometry frames spread over ``window_num`` windows of ceil(R /
    window_num) slots by the reference's floor arithmetic, so an uneven
    split leaves padded slots. Returns (idx, valid), each (window_num, W):
    the source frame of each slot (0 for padding) and whether it holds
    one."""
    W = math.ceil(R / window_num)
    idx = np.zeros((window_num, W), np.int64)
    valid = np.zeros((window_num, W), bool)
    for i in range(R):
        r = int(math.floor(i * window_num / R))
        k = int(math.floor(i - r * R / window_num))
        if k < W and r < window_num:
            idx[r, k] = i
            valid[r, k] = True
    return idx, valid


def _heads(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.view(*t.shape[:2], n, -1)


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
                rope_dit: Tuple, rope_agg: Tuple, splits=(None, None)
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``bicross_apply``: x1 (B, L1, m1) DiT tokens, x2 (B, L2, m2)
        aggregator tokens -> the gated-residual-updated streams.
        ``splits``: the two streams' token splits over the seq group."""
        s1, s2 = splits
        n, ca = self.cfg.num_heads, self.cross_attn
        B = x1.shape[0]
        x1n = layer_norm(x1, eps=1e-6)
        x2n = layer_norm(x2, eps=1e-6)
        q = rope_ops.apply_rope_half(_heads(linear(x1n, ca.m1_proj), n),
                                     *rope_dit)
        k = rope_ops.apply_rope_half(_heads(linear(x2n, ca.m2_proj), n),
                                     *rope_agg)
        v1 = _heads(linear(x1n, ca.values_m1_proj), n)
        v2 = _heads(linear(x2n, ca.values_m2_proj), n)
        o1 = dot_product_attention(q, k, v2, q_split=s1, kv_split=s2)
        o2 = dot_product_attention(k, q, v1, q_split=s2, kv_split=s1)
        dx1 = linear(o1.reshape(B, -1, self.cfg.hidden), ca.out_m1_proj)
        dx2 = linear(o2.reshape(B, -1, self.cfg.hidden), ca.out_m2_proj)
        return self._gated(x1, x2, dx1, dx2)

    def forward_temporal(self, x1: torch.Tensor, x2: torch.Tensor, T: int,
                         S: int, R: int, M: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``bicross_apply_temporal``: x1 (B, T*S, m1) video tokens, x2
        (B, R*M, m2) geometry tokens. Each of the T video frames attends
        the geometry frames of its window, and those attend it back; no
        RoPE. The padded slots of an uneven split hold zero tokens, whose
        k/v are the projections' biases, and stay attendable: the
        reference's pad mask is a no-op in attention and only selects the
        valid slots when the windows are put back in frame order."""
        cfg, ca = self.cfg, self.cross_attn
        n, B, dev = cfg.num_heads, x1.shape[0], x1.device
        x1n = layer_norm(x1, eps=1e-6)
        x2n = layer_norm(x2, eps=1e-6)
        idx, valid = temporal_slice_plan(R, T)
        W = idx.shape[1]
        x2w = x2n.view(B, R, M, cfg.m2_dim)[
            :, torch.as_tensor(idx.reshape(-1), device=dev)]
        pad = torch.as_tensor(~valid, device=dev).view(1, T, W, 1, 1)
        x2w = x2w.view(B, T, W, M, cfg.m2_dim).masked_fill(pad, 0)
        x2w = x2w.view(B * T, W * M, cfg.m2_dim)
        x1w = x1n.view(B * T, S, cfg.m1_dim)
        q = _heads(linear(x1w, ca.m1_proj), n)
        k = _heads(linear(x2w, ca.m2_proj), n)
        v1 = _heads(linear(x1w, ca.values_m1_proj), n)
        v2 = _heads(linear(x2w, ca.values_m2_proj), n)
        o1 = dot_product_attention(q, k, v2)
        o2 = dot_product_attention(k, q, v1)
        dx1 = linear(o1.reshape(B, T * S, cfg.hidden), ca.out_m1_proj)
        dx2w = linear(o2.reshape(B, T, W, M, cfg.hidden), ca.out_m2_proj)
        # the valid (window, slot) pairs in source-frame order
        rr, kk = np.nonzero(valid)
        order = np.argsort(idx[rr, kk], kind="stable")
        dx2 = dx2w[:, torch.as_tensor(rr[order], device=dev),
                   torch.as_tensor(kk[order], device=dev)]
        return self._gated(x1, x2, dx1, dx2.reshape(B, R * M, cfg.m2_dim))

    def _gated(self, x1, x2, dx1, dx2):
        """The per-channel gated residuals, products in f32."""
        x1 = x1 + (self.gamma_m1.float() * dx1.float()).to(x1.dtype)
        x2 = x2 + (self.gamma_m2.float() * dx2.float()).to(x2.dtype)
        return x1, x2
