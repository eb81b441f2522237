"""umT5-XXL text encoder (``models/wan/t5.py``) in PyTorch.

24 pre-norm T5 blocks: unscaled attention with a per-layer relative
position bias and a padding mask, a tanh-GELU gated FFN, T5 RMS norms with
f32 statistics, and a final norm. State-dict names are the reference
checkpoint's (``models_t5_umt5-xxl-enc-bf16.pth``: ``token_embedding``,
``blocks.{i}.attn.{q,k,v,o}``, ``blocks.{i}.pos_embedding.embedding``,
``blocks.{i}.ffn.{gate.0,fc1,fc2}``, ``norm``).

The attention stays plain PyTorch, as in the JAX package: the additive
bias rules out the flash kernels, and at 512 tokens the f32 logits are
small. It launches no kernel of this port.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.params import RMSNorm, linear, normal_


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128

    @property
    def head_dim(self) -> int:
        return self.dim_attn // self.num_heads


@functools.lru_cache(maxsize=8)
def relative_position_buckets(lq: int, lk: int, num_buckets: int,
                              max_dist: int) -> np.ndarray:
    """Bidirectional T5 buckets, (lq, lk) int."""
    rel = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (np.log(np.maximum(rel, 1) / max_exact)
                         / math.log(max_dist / max_exact)
                         * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(rel < max_exact, rel, large)
    return buckets.astype(np.int64)


def t5_norm(norm: RMSNorm, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps), the factor in f32 rounded to x.dtype,
    times the scale in x.dtype."""
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return norm.weight.to(x.dtype) * (x * inv.to(x.dtype))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.q = nn.Linear(cfg.dim, cfg.dim_attn, bias=False)
        self.k = nn.Linear(cfg.dim, cfg.dim_attn, bias=False)
        self.v = nn.Linear(cfg.dim, cfg.dim_attn, bias=False)
        self.o = nn.Linear(cfg.dim_attn, cfg.dim, bias=False)

    def forward(self, x, pos_bias, mask):
        """pos_bias (1, H, L, L) f32; mask (B, L), 0 where padded."""
        B, L, _ = x.shape
        H, D = self.cfg.num_heads, self.cfg.head_dim
        q = linear(x, self.q).view(B, L, H, D)
        k = linear(x, self.k).view(B, L, H, D)
        v = linear(x, self.v).view(B, L, H, D)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = logits + pos_bias
        if mask is not None:
            logits = logits.masked_fill(mask[:, None, None, :] == 0, -1e30)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
        return linear(o.to(x.dtype).reshape(B, L, H * D), self.o)


class _PosEmbedding(nn.Module):
    def __init__(self, num_buckets: int, num_heads: int):
        super().__init__()
        self.embedding = nn.Embedding(num_buckets, num_heads)


class T5FFN(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.gate = nn.Sequential(nn.Linear(cfg.dim, cfg.dim_ffn, bias=False),
                                  nn.GELU(approximate="tanh"))
        self.fc1 = nn.Linear(cfg.dim, cfg.dim_ffn, bias=False)
        self.fc2 = nn.Linear(cfg.dim_ffn, cfg.dim, bias=False)

    def forward(self, x):
        gate = F.gelu(linear(x, self.gate[0]).float(), approximate="tanh")
        return linear(linear(x, self.fc1) * gate.to(x.dtype), self.fc2)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.norm1 = RMSNorm(cfg.dim)
        self.attn = T5Attention(cfg)
        self.pos_embedding = _PosEmbedding(cfg.num_buckets, cfg.num_heads)
        self.norm2 = RMSNorm(cfg.dim)
        self.ffn = T5FFN(cfg)

    def forward(self, x, buckets, mask):
        bias = self.pos_embedding.embedding.weight.float()[buckets]
        bias = bias.permute(2, 0, 1)[None]                   # (1, H, L, L)
        x = x + self.attn(t5_norm(self.norm1, x), bias, mask)
        return x + self.ffn(t5_norm(self.norm2, x))


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab, cfg.dim)
        self.blocks = nn.ModuleList([T5Block(cfg)
                                     for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.dim)

    def init_extra_(self, generator):
        """``init_t5``'s embeddings: tokens N(0, dim^-1/2), position
        buckets N(0, (2 * buckets * heads)^-1/2)."""
        cfg = self.cfg
        normal_(self.token_embedding.weight, cfg.dim ** -0.5, generator)
        for blk in self.blocks:
            normal_(blk.pos_embedding.embedding.weight,
                    (2 * cfg.num_buckets * cfg.num_heads) ** -0.5, generator)

    def forward(self, ids: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """ids (B, L) int -> (B, L, dim) final-normed hidden states."""
        cfg = self.cfg
        x = self.token_embedding.weight[ids]
        L = ids.shape[1]
        buckets = torch.as_tensor(relative_position_buckets(
            L, L, cfg.num_buckets, cfg.max_dist), device=ids.device)
        for blk in self.blocks:
            x = blk(x, buckets, mask)
        return t5_norm(self.norm, x)
