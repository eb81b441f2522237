"""open-CLIP XLM-RoBERTa ViT-H/14 visual tower (``models/wan/clip.py``) in
PyTorch.

Patch conv (no bias), class token, learned position embedding, a pre-norm,
then pre-norm blocks with exact-GELU MLPs; the Wan pipeline takes the
tokens after the first 31 of the 32 blocks: (B, 257, 1280). State-dict
names are the checkpoint's visual tower (``model.visual.*`` of
``models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth`` without that
prefix); the text tower is never loaded.

Self-attention goes through ``ops/attention.py:dot_product_attention``: 16
heads of 80 over 257 keys take the one-key-block kernel (``onekv``, D
zero-padded to 128) on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.params import linear, normal_
from ...ops.attention import dot_product_attention
from ...ops.bicubic import bicubic_matrix
from ...ops.norms import layer_norm

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: int = 4
    num_heads: int = 16
    num_layers: int = 32
    norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.to_qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class CLIPBlock(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.norm1 = nn.LayerNorm(d, eps=cfg.norm_eps)
        self.attn = _Attention(d)
        self.norm2 = nn.LayerNorm(d, eps=cfg.norm_eps)
        self.mlp = nn.Sequential(nn.Linear(d, d * cfg.mlp_ratio), nn.GELU(),
                                 nn.Linear(d * cfg.mlp_ratio, d))

    def forward(self, x):
        cfg = self.cfg
        B, L, _ = x.shape
        h = layer_norm(x, self.norm1.weight, self.norm1.bias, cfg.norm_eps)
        qkv = linear(h, self.attn.to_qkv).view(B, L, 3, cfg.num_heads, -1)
        o = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        x = x + linear(o.reshape(B, L, cfg.dim), self.attn.proj)
        h = layer_norm(x, self.norm2.weight, self.norm2.bias, cfg.norm_eps)
        h = F.gelu(linear(h, self.mlp[0]).float()).to(x.dtype)
        return x + linear(h, self.mlp[2])


class CLIPVision(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        ps, d = cfg.patch_size, cfg.dim
        self.patch_embedding = nn.Conv2d(3, d, ps, ps, bias=False)
        self.cls_embedding = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embedding = nn.Parameter(torch.empty(1, cfg.num_patches + 1,
                                                      d))
        self.pre_norm = nn.LayerNorm(d, eps=cfg.norm_eps)
        self.transformer = nn.ModuleList([CLIPBlock(cfg)
                                          for _ in range(cfg.num_layers)])

    def init_extra_(self, generator):
        """``init_clip_vision``: patch kernel, class and position embeddings
        N(0, dim^-1/2)."""
        gain = self.cfg.dim ** -0.5
        for t in (self.patch_embedding.weight, self.cls_embedding,
                  self.pos_embedding):
            normal_(t, gain, generator)

    def forward(self, images: torch.Tensor, use_31_block: bool = True
                ) -> torch.Tensor:
        """images (B, 3, 224, 224), CLIP-normalized, in the weights' dtype
        -> (B, 257, dim) tokens after all blocks but the last."""
        cfg = self.cfg
        B, C, H, W = images.shape
        ps = cfg.patch_size
        # kernel==stride patch conv as a reshape and a matmul over
        # (c, py, px)-flattened patches
        x = images.reshape(B, C, H // ps, ps, W // ps, ps)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, (H // ps) * (W // ps),
                                                C * ps * ps)
        w = self.patch_embedding.weight
        x = F.linear(x, w.reshape(w.shape[0], -1).to(x.dtype))
        cls = self.cls_embedding.to(x.dtype).expand(B, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(x.dtype)
        x = layer_norm(x, self.pre_norm.weight, self.pre_norm.bias,
                       cfg.norm_eps)
        n = cfg.num_layers - 1 if use_31_block else cfg.num_layers
        for blk in self.transformer[:n]:
            x = blk(x)
        return x


def preprocess_image(image: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) in [-1, 1] -> f32 bicubic resize to 224 (torch's Keys
    kernel, a = -0.75, half-pixel centres, no antialias) as two f32
    matmuls -> [0, 1] -> CLIP normalization. Stays f32 whatever the
    weights' dtype, as the JAX package runs it at full precision."""
    H, W = image.shape[-2:]
    dev = image.device
    ah = torch.as_tensor(bicubic_matrix(H, 224), dtype=torch.float32,
                         device=dev)
    aw = torch.as_tensor(bicubic_matrix(W, 224), dtype=torch.float32,
                         device=dev)
    x = torch.matmul(torch.matmul(ah, image.float()), aw.t())
    x = x * 0.5 + 0.5
    mean = torch.as_tensor(CLIP_IMAGE_MEAN, device=dev)[None, :, None, None]
    std = torch.as_tensor(CLIP_IMAGE_STD, device=dev)[None, :, None, None]
    return (x - mean) / std
