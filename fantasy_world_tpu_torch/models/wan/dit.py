"""Wan video diffusion transformer (``models/wan/dit.py``) in PyTorch.

Module attribute paths are the reference WanModel's state-dict names
(``blocks.0.self_attn.q.weight``, ``blocks.0.cross_attn.processor.
k_proj.group1.weight``, ``head.modulation``, ...). As in the JAX package, a
block runs as two halves -- ``attn_half`` and ``ffn_half`` -- which is what
the fusion model's IRG loop interleaves with the geometry stream.

q/k use the contiguous rotate-half RoPE (``ops.rope.apply_rope_half``): the
q/k projection columns are expected in the de-interleaved order that the
JAX converters write (see ``convert/from_jax.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.params import RMSNorm, linear, normal_
from ...ops import rope as rope_ops
from ...ops.attention import dot_product_attention
from ...ops.norms import layer_norm, layer_norm_modulate, rms_norm
from .camera import SimpleAdapter


@dataclasses.dataclass(frozen=True)
class WanDiTConfig:
    dim: int = 5120
    in_dim: int = 36
    ffn_dim: int = 13824
    out_dim: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    eps: float = 1e-6
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_heads: int = 40
    num_layers: int = 40
    has_image_input: bool = True
    has_image_pos_emb: bool = False
    require_vae_embedding: bool = True
    fuse_vae_embedding_in_latents: bool = False
    seperated_timestep: bool = False
    add_control_adapter: bool = False
    in_dim_control_adapter: int = 24
    camera_adapter_end: int = 0
    pose_inject_method: str = "adaln"
    plucker_dim: int = 2048
    clip_feature_dim: int = 1280

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    def has_adapter(self, layer: int) -> bool:
        return layer < self.camera_adapter_end


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.view(b, l, num_heads, d // num_heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, l, h, d = x.shape
    return x.reshape(b, l, h * d)


def _gelu_tanh_mlp(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    return linear(F.gelu(linear(x, seq[0]), approximate="tanh"), seq[2])


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, eps: float):
        super().__init__()
        self.num_heads, self.eps = num_heads, eps
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)
        self.norm_q = RMSNorm(dim)
        self.norm_k = RMSNorm(dim)

    def forward(self, x, rope_cos, rope_sin):
        """RMS-normed q/k with 3D RoPE."""
        n = self.num_heads
        q = rms_norm(linear(x, self.q), self.norm_q.weight, self.eps)
        k = rms_norm(linear(x, self.k), self.norm_k.weight, self.eps)
        v = linear(x, self.v)
        q = rope_ops.apply_rope_half(_split_heads(q, n), rope_cos, rope_sin)
        k = rope_ops.apply_rope_half(_split_heads(k, n), rope_cos, rope_sin)
        o = dot_product_attention(q, k, _split_heads(v, n))
        return linear(_merge_heads(o), self.o)


class _KProj(nn.Module):
    def __init__(self, c: int, d: int, mid: int):
        super().__init__()
        self.group1 = nn.Linear(c, c)
        self.group2 = nn.Sequential(nn.Linear(d, mid), nn.ReLU(),
                                    nn.Linear(mid, c))


class _VProj(nn.Module):
    def __init__(self, c: int, d: int, mid: int):
        super().__init__()
        self.group2 = nn.Sequential(nn.Linear(c, mid), nn.ReLU(),
                                    nn.Linear(mid, d))

    def init_extra_(self, generator):
        # GroupLinearDualV's output starts at zero: the adapter is a no-op
        # until trained
        self.group2[2].weight.data.zero_()
        self.group2[2].bias.data.zero_()


class CameraAdapter(nn.Module):
    """'adaln' pose adapter on the cross-attention output
    (``cross_attention``'s camera branch): a linear on the Plucker stream
    plus a 2-layer MLP on the attention output, mapped to an additive
    shift."""

    def __init__(self, plucker_dim: int, dim: int):
        super().__init__()
        self.k_proj = _KProj(plucker_dim, dim, min(dim, plucker_dim) // 2)
        self.v_proj = _VProj(plucker_dim, dim, plucker_dim // 5)

    def forward(self, o, plucker_fea):
        plucker_proj = linear(plucker_fea, self.k_proj.group1)
        g2 = self.k_proj.group2
        hidden = linear(F.relu(linear(o, g2[0])), g2[2])
        v2 = self.v_proj.group2
        shift = linear(F.relu(linear(hidden + plucker_proj, v2[0])), v2[2])
        # an all-zero Plucker input gates the adapter off; a tensor
        # product, not a host sync
        nonzero = (plucker_fea != 0).any().to(shift.dtype)
        return o + shift * nonzero


class CrossAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, eps: float,
                 has_image_input: bool, camera: Optional[Tuple[int, int]]):
        super().__init__()
        self.num_heads, self.eps = num_heads, eps
        self.has_image_input = has_image_input
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)
        self.norm_q = RMSNorm(dim)
        self.norm_k = RMSNorm(dim)
        if has_image_input:
            self.k_img = nn.Linear(dim, dim)
            self.v_img = nn.Linear(dim, dim)
            self.norm_k_img = RMSNorm(dim)
        self.processor = CameraAdapter(*camera) if camera else None

    def forward(self, x, context, plucker_fea=None, apply_pose=False):
        """Text (+ 257 CLIP image tokens first in ``context``) cross
        attention, then the camera shift when ``apply_pose``."""
        n = self.num_heads
        if self.has_image_input:
            img, ctx = context[:, :257], context[:, 257:]
        else:
            ctx = context
        q = rms_norm(linear(x, self.q), self.norm_q.weight, self.eps)
        k = rms_norm(linear(ctx, self.k), self.norm_k.weight, self.eps)
        v = linear(ctx, self.v)
        qh = _split_heads(q, n)
        o = _merge_heads(dot_product_attention(qh, _split_heads(k, n),
                                               _split_heads(v, n)))
        if self.has_image_input:
            k_img = rms_norm(linear(img, self.k_img), self.norm_k_img.weight,
                             self.eps)
            v_img = linear(img, self.v_img)
            o = o + _merge_heads(dot_product_attention(
                qh, _split_heads(k_img, n), _split_heads(v_img, n)))
        if apply_pose and self.processor is not None \
                and plucker_fea is not None:
            o = self.processor(o, plucker_fea)
        return linear(o, self.o)


def dit_block_modulation(table: torch.Tensor, t_mod: torch.Tensor
                         ) -> List[torch.Tensor]:
    """(1, 6, dim) table + t_mod (B, 6, dim) -> six f32 (B, 1, dim)."""
    m = table.float() + t_mod.float()
    return [m[:, i:i + 1] for i in range(6)]


class DiTBlock(nn.Module):
    def __init__(self, cfg: WanDiTConfig, layer: int):
        super().__init__()
        self.eps = cfg.eps
        self.self_attn = SelfAttention(cfg.dim, cfg.num_heads, cfg.eps)
        camera = ((cfg.plucker_dim, cfg.dim) if cfg.has_adapter(layer)
                  else None)
        if camera and cfg.pose_inject_method != "adaln":
            raise NotImplementedError(cfg.pose_inject_method)
        self.cross_attn = CrossAttention(cfg.dim, cfg.num_heads, cfg.eps,
                                         cfg.has_image_input, camera)
        self.norm3 = nn.LayerNorm(cfg.dim, eps=cfg.eps)
        self.ffn = nn.Sequential(nn.Linear(cfg.dim, cfg.ffn_dim),
                                 nn.GELU(approximate="tanh"),
                                 nn.Linear(cfg.ffn_dim, cfg.dim))
        self.modulation = nn.Parameter(torch.empty(1, 6, cfg.dim))

    def init_extra_(self, generator):
        normal_(self.modulation, 1.0 / math.sqrt(self.modulation.shape[-1]),
                generator)

    def attn_half(self, x, context, t_mod, rope_cos, rope_sin, *,
                  plucker_fea=None, apply_pose=False):
        """Self- and cross-attention residuals; returns (x, the three FFN
        modifiers). The modulation and gated residual are f32."""
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = dit_block_modulation(
            self.modulation, t_mod)
        xd = x.dtype
        h = layer_norm_modulate(x, sh_msa, sc_msa, eps=self.eps)
        x = x + (g_msa * self.self_attn(h, rope_cos, rope_sin).float()
                 ).to(xd)
        x = x + self.cross_attn(
            layer_norm(x, self.norm3.weight, self.norm3.bias, self.eps),
            context, plucker_fea, apply_pose)
        return x, (sh_mlp, sc_mlp, g_mlp)

    def ffn_half(self, x, modifiers):
        sh_mlp, sc_mlp, g_mlp = modifiers
        h = layer_norm_modulate(x, sh_mlp, sc_mlp, eps=self.eps)
        return x + (g_mlp * _gelu_tanh_mlp(self.ffn, h).float()).to(x.dtype)

    def forward(self, x, context, t_mod, rope_cos, rope_sin, *,
                plucker_fea=None, apply_pose=False):
        x, mods = self.attn_half(x, context, t_mod, rope_cos, rope_sin,
                                 plucker_fea=plucker_fea,
                                 apply_pose=apply_pose)
        return self.ffn_half(x, mods)


class Head(nn.Module):
    def __init__(self, cfg: WanDiTConfig):
        super().__init__()
        self.eps = cfg.eps
        self.head = nn.Linear(cfg.dim,
                              cfg.out_dim * int(np.prod(cfg.patch_size)))
        self.modulation = nn.Parameter(torch.empty(1, 2, cfg.dim))

    def init_extra_(self, generator):
        normal_(self.modulation, 1.0 / math.sqrt(self.modulation.shape[-1]),
                generator)

    def forward(self, x, t):
        """``head_apply``: f32 shift/scale from the table and t (B, dim)."""
        mod = self.modulation.float() + t.float()[:, None]
        h = layer_norm_modulate(x, mod[:, 0:1], mod[:, 1:2], eps=self.eps)
        return linear(h, self.head)


class ImageEmbedding(nn.Module):
    def __init__(self, feature_dim: int, dim: int):
        super().__init__()
        self.proj = nn.Sequential(nn.LayerNorm(feature_dim, eps=1e-5),
                                  nn.Linear(feature_dim, feature_dim),
                                  nn.GELU(), nn.Linear(feature_dim, dim),
                                  nn.LayerNorm(dim, eps=1e-5))

    def forward(self, clip_feature):
        """CLIP tokens -> dim (LN, MLP with exact GELU, LN)."""
        p = self.proj
        x = layer_norm(clip_feature, p[0].weight, p[0].bias, 1e-5)
        x = linear(F.gelu(linear(x, p[1])), p[3])
        return layer_norm(x, p[4].weight, p[4].bias, 1e-5)


class WanDiT(nn.Module):
    """Embeddings, 40 blocks and the head of the Wan DiT; the fusion model
    drives the blocks itself."""

    def __init__(self, cfg: WanDiTConfig):
        super().__init__()
        if cfg.has_image_pos_emb or cfg.seperated_timestep:
            raise NotImplementedError("options off the Wan2.1 and Wan2.2 "
                                      "control-camera paths")
        self.cfg = cfg
        self.patch_embedding = nn.Conv3d(cfg.in_dim, cfg.dim,
                                         cfg.patch_size, cfg.patch_size)
        self.text_embedding = nn.Sequential(
            nn.Linear(cfg.text_dim, cfg.dim), nn.GELU(approximate="tanh"),
            nn.Linear(cfg.dim, cfg.dim))
        self.time_embedding = nn.Sequential(
            nn.Linear(cfg.freq_dim, cfg.dim), nn.SiLU(),
            nn.Linear(cfg.dim, cfg.dim))
        self.time_projection = nn.Sequential(
            nn.SiLU(), nn.Linear(cfg.dim, cfg.dim * 6))
        self.blocks = nn.ModuleList([DiTBlock(cfg, i)
                                     for i in range(cfg.num_layers)])
        self.head = Head(cfg)
        if cfg.has_image_input:
            self.img_emb = ImageEmbedding(cfg.clip_feature_dim, cfg.dim)
        if cfg.add_control_adapter:
            self.control_adapter = SimpleAdapter(cfg.in_dim_control_adapter,
                                                 cfg.dim)

    def time_embed(self, timestep: torch.Tensor):
        """timestep (B,) -> t (B, dim), t_mod (B, 6, dim)."""
        te = self.time_embedding
        emb = rope_ops.sinusoidal_embedding_1d(self.cfg.freq_dim, timestep)
        emb = emb.to(te[0].weight.dtype)
        t = linear(F.silu(linear(emb, te[0])), te[2])
        t_mod = linear(F.silu(t), self.time_projection[1])
        return t, t_mod.view(*t.shape[:-1], 6, self.cfg.dim)

    def text_embed(self, context):
        return _gelu_tanh_mlp(self.text_embedding, context)

    def control_adapter_tokens(self, control_camera_latents):
        """The Wan2.2 control-camera adapter in token space, (B, f*h*w,
        dim). It sees only the camera path, so a clip evaluates it once per
        expert and hands the result to every step (``control_tokens``)."""
        ctrl = self.control_adapter(control_camera_latents)
        return ctrl.permute(0, 2, 3, 4, 1).reshape(ctrl.shape[0], -1,
                                                   self.cfg.dim)

    def patchify(self, x, control_tokens=None):
        """(B, C, F, H, W) -> tokens (B, f*h*w, dim) + grid (f, h, w): the
        kernel==stride Conv3d as a reshape and a matmul, patch features in
        (c, dt, dy, dx) order; ``control_tokens`` (batch 1 or B) added to
        the patch embedding."""
        pt, ph, pw = self.cfg.patch_size
        B, C, Fr, H, W = x.shape
        f, h, w = Fr // pt, H // ph, W // pw
        x = x.reshape(B, C, f, pt, h, ph, w, pw)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(B, f * h * w,
                                                       C * pt * ph * pw)
        weight = self.patch_embedding.weight
        tokens = F.linear(x, weight.reshape(weight.shape[0], -1).to(x.dtype),
                          self.patch_embedding.bias.to(x.dtype))
        if control_tokens is not None:
            tokens = tokens + control_tokens
        return tokens, (f, h, w)

    def unpatchify(self, x, grid):
        f, h, w = grid
        pt, ph, pw = self.cfg.patch_size
        B = x.shape[0]
        x = x.reshape(B, f, h, w, pt, ph, pw, self.cfg.out_dim)
        x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(B, self.cfg.out_dim, f * pt, h * ph, w * pw)
