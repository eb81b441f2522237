"""Wan video diffusion transformer (``models/wan/dit.py``) in PyTorch.

Module attribute paths are the reference WanModel's state-dict names
(``blocks.0.self_attn.q.weight``, ``blocks.0.cross_attn.processor.
k_proj.group1.weight``, ``head.modulation``, ...). As in the JAX package, a
block runs as two halves -- ``attn_half`` and ``ffn_half`` -- which is what
the fusion model's IRG loop interleaves with the geometry stream.

q/k use the contiguous rotate-half RoPE (``ops.rope.apply_rope_half``): the
q/k projection columns are expected in the de-interleaved order that the
JAX converters write (see ``convert/from_jax.py``).

``WanDiT.forward`` is the standalone DiT (``wan_dit_forward``), which the
Wan2.2 TI2V-5B denoise runs (``pipelines/ti2v.py``; ``TI2V_5B`` is its
configuration): its separated timestep modulates the tokens of the fused
first frame at t = 0 (``SplitTokens``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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


# Wan2.2 TI2V-5B (the reference registry's entry 1f5ab770...): a per-token
# timestep and the first-frame latent fused into the sequence, on the
# 38-block VAE's z = 48 latents
TI2V_5B = WanDiTConfig(
    patch_size=(1, 2, 2), in_dim=48, dim=3072, ffn_dim=14336, freq_dim=256,
    text_dim=4096, out_dim=48, num_heads=24, num_layers=30, eps=1e-6,
    seperated_timestep=True, fuse_vae_embedding_in_latents=True,
    require_vae_embedding=False, has_image_input=False)


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


@dataclasses.dataclass(frozen=True)
class SplitTokens:
    """A per-token value that takes one row on the first ``n0`` tokens and
    another on the rest: ``rows`` (B, 2, ...). The TI2V-5B timestep is 0 on
    the tokens of the fused first frame and t on the others, so its time
    embedding, its six block modifiers and the head's two are carried as
    two rows and applied by token range; the (B, L, 6, dim) per-token
    tensor (4 GB in f32 at 704x1280x121) is never made."""
    rows: torch.Tensor
    n0: int

    def map(self, fn) -> "SplitTokens":
        return SplitTokens(fn(self.rows), self.n0)


def by_tokens(fn, tokens, mods) -> torch.Tensor:
    """``fn(*tokens, *mods)`` with (B, 1, dim) modifiers, or, when they are
    ``SplitTokens``, over each token range of the (B, L, ...) ``tokens``
    with its row."""
    if not isinstance(mods[0], SplitTokens):
        return fn(*tokens, *mods)
    n0 = mods[0].n0
    return torch.cat([
        fn(*(t[:, :n0] for t in tokens), *(m.rows[:, 0:1] for m in mods)),
        fn(*(t[:, n0:] for t in tokens), *(m.rows[:, 1:2] for m in mods))],
        dim=1)


def _modulated(x, shift, scale, eps):
    return by_tokens(lambda v, sh, sc: layer_norm_modulate(v, sh, sc,
                                                           eps=eps),
                     (x,), (shift, scale))


def _gated(x, gate, out):
    """x + gate * out: the product in f32, the sum in x's dtype."""
    return by_tokens(lambda v, o, g: v + (g * o.float()).to(v.dtype),
                     (x, out), (gate,))


def dit_block_modulation(table: torch.Tensor, t_mod) -> list:
    """(1, 6, dim) table + t_mod (B, 6, dim) -> six f32 (B, 1, dim);
    ``SplitTokens`` rows (B, 2, 6, dim) -> six ``SplitTokens`` of (B, 2,
    dim)."""
    if isinstance(t_mod, SplitTokens):
        m = table.float()[:, None] + t_mod.rows.float()
        return [SplitTokens(m[:, :, i], t_mod.n0) for i in range(6)]
    m = table.float() + t_mod.float()
    return [m[:, i:i + 1] for i in range(6)]


def time_mlp(time_embedding: nn.Sequential, time_projection: nn.Sequential,
             freq_dim: int, timestep: torch.Tensor):
    """``WanDiT.time_embed`` over its two time modules: timestep (B,) ->
    t (B, dim), t_mod (B, 6, dim); (B, L) -> t (B, L, dim), t_mod
    (B, L, 6, dim)."""
    te = time_embedding
    emb = rope_ops.sinusoidal_embedding_1d(freq_dim, timestep.reshape(-1))
    emb = emb.view(*timestep.shape, freq_dim).to(te[0].weight.dtype)
    t = linear(F.silu(linear(emb, te[0])), te[2])
    t_mod = linear(F.silu(t), time_projection[1])
    return t, t_mod.view(*t.shape[:-1], 6, t.shape[-1])


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
        h = _modulated(x, sh_msa, sc_msa, self.eps)
        x = _gated(x, g_msa, self.self_attn(h, rope_cos, rope_sin))
        x = x + self.cross_attn(
            layer_norm(x, self.norm3.weight, self.norm3.bias, self.eps),
            context, plucker_fea, apply_pose)
        return x, (sh_mlp, sc_mlp, g_mlp)

    def ffn_half(self, x, modifiers):
        sh_mlp, sc_mlp, g_mlp = modifiers
        h = _modulated(x, sh_mlp, sc_mlp, self.eps)
        return _gated(x, g_mlp, _gelu_tanh_mlp(self.ffn, h))

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
        """``head_apply``: f32 shift/scale from the table and t (B, dim)
        or ``SplitTokens`` rows (B, 2, dim)."""
        table = self.modulation.float()
        if isinstance(t, SplitTokens):
            mod = t.map(lambda r: table[:, None] + r.float()[:, :, None])
            shift, scale = (mod.map(lambda m: m[:, :, i]) for i in (0, 1))
        else:
            mod = table + t.float()[:, None]
            shift, scale = mod[:, 0:1], mod[:, 1:2]
        return linear(_modulated(x, shift, scale, self.eps), self.head)


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
        if cfg.has_image_pos_emb:
            raise NotImplementedError("has_image_pos_emb: the end image's "
                                      "CLIP tokens are not ported")
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
        """timestep (B,) -> t (B, dim), t_mod (B, 6, dim); per-token
        (B, L) -> t (B, L, dim), t_mod (B, L, 6, dim)."""
        return time_mlp(self.time_embedding, self.time_projection,
                        self.cfg.freq_dim, timestep)

    def time_embed_split(self, timestep: torch.Tensor, n0: int):
        """The TI2V-5B separated timestep: t = 0 on the first ``n0`` tokens
        and ``timestep`` (B,) on the rest, as ``SplitTokens`` of t
        (B, 2, dim) and t_mod (B, 2, 6, dim)."""
        ts = timestep.float()
        rows = torch.stack([torch.zeros_like(ts), ts], dim=1)
        t, t_mod = self.time_embed(rows)
        return SplitTokens(t, n0), SplitTokens(t_mod, n0)

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

    def forward(self, x, timestep, context, clip_feature=None, y=None,
                plucker_fea=None, fuse_first_frame: bool = False,
                control_tokens=None):
        """The standalone DiT (``wan_dit_forward``): latents (B, C, F, H, W),
        timestep (B,), context (B, L, text_dim) -> noise (B, out_dim, F, H,
        W). With ``seperated_timestep`` and ``fuse_first_frame`` (latent
        frame 0 holds the clean image latent), frame 0's tokens are
        modulated at t = 0 (``SplitTokens``)."""
        cfg = self.cfg
        B, _, Fr, H, W = x.shape
        pt, ph, pw = cfg.patch_size
        if cfg.seperated_timestep and fuse_first_frame:
            t, t_mod = self.time_embed_split(timestep,
                                             (H // ph) * (W // pw))
        else:
            t, t_mod = self.time_embed(timestep)
        ctx = self.text_embed(context)
        if y is not None and cfg.require_vae_embedding:
            x = torch.cat([x, y], dim=1)
        if clip_feature is not None and cfg.has_image_input:
            ctx = torch.cat([self.img_emb(clip_feature), ctx], dim=1)
        tokens, (f, h, w) = self.patchify(x, control_tokens)
        cos, sin = rope_ops.cos_sin_half_from_angles(
            rope_ops.build_angles_3d(cfg.head_dim, f, h, w), tokens.device)
        for i, block in enumerate(self.blocks):
            tokens = block(tokens, ctx, t_mod, cos, sin,
                           plucker_fea=plucker_fea,
                           apply_pose=(plucker_fea is not None
                                       and cfg.has_adapter(i)))
        return self.unpatchify(self.head(tokens, t), (f, h, w))
