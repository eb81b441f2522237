"""Wan 2.1 3D-causal video VAE (``models/wan/vae.py``) in PyTorch, over the
full time axis at once.

The reference streams the causal convs frame by frame with a feature
cache; the streaming equivalences of the JAX package's docstring give the
same result in one pass:

  * a plain CausalConv3d chain (conv1, residual, head) is a conv left-padded
    in time;
  * Resample 'downsample3d' is frame 0 passed through, then a stride-2
    causal conv over the whole sequence without padding;
  * Resample 'upsample3d' is frame 0 passed through, then a zero-history
    causal conv over frames 1.. whose channel halves become two frames
    (``ops/causal_conv.py:resample_up3d``).

State-dict names are ``Wan2.1_VAE.pth``'s (VideoVAE_): ``encoder.conv1``,
``encoder.downsamples.{i}`` in the layer plan's order, ``encoder.middle.
{0,1,2}``, ``encoder.head.{0,2}``, ``conv1``, ``conv2``, and the same under
``decoder``. The per-frame single-head attention of the middle stays plain
PyTorch, as in the JAX package.

The spatial resample convs run on all frames at once as a batch of images,
even where a tensor holds more than 2^31 elements (the top stage of a
full-size decode: 192 channels x 81 frames x 336 x 592 after the nearest
upsample, 3.1e9): PyTorch splits such a convolution over the batch itself.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.params import normal_
from ...ops.causal_conv import (causal_conv3d, resample_up3d,
                                rms_norm_channel)

LATENT_MEAN = np.array([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
], np.float32)
LATENT_STD = np.array([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
], np.float32)

# the reference's tile grid (inference_wan21.py), in latent pixels
REFERENCE_TILE = ((30, 52), (15, 26))


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temperal_downsample: Tuple[bool, ...] = (False, True, True)
    spatial_down: int = 8

    @property
    def temperal_upsample(self):
        return tuple(reversed(self.temperal_downsample))


def encoder_downsample_plan(cfg: VAEConfig) -> List[Tuple[str, dict]]:
    """(kind, meta) per ``encoder.downsamples`` entry, in order."""
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    plan, scale = [], 1.0
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        d = din
        for _ in range(cfg.num_res_blocks):
            plan.append(("res", {"in": d, "out": dout}))
            if scale in cfg.attn_scales:
                plan.append(("attn", {"dim": dout}))
            d = dout
        if i != len(cfg.dim_mult) - 1:
            mode = "down3d" if cfg.temperal_downsample[i] else "down2d"
            plan.append((mode, {"dim": dout}))
            scale /= 2.0
    return plan


def decoder_upsample_plan(cfg: VAEConfig) -> List[Tuple[str, dict]]:
    """(kind, meta) per ``decoder.upsamples`` entry, in order."""
    dims = [cfg.dim * u
            for u in (cfg.dim_mult[-1],) + tuple(cfg.dim_mult[::-1])]
    plan = []
    scale = 1.0 / 2 ** (len(cfg.dim_mult) - 2)
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        d = din // 2 if i in (1, 2, 3) else din
        for _ in range(cfg.num_res_blocks + 1):
            plan.append(("res", {"in": d, "out": dout}))
            if scale in cfg.attn_scales:
                plan.append(("attn", {"dim": dout}))
            d = dout
        if i != len(cfg.dim_mult) - 1:
            mode = "up3d" if cfg.temperal_upsample[i] else "up2d"
            plan.append((mode, {"dim": dout}))
            scale *= 2.0
    return plan


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class RMSGamma(nn.Module):
    """RMS_norm's scale: (C, 1, 1, 1) over video, (C, 1, 1) over images."""

    def __init__(self, dim: int, images: bool = False):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty((dim, 1, 1) if images
                                              else (dim, 1, 1, 1)))


def _norm_silu(norm: RMSGamma, x: torch.Tensor,
               inplace: bool = False) -> torch.Tensor:
    # SiLU computes in f32 internally and rounds once, as the JAX package's
    # f32 round trip does; ``inplace`` overwrites the normed copy where no
    # gradient is taken
    y = rms_norm_channel(norm.gamma, x)
    return F.silu(y, inplace=inplace and not y.requires_grad)


class ResidualBlock(nn.Module):
    """``inplace``: the SiLUs and the residual sum overwrite tensors the
    block made (the 38-block VAE's decoder, one activation less at its
    widest stage); the values are the same."""

    def __init__(self, din: int, dout: int, inplace: bool = False):
        super().__init__()
        self.inplace = inplace
        self.residual = nn.Sequential(
            RMSGamma(din), nn.SiLU(), nn.Conv3d(din, dout, 3), RMSGamma(dout),
            nn.SiLU(), nn.Identity(), nn.Conv3d(dout, dout, 3))
        self.shortcut = nn.Conv3d(din, dout, 1) if din != dout else None

    def forward(self, x):
        r = self.residual
        h = x if self.shortcut is None else causal_conv3d(self.shortcut, x)
        y = causal_conv3d(r[2], _norm_silu(r[0], x, self.inplace))
        y = causal_conv3d(r[6], _norm_silu(r[3], y, self.inplace))
        return y.add_(h) if self.inplace else y + h


def _conv2d(conv: nn.Conv2d, x: torch.Tensor, **kw) -> torch.Tensor:
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), b, **kw)


class AttentionBlock(nn.Module):
    """Single-head attention over each frame's pixels."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = RMSGamma(dim, images=True)
        self.to_qkv = nn.Conv2d(dim, 3 * dim, 1)
        self.proj = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        B, C, T, H, W = x.shape
        h = x.transpose(1, 2).reshape(B * T, C, H, W)
        n = rms_norm_channel(self.norm.gamma, h)
        q, k, v = _conv2d(self.to_qkv, n).reshape(B * T, 3, C, H * W
                                                  ).unbind(1)
        logits = torch.einsum("bcq,bck->bqk", q.float(), k.float()
                              ) * C ** -0.5
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        o = torch.einsum("bqk,bck->bcq", probs.float(), v.float())
        o = _conv2d(self.proj, o.to(x.dtype).reshape(B * T, C, H, W))
        return x + o.reshape(B, T, C, H, W).transpose(1, 2)


def per_frame(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor
              ) -> torch.Tensor:
    """fn over every frame of x (B, C, T, H, W) as one batch of images."""
    B, C, T, H, W = x.shape
    y = fn(x.transpose(1, 2).reshape(B * T, C, H, W))
    return y.reshape(B, T, *y.shape[1:]).transpose(1, 2)


class Resample(nn.Module):
    """``resample.1`` is the spatial conv (after the nearest 2x upsample,
    or after a (0, 1, 0, 1) zero pad with stride 2); 3d modes add
    ``time_conv``. An upsample halves the channels, or maps them to
    ``up_dim`` (the 38-block VAE keeps them)."""

    def __init__(self, kind: str, dim: int, up_dim: Optional[int] = None):
        super().__init__()
        self.kind = kind
        up = kind.startswith("up")
        out = (dim // 2 if up_dim is None else up_dim) if up else dim
        self.resample = nn.Sequential(nn.Identity(), nn.Conv2d(dim, out, 3))
        self.time_conv = None
        if kind == "up3d":
            self.time_conv = nn.Conv3d(dim, 2 * dim, (3, 1, 1))
        elif kind == "down3d":
            self.time_conv = nn.Conv3d(dim, dim, (3, 1, 1))

    def forward(self, x):
        conv = self.resample[1]
        if self.kind in ("up2d", "up3d"):
            if self.kind == "up3d":
                x = resample_up3d(self.time_conv, x)
            return per_frame(lambda h: _conv2d(
                conv, F.interpolate(h, scale_factor=2.0, mode="nearest"),
                padding=1), x)
        x = per_frame(lambda h: _conv2d(conv, F.pad(h, (0, 1, 0, 1)),
                                        stride=2), x)
        if self.kind == "down3d":
            # frame 0 passes; fewer than 3 frames (a still image) leave it
            # alone
            if x.shape[2] < 3:
                return x[:, :, :1]
            w, b = self.time_conv.weight, self.time_conv.bias
            y = F.conv3d(x, w.to(x.dtype), b.to(x.dtype), stride=(2, 1, 1))
            x = torch.cat([x[:, :, :1], y], dim=2)
        return x


def _plan_modules(plan) -> nn.ModuleList:
    mods = []
    for kind, meta in plan:
        if kind == "res":
            mods.append(ResidualBlock(meta["in"], meta["out"]))
        elif kind == "attn":
            mods.append(AttentionBlock(meta["dim"]))
        else:
            mods.append(Resample(kind, meta["dim"]))
    return nn.ModuleList(mods)


class _Coder(nn.Module):
    """Encoder (``down``) or decoder: conv1, the plan, middle, head."""

    def __init__(self, cfg: VAEConfig, down: bool):
        super().__init__()
        top, z = cfg.dim * cfg.dim_mult[-1], cfg.z_dim
        self.down = down
        self.conv1 = (nn.Conv3d(3, cfg.dim, 3) if down
                      else nn.Conv3d(z, top, 3))
        plan = (encoder_downsample_plan(cfg) if down
                else decoder_upsample_plan(cfg))
        mods = _plan_modules(plan)
        if down:
            self.downsamples = mods
        else:
            self.upsamples = mods
        self.middle = nn.Sequential(ResidualBlock(top, top),
                                    AttentionBlock(top),
                                    ResidualBlock(top, top))
        last = top if down else cfg.dim * cfg.dim_mult[0]
        self.head = nn.Sequential(RMSGamma(last), nn.SiLU(),
                                  nn.Conv3d(last, 2 * z if down else 3, 3))

    def forward(self, x):
        x = causal_conv3d(self.conv1, x)
        if self.down:
            for m in self.downsamples:
                x = m(x)
        for m in self.middle:
            x = m(x)
        if not self.down:
            for m in self.upsamples:
                x = m(x)
        return causal_conv3d(self.head[2], _norm_silu(self.head[0], x))


class WanVAE(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        z = cfg.z_dim
        self.encoder = _Coder(cfg, down=True)
        self.conv1 = nn.Conv3d(2 * z, 2 * z, 1)
        self.conv2 = nn.Conv3d(z, z, 1)
        self.decoder = _Coder(cfg, down=False)

    def init_extra_(self, generator):
        """``init_wan_vae``: convs N(0, fan_in^-1/2) with zero bias, RMS
        scales N(0, 0.02)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                normal_(m.weight, m.weight[0].numel() ** -0.5, generator)
            elif isinstance(m, RMSGamma):
                normal_(m.gamma, 0.02, generator)

    @staticmethod
    def _per_channel(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(values, dtype=like.dtype,
                               device=like.device).view(1, -1, 1, 1, 1)

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """video (B, 3, T, H, W) in [-1, 1] -> normalized latents
        (B, z, (T - 1) / 4 + 1, H / 8, W / 8)."""
        mu = causal_conv3d(self.conv1, self.encoder(video))[:, :self.cfg.z_dim]
        return ((mu - self._per_channel(LATENT_MEAN, mu))
                * self._per_channel(1.0 / LATENT_STD, mu))

    def decode(self, latents: torch.Tensor, clamp: bool = True
               ) -> torch.Tensor:
        """latents (B, z, T', h, w) -> video (B, 3, 4T' - 3, 8h, 8w)."""
        z = (latents * self._per_channel(LATENT_STD, latents)
             + self._per_channel(LATENT_MEAN, latents))
        video = self.decoder(causal_conv3d(self.conv2, z))
        return video.clamp(-1, 1) if clamp else video


# ---------------------------------------------------------------------------
# tiled decode (the reference's linear blend masks)
# ---------------------------------------------------------------------------

def _build_1d_mask(length, left_bound, right_bound, border):
    x = np.ones((length,), np.float32)
    ramp = (np.arange(border) + 1) / border
    if not left_bound:
        x[:border] = ramp
    if not right_bound:
        x[-border:] = ramp[::-1]
    return x


def tiled_blend(fn_one, x: torch.Tensor, tile_size, tile_stride,
                out_scale: float, out_C: int, out_T: int,
                clamp: bool) -> torch.Tensor:
    """Run ``fn_one`` over the reference's spatial tile grid and blend the
    results with its linear border masks into one f32 canvas on x's
    device, in the reference's tile order. Tile size and stride are in
    input pixels; ``out_scale`` maps input to output pixels."""
    B, _, _, H, W = x.shape
    sh, sw = tile_size
    th, tw = tile_stride
    oH, oW = round(H * out_scale), round(W * out_scale)
    values = torch.zeros((B, out_C, out_T, oH, oW), dtype=torch.float32,
                         device=x.device)
    weight = torch.zeros((oH, oW), dtype=torch.float32, device=x.device)
    for h in range(0, H, th):
        if h - th >= 0 and h - th + sh >= H:
            continue
        for w in range(0, W, tw):
            if w - tw >= 0 and w - tw + sw >= W:
                continue
            dec = fn_one(x[:, :, :, h:h + sh, w:w + sw]).float()
            hm = _build_1d_mask(dec.shape[3], h == 0, h + sh >= H,
                                round((sh - th) * out_scale))
            wm = _build_1d_mask(dec.shape[4], w == 0, w + sw >= W,
                                round((sw - tw) * out_scale))
            mask = torch.as_tensor(np.minimum(hm[:, None], wm[None, :]),
                                   device=x.device)
            oh, ow = round(h * out_scale), round(w * out_scale)
            values[..., oh:oh + dec.shape[3], ow:ow + dec.shape[4]] += \
                dec * mask
            weight[oh:oh + dec.shape[3], ow:ow + dec.shape[4]] += mask
            del dec
    out = values / weight
    return (out.clamp(-1, 1) if clamp else out).to(x.dtype)


def vae_decode_tiled(vae: WanVAE, latents: torch.Tensor,
                     tile_size=REFERENCE_TILE[0],
                     tile_stride=REFERENCE_TILE[1]) -> torch.Tensor:
    """Spatially tiled decode; tile size and stride in latent pixels."""
    return tiled_blend(lambda t: vae.decode(t, clamp=False), latents,
                       tile_size, tile_stride, out_scale=8, out_C=3,
                       out_T=latents.shape[2] * 4 - 3, clamp=True)


def vae_encode_tiled(vae: WanVAE, video: torch.Tensor,
                     tile_size=REFERENCE_TILE[0],
                     tile_stride=REFERENCE_TILE[1]) -> torch.Tensor:
    """Spatially tiled encode (``vae_encode_tiled``); tile size and stride
    in latent pixels, as the reference's public API takes them."""
    up = 8
    return tiled_blend(vae.encode, video,
                       (tile_size[0] * up, tile_size[1] * up),
                       (tile_stride[0] * up, tile_stride[1] * up),
                       out_scale=1 / up, out_C=vae.cfg.z_dim,
                       out_T=(video.shape[2] + 3) // 4, clamp=False)


def tile_plan(tile_size: Optional[Tuple[int, int]],
              tile_stride: Optional[Tuple[int, int]]):
    """The reference grid when neither is given; both, or an error."""
    if tile_size is None and tile_stride is None:
        return REFERENCE_TILE
    if tile_size is None or tile_stride is None:
        raise ValueError("give both tile_size and tile_stride, or neither "
                         f"(got tile_size={tile_size}, "
                         f"tile_stride={tile_stride})")
    return tuple(tile_size), tuple(tile_stride)
