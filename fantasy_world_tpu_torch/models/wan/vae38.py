"""Wan2.2 38-block video VAE (``models/wan/vae38.py``) in PyTorch: 16x
spatial, 4x temporal, z = 48, the TI2V-5B model's VAE.

Against the 2.1 VAE (``models/wan/vae.py``, whose residual, attention and
resample layers and causal convs it reuses):

  * the video is pixel-unshuffled 2x2 before the encoder and shuffled back
    after the decoder (12 channels in and out);
  * every stage is a residual macro block: the conv path plus a
    parameter-free shortcut, ``avg_down3d`` when encoding and ``dup_up3d``
    when decoding;
  * upsampling keeps the channel count, and the decoder is wider (dec_dim
    256) than the encoder (dim 160).

The whole time axis runs at once, as in the 2.1 VAE; the shortcuts are
frame-local reshapes, and ``dup_up3d``'s ``first_chunk`` trim of the
reference's first streamed chunk becomes a trim of the leading frames.

State-dict names are ``Wan2.2_VAE.pth``'s (VideoVAE38_, without its
``model.`` prefix): ``encoder.downsamples.{i}.downsamples.{j}``,
``decoder.upsamples.{i}.upsamples.{j}`` (the resample last), ``middle``,
``head``, ``conv1``, ``conv2``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...ops.causal_conv import causal_conv3d
from .vae import (AttentionBlock, ResidualBlock, Resample, RMSGamma,
                  WanVAE, _norm_silu, tiled_blend)

LATENT38_MEAN = np.array([
    -0.2289, -0.0052, -0.1323, -0.2339, -0.2799, 0.0174, 0.1838, 0.1557,
    -0.1382, 0.0542, 0.2813, 0.0891, 0.1570, -0.0098, 0.0375, -0.1825,
    -0.2246, -0.1207, -0.0698, 0.5109, 0.2665, -0.2108, -0.2158, 0.2502,
    -0.2055, -0.0322, 0.1109, 0.1567, -0.0729, 0.0899, -0.2799, -0.1230,
    -0.0313, -0.1649, 0.0117, 0.0723, -0.2839, -0.2083, -0.0520, 0.3748,
    0.0152, 0.1957, 0.1433, -0.2944, 0.3573, -0.0548, -0.1681, -0.0667,
], np.float32)
LATENT38_STD = np.array([
    0.4765, 1.0364, 0.4514, 1.1677, 0.5313, 0.4990, 0.4818, 0.5013,
    0.8158, 1.0344, 0.5894, 1.0901, 0.6885, 0.6165, 0.8454, 0.4978,
    0.5759, 0.3523, 0.7135, 0.6804, 0.5833, 1.4146, 0.8986, 0.5659,
    0.7069, 0.5338, 0.4889, 0.4917, 0.4069, 0.4999, 0.6866, 0.4093,
    0.5709, 0.6065, 0.6415, 0.4944, 0.5726, 1.2042, 0.5458, 1.6887,
    0.3971, 1.0600, 0.3943, 0.5537, 0.5444, 0.4089, 0.7468, 0.7744,
], np.float32)

@dataclasses.dataclass(frozen=True)
class VAE38Config:
    dim: int = 160
    dec_dim: int = 256
    z_dim: int = 48
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temperal_downsample: Tuple[bool, ...] = (False, True, True)
    # the 2x pixel unshuffle times the encoder's 8x
    spatial_down: int = 16

    @property
    def temperal_upsample(self):
        return tuple(reversed(self.temperal_downsample))


# ---------------------------------------------------------------------------
# pixel (un)shuffle and the parameter-free shortcuts
# ---------------------------------------------------------------------------

def patchify2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, F, 2h, 2w) -> (B, 4C, F, h, w), channels in (c, r, q) order,
    q the height phase and r the width phase."""
    B, C, Fr, H, W = x.shape
    x = x.reshape(B, C, Fr, H // 2, 2, W // 2, 2)       # ... h q w r
    x = x.permute(0, 1, 6, 4, 2, 3, 5)                  # B C r q F h w
    return x.reshape(B, C * 4, Fr, H // 2, W // 2)


def unpatchify2(x: torch.Tensor) -> torch.Tensor:
    B, C4, Fr, h, w = x.shape
    x = x.reshape(B, C4 // 4, 2, 2, Fr, h, w)           # B C r q F h w
    x = x.permute(0, 1, 4, 5, 3, 6, 2)                  # B C F h q w r
    return x.reshape(B, C4 // 4, Fr, h * 2, w * 2)


def avg_down3d(x: torch.Tensor, out_channels: int, factor_t: int,
               factor_s: int = 1) -> torch.Tensor:
    """AvgDown3D: time zero-padded at the front to a multiple of
    ``factor_t``, space-time folded into channels, then the mean of each
    group of channels, in f32."""
    B, C, T, H, W = x.shape
    pad_t = (factor_t - T % factor_t) % factor_t
    if pad_t:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, pad_t, 0))
        T += pad_t
    fs = factor_s
    x = x.reshape(B, C, T // factor_t, factor_t, H // fs, fs, W // fs, fs)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)     # B C ft fsh fsw T' H' W'
    x = x.reshape(B, out_channels, -1, T // factor_t, H // fs, W // fs)
    return x.float().mean(dim=2).to(x.dtype)


def dup_up3d(x: torch.Tensor, out_channels: int, factor_t: int,
             factor_s: int = 1, first_chunk: bool = False) -> torch.Tensor:
    """DupUp3D: channels repeated, then unfolded into space-time;
    ``first_chunk`` drops the leading ``factor_t - 1`` frames, which the
    causal decode of the first latent frame does not make."""
    B, C, T, H, W = x.shape
    fs = factor_s
    repeats = out_channels * factor_t * fs * fs // C
    x = x.repeat_interleave(repeats, dim=1)
    x = x.reshape(B, out_channels, factor_t, fs, fs, T, H, W)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)     # B C T ft H fsh W fsw
    x = x.reshape(B, out_channels, T * factor_t, H * fs, W * fs)
    if first_chunk and factor_t > 1:
        x = x[:, :, factor_t - 1:]
    return x


# ---------------------------------------------------------------------------
# stage plans and macro blocks
# ---------------------------------------------------------------------------

def encoder38_stages(cfg: VAE38Config) -> List[dict]:
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    return [{"in": din, "out": dout,
             "t_down": (cfg.temperal_downsample[i]
                        if i < len(cfg.temperal_downsample) else False),
             "down": i != len(cfg.dim_mult) - 1}
            for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:]))]


def decoder38_stages(cfg: VAE38Config) -> List[dict]:
    dims = [cfg.dec_dim * u
            for u in (cfg.dim_mult[-1],) + tuple(cfg.dim_mult[::-1])]
    return [{"in": din, "out": dout,
             "t_up": (cfg.temperal_upsample[i]
                      if i < len(cfg.temperal_upsample) else False),
             "up": i != len(cfg.dim_mult) - 1}
            for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:]))]


def _res_chain(stage: dict, n: int) -> List[nn.Module]:
    return [ResidualBlock(stage["in"] if j == 0 else stage["out"],
                          stage["out"], inplace=True) for j in range(n)]


class DownResidualBlock(nn.Module):
    """Down_ResidualBlock: residual blocks and the downsample, plus the
    ``avg_down3d`` shortcut of the stage's input."""

    def __init__(self, stage: dict, num_res_blocks: int):
        super().__init__()
        self.stage = stage
        mods = _res_chain(stage, num_res_blocks)
        if stage["down"]:
            mods.append(Resample("down3d" if stage["t_down"] else "down2d",
                                 stage["out"]))
        self.downsamples = nn.Sequential(*mods)

    def forward(self, x):
        st = self.stage
        h = avg_down3d(x, st["out"], 2 if st["t_down"] else 1,
                       2 if st["down"] else 1)
        for m in self.downsamples:
            x = m(x)
        return x + h


# elements of one piece of the dup_up3d shortcut (see _add_dup_up3d)
SHORTCUT_PIECE = 1 << 28


def _add_dup_up3d(x: torch.Tensor, x_in: torch.Tensor, out_channels: int,
                  factor_t: int, factor_s: int) -> torch.Tensor:
    """x += dup_up3d(x_in, ..., first_chunk=True), made a few input frames
    at a time: the shortcut is frame-local, so the decoder's widest stage
    never holds it whole (12.4 GB at a TI2V-5B tile)."""
    B, C, T, H, W = x_in.shape
    frame = B * out_channels * factor_t * factor_s ** 2 * H * W
    per = max(1, SHORTCUT_PIECE // frame)
    trim = factor_t - 1
    for s0 in range(0, T, per):
        h = dup_up3d(x_in[:, :, s0:s0 + per], out_channels, factor_t,
                     factor_s)
        o0 = s0 * factor_t - trim
        if o0 < 0:
            h, o0 = h[:, :, -o0:], 0
        x[:, :, o0:o0 + h.shape[2]] += h
    return x


class UpResidualBlock(nn.Module):
    """Up_ResidualBlock: residual blocks and the channel-keeping upsample,
    plus, when the stage upsamples, the ``dup_up3d`` shortcut."""

    def __init__(self, stage: dict, num_res_blocks: int):
        super().__init__()
        self.stage = stage
        mods = _res_chain(stage, num_res_blocks + 1)
        if stage["up"]:
            mods.append(Resample("up3d" if stage["t_up"] else "up2d",
                                 stage["out"], up_dim=stage["out"]))
        self.upsamples = nn.Sequential(*mods)

    def forward(self, x):
        st, x_in = self.stage, x
        for m in self.upsamples:
            x = m(x)
        if not st["up"]:
            return x
        return _add_dup_up3d(x, x_in, st["out"], 2 if st["t_up"] else 1, 2)


class Encoder38(nn.Module):
    def __init__(self, cfg: VAE38Config):
        super().__init__()
        stages = encoder38_stages(cfg)
        top = stages[-1]["out"]
        self.conv1 = nn.Conv3d(12, cfg.dim, 3)
        self.downsamples = nn.ModuleList([
            DownResidualBlock(s, cfg.num_res_blocks) for s in stages])
        self.middle = nn.Sequential(ResidualBlock(top, top, inplace=True),
                                    AttentionBlock(top),
                                    ResidualBlock(top, top, inplace=True))
        self.head = nn.Sequential(RMSGamma(top), nn.SiLU(),
                                  nn.Conv3d(top, 2 * cfg.z_dim, 3))

    def forward(self, x):
        x = causal_conv3d(self.conv1, x)
        for m in self.downsamples:
            x = m(x)
        for m in self.middle:
            x = m(x)
        return causal_conv3d(self.head[2],
                             _norm_silu(self.head[0], x, inplace=True))


class Decoder38(nn.Module):
    def __init__(self, cfg: VAE38Config):
        super().__init__()
        stages = decoder38_stages(cfg)
        top, last = stages[0]["in"], stages[-1]["out"]
        self.conv1 = nn.Conv3d(cfg.z_dim, top, 3)
        self.middle = nn.Sequential(ResidualBlock(top, top, inplace=True),
                                    AttentionBlock(top),
                                    ResidualBlock(top, top, inplace=True))
        self.upsamples = nn.ModuleList([
            UpResidualBlock(s, cfg.num_res_blocks) for s in stages])
        self.head = nn.Sequential(RMSGamma(last), nn.SiLU(),
                                  nn.Conv3d(last, 12, 3))

    def forward(self, z):
        x = causal_conv3d(self.conv1, z)
        for m in self.middle:
            x = m(x)
        for m in self.upsamples:
            x = m(x)
        return causal_conv3d(self.head[2],
                             _norm_silu(self.head[0], x, inplace=True))


class WanVAE38(nn.Module):
    def __init__(self, cfg: VAE38Config = VAE38Config()):
        super().__init__()
        self.cfg = cfg
        z = cfg.z_dim
        self.encoder = Encoder38(cfg)
        self.conv1 = nn.Conv3d(2 * z, 2 * z, 1)
        self.conv2 = nn.Conv3d(z, z, 1)
        self.decoder = Decoder38(cfg)

    # the 2.1 VAE's random init: convs N(0, fan_in^-1/2), RMS scales
    # N(0, 0.02)
    init_extra_ = WanVAE.init_extra_
    _per_channel = staticmethod(WanVAE._per_channel)

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """video (B, 3, T, H, W) in [-1, 1] -> normalized latents
        (B, 48, (T - 1) / 4 + 1, H / 16, W / 16)."""
        out = self.encoder(patchify2(video))
        mu = causal_conv3d(self.conv1, out)[:, :self.cfg.z_dim]
        return ((mu - self._per_channel(LATENT38_MEAN, mu))
                * self._per_channel(1.0 / LATENT38_STD, mu))

    def decode(self, latents: torch.Tensor, clamp: bool = True
               ) -> torch.Tensor:
        """latents (B, 48, T', h, w) -> video (B, 3, 4T' - 3, 16h, 16w)."""
        z = (latents * self._per_channel(LATENT38_STD, latents)
             + self._per_channel(LATENT38_MEAN, latents))
        video = unpatchify2(self.decoder(causal_conv3d(self.conv2, z)))
        return video.clamp(-1, 1) if clamp else video


def vae38_decode_tiled(vae: WanVAE38, latents: torch.Tensor,
                       tile_size=(34, 34), tile_stride=(18, 16)
                       ) -> torch.Tensor:
    """Spatially tiled decode over the 2.1 VAE's blend (16 output pixels a
    latent pixel); tile size and stride in latent pixels."""
    return tiled_blend(lambda t: vae.decode(t, clamp=False), latents,
                       tile_size, tile_stride, out_scale=16, out_C=3,
                       out_T=latents.shape[2] * 4 - 3, clamp=True)


def vae38_encode_tiled(vae: WanVAE38, video: torch.Tensor,
                       tile_size=(34, 34), tile_stride=(18, 16)
                       ) -> torch.Tensor:
    """Spatially tiled encode; tile size and stride in latent pixels."""
    up = 16
    return tiled_blend(vae.encode, video,
                       (tile_size[0] * up, tile_size[1] * up),
                       (tile_stride[0] * up, tile_stride[1] * up),
                       out_scale=1 / up, out_C=vae.cfg.z_dim,
                       out_T=(video.shape[2] + 3) // 4, clamp=False)
