"""Camera pose encoder (``models/wan/camera.py:camera_pose_encoder_apply``):
Plucker video (B, F, H, W, C) -> pixel-unshuffle(8) -> two 1x1-conv /
GroupNorm stages, each followed by 2x temporal average pooling (81 -> 41 ->
21 frames) -> kernel==stride Conv3d patchify to the DiT width -> MLP to the
Plucker features the per-layer AdaLN adapters consume.

State-dict names are the reference CameraPoseEncoder's
(``controlnet_encode_first.0``, ..., ``fc.4``). The reference's conv widths
are not recorded in this repository: ``HIDDEN_CHANNELS`` stands in for
them, and a real-checkpoint loader must match it to the checkpoint's
shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.params import linear
from ...ops.causal_conv import conv2d
from ...ops.norms import layer_norm

HIDDEN_CHANNELS = 128


@dataclasses.dataclass(frozen=True)
class CameraPoseEncoderConfig:
    in_channels: int = 6          # plucker; 4 for rgb_conf; 12 for 'all'
    downscale: int = 8
    dim: int = 5120
    context_dim: int = 2048
    patch_size: Tuple[int, int, int] = (1, 2, 2)

    @property
    def start_channels(self) -> int:
        return self.in_channels * self.downscale ** 2


def group_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm with f32 statistics and affine, returned in x.dtype."""
    N, C, H, W = x.shape
    g = norm.num_groups
    xf = x.float().reshape(N, g, C // g * H * W)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + norm.eps)).reshape(N, C, H, W)
    y = y * norm.weight.float()[None, :, None, None] \
        + norm.bias.float()[None, :, None, None]
    return y.to(x.dtype)


def compress_time(x: torch.Tensor, frames: int) -> torch.Tensor:
    """(B*F, C, H, W) -> temporal 2x average pool, frame 0 kept when F is
    odd."""
    BF, C, H, W = x.shape
    B = BF // frames
    x = x.reshape(B, frames, C, H, W)
    if frames % 2 == 1:
        rest = x[:, 1:].reshape(B, (frames - 1) // 2, 2, C, H, W).mean(dim=2)
        x = torch.cat([x[:, :1], rest.to(x.dtype)], dim=1)
    else:
        x = x.reshape(B, frames // 2, 2, C, H, W).mean(dim=2).to(x.dtype)
    return x.reshape(-1, C, H, W)


class CameraPoseEncoder(nn.Module):
    def __init__(self, cfg: CameraPoseEncoderConfig):
        super().__init__()
        self.cfg = cfg
        c0, c = cfg.start_channels, HIDDEN_CHANNELS
        self.controlnet_encode_first = nn.Sequential(
            nn.Conv2d(c0, c, 1), nn.GroupNorm(2, c), nn.Conv2d(c, c, 1),
            nn.GroupNorm(2, c), nn.ReLU())
        self.controlnet_encode_second = nn.Sequential(
            nn.Conv2d(c, c, 1), nn.GroupNorm(2, c), nn.ReLU())
        self.patch_embedding = nn.Conv3d(c, cfg.dim, cfg.patch_size,
                                         cfg.patch_size)
        self.fc = nn.Sequential(
            nn.Linear(cfg.dim, cfg.context_dim),
            nn.LayerNorm(cfg.context_dim, eps=1e-5), nn.GELU(),
            nn.Linear(cfg.context_dim, cfg.context_dim),
            nn.LayerNorm(cfg.context_dim, eps=1e-5))

    def forward(self, plucker: torch.Tensor) -> torch.Tensor:
        """(B, F, H, W, C) Plucker video -> (B, L, context_dim)."""
        cfg = self.cfg
        B, Fr, H, W, C = plucker.shape
        x = plucker.permute(0, 1, 4, 2, 3).reshape(B * Fr, C, H, W)
        x = F.pixel_unshuffle(x, cfg.downscale)
        e1, e2 = self.controlnet_encode_first, self.controlnet_encode_second
        x = group_norm(e1[1], conv2d(e1[0], x, padding=(0, 0)))
        x = group_norm(e1[3], conv2d(e1[2], x, padding=(0, 0)))
        x = compress_time(F.relu(x.float()).to(x.dtype), Fr)
        F2 = x.shape[0] // B
        x = group_norm(e2[1], conv2d(e2[0], x, padding=(0, 0)))
        x = compress_time(F.relu(x.float()).to(x.dtype), F2)
        F3 = x.shape[0] // B
        # kernel==stride Conv3d patchify as a reshape and a matmul
        Cc, Hh, Ww = x.shape[1:]
        _, ph, pw = cfg.patch_size
        x = x.reshape(B, F3, Cc, Hh // ph, ph, Ww // pw, pw)
        x = x.permute(0, 1, 3, 5, 2, 4, 6).reshape(
            B, F3 * (Hh // ph) * (Ww // pw), Cc * ph * pw)
        w = self.patch_embedding.weight
        x = F.linear(x, w.reshape(w.shape[0], -1).to(x.dtype),
                     self.patch_embedding.bias.to(x.dtype))
        fc = self.fc
        x = layer_norm(linear(x, fc[0]), fc[1].weight, fc[1].bias, 1e-5)
        x = F.gelu(x.float()).to(x.dtype)
        return layer_norm(linear(x, fc[3]), fc[4].weight, fc[4].bias, 1e-5)
