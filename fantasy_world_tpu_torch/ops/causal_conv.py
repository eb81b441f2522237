"""Convolutions and the Wan temporal upsampling stage of the DPT heads
(``ops/causal_conv.py``): plain ``torch.nn.functional.conv*``, as the JAX
package left them to XLA.

Full-sequence equivalents of the reference's streamed causal convs: frame 0
bypasses each temporal 2x upsample, frames 1..T-1 go through a zero-history
causal conv whose 2C outputs become two consecutive frames, so one stage
maps T frames to 1 + 2*(T-1).

Each function takes the torch module that owns the weights (torch layout,
(O, I, ...)) and computes in the input dtype; on the card an f32 conv would
run in TF32 unless ``torch.backends.cudnn.allow_tf32`` is off (the port
runs bf16 there).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv2d(conv: nn.Module, x: torch.Tensor, *, stride=(1, 1),
           padding="SAME") -> torch.Tensor:
    """NCHW conv; "SAME" pads k//2 on each side, else (ph, pw)."""
    w = conv.weight.to(x.dtype)
    if padding == "SAME":
        padding = (w.shape[2] // 2, w.shape[3] // 2)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def causal_conv3d(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """CausalConv3d: time padded 2*(kt//2) on the left only, space
    symmetrically. x: (B, C, T, H, W)."""
    w = conv.weight.to(x.dtype)
    kt, kh, kw = w.shape[2:]
    if kt > 1:
        x = F.pad(x, (0, 0, 0, 0, 2 * (kt // 2), 0))
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv3d(x, w, b, padding=(0, kh // 2, kw // 2))


def _time_double(y: torch.Tensor) -> torch.Tensor:
    """(B, 2C, T, H, W) -> (B, C, 2T, H, W): the channel halves become
    consecutive frames."""
    B, C2, T, H, W = y.shape
    y = y.reshape(B, 2, C2 // 2, T, H, W)
    return torch.stack([y[:, 0], y[:, 1]], dim=3).reshape(B, C2 // 2, 2 * T,
                                                          H, W)


def resample_up3d(time_conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """Temporal 2x upsample: T -> 1 + 2*(T-1)."""
    y = causal_conv3d(time_conv, x[:, :, 1:])
    return torch.cat([x[:, :, :1], _time_double(y)], dim=2)


def rms_norm_channel(gamma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """RMS norm over channels (dim 1) * sqrt(C) * gamma (C, 1, 1, 1); f32
    statistics, the rescale in x.dtype."""
    ss = x.float().square().sum(dim=1, keepdim=True)
    inv = x.shape[1] ** 0.5 / torch.clamp(ss.sqrt(), min=1e-12)
    return x * inv.to(x.dtype) * gamma.to(x.dtype)


class RMSNormChannel(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim, 1, 1, 1))

    def init_extra_(self, generator):
        self.gamma.data.fill_(1.0)


class Resample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.time_conv = nn.Conv3d(dim, dim * 2, (3, 1, 1))


class ResidualBlockHalf(nn.Module):
    """RMS norm -> SiLU -> causal 3x3x3 conv, plus the identity shortcut."""

    def __init__(self, dim: int):
        super().__init__()
        self.residual = nn.Sequential(RMSNormChannel(dim), nn.SiLU(),
                                      nn.Conv3d(dim, dim, 3))

    def forward(self, x):
        y = rms_norm_channel(self.residual[0].gamma, x)
        y = F.silu(y.float()).to(x.dtype)
        return causal_conv3d(self.residual[2], y) + x


class _Decoder(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.upsamples = nn.ModuleList([Resample(dim), ResidualBlockHalf(dim),
                                        Resample(dim), ResidualBlockHalf(dim)])


class WanVAEDPTUpsampler(nn.Module):
    """WanVAE_(location='DPT').decode: 1x1x1 causal conv, then [up3d,
    ResBlockHalf, up3d, ResBlockHalf]; T -> 1 + 4*(T-1)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv2 = nn.Conv3d(dim, dim, 1)
        self.decoder = _Decoder(dim)

    def forward(self, z):
        up = self.decoder.upsamples
        x = causal_conv3d(self.conv2, z)
        x = resample_up3d(up[0].time_conv, x)
        x = up[1](x)
        x = resample_up3d(up[2].time_conv, x)
        return up[3](x)


def channel_expand_reshape(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """ChannelExpandAndReshape: kernel-1 Conv1d C -> 4C on (B, N, C) tokens,
    then the blocked reshape to 4N tokens: out[4c + j, n] -> [c, j*N + n]."""
    B, N, C = x.shape
    y = F.linear(x, conv.weight[:, :, 0].to(x.dtype), conv.bias.to(x.dtype))
    y = y.transpose(1, 2).reshape(B, C, 4 * N)
    return y.transpose(1, 2)
