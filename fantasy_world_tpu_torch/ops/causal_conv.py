"""Convolutions and the Wan temporal upsampling stage of the DPT heads
(``ops/causal_conv.py``), which the Wan VAE (``models/wan/vae.py``) builds
on: plain ``torch.nn.functional.conv*``, as the JAX package left them to
XLA.

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


# cuDNN indexes a convolution's tensors with 32-bit integers. PyTorch splits
# a larger one over its batch, but a video's single batch row can outgrow
# that (a 38-block VAE decode tile: 512 channels x 121 frames x 240 x 416,
# 6.2e9 elements), so causal_conv3d splits it over time
MAX_CONV_ELEMENTS = 2 ** 31 - 1


def causal_conv3d(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """CausalConv3d: time padded 2*(kt//2) on the left only, space
    symmetrically. x: (B, C, T, H, W). When the input or the output would
    hold more than ``MAX_CONV_ELEMENTS``, it runs over pieces of the time
    axis, each with the 2*(kt//2) frames before it as its history."""
    w = conv.weight.to(x.dtype)
    kt, kh, kw = w.shape[2:]
    pad_t = 2 * (kt // 2)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    B, C, T, H, W = x.shape
    frame = B * max(C, w.shape[0]) * H * W
    piece = MAX_CONV_ELEMENTS // frame - pad_t
    if piece >= T:
        if pad_t:
            x = F.pad(x, (0, 0, 0, 0, pad_t, 0))
        return F.conv3d(x, w, b, padding=(0, kh // 2, kw // 2))
    if piece < 1:
        raise ValueError(f"one frame of {tuple(x.shape)} -> {w.shape[0]} "
                         f"channels outgrows {MAX_CONV_ELEMENTS} elements")
    out = x.new_empty((B, w.shape[0], T, H, W))
    for t0 in range(0, T, piece):
        t1 = min(T, t0 + piece)
        part = x[:, :, max(t0 - pad_t, 0):t1]
        if t0 < pad_t:
            part = F.pad(part, (0, 0, 0, 0, pad_t - t0, 0))
        out[:, :, t0:t1] = F.conv3d(part, w, b, padding=(0, kh // 2, kw // 2))
    return out


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
    """RMS norm over channels (dim 1) * sqrt(C) * gamma ((C, 1, 1, 1) over
    video, (C, 1, 1) over images); the channel norm in f32 without an f32
    copy of x, the rescale in x.dtype."""
    n = torch.linalg.vector_norm(x, dim=1, keepdim=True, dtype=torch.float32)
    inv = x.shape[1] ** 0.5 / torch.clamp(n, min=1e-12)
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
