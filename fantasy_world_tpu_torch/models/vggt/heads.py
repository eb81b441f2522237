"""VGGT prediction heads (``models/vggt/heads.py``): the iterative camera
head and the causal-3D DPT head (in ``feature_only`` mode, the track
head's feature extractor).

Stage 3 of the DPT head is strictly per frame; ``DPTHead.forward`` runs it
in chunks of ``STAGE3_FRAMES`` frames (concatenating the results is exact),
which bounds its memory at the full 81-frame, 336x592 output: one chunk's
f32 bilinear upsample is ~0.8 GB there.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.params import linear
from ...ops.causal_conv import (WanVAEDPTUpsampler, channel_expand_reshape,
                                conv2d)
from ...ops.interpolate import bilinear_align_corners
from ...ops.norms import layer_norm, modulate
from .blocks import VGGTBlock, VGGTBlockConfig

STAGE3_FRAMES = 8


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def inverse_log_transform(y):
    return torch.sign(y) * torch.expm1(y.abs())


def base_pose_act(x, act: str):
    if act == "linear":
        return x
    if act == "inv_log":
        return inverse_log_transform(x)
    if act == "exp":
        return torch.exp(x)
    if act == "relu":
        return F.relu(x)
    raise ValueError(act)


def activate_pose(pred, trans_act="linear", quat_act="linear",
                  fl_act="relu"):
    return torch.cat([base_pose_act(pred[..., :3], trans_act),
                      base_pose_act(pred[..., 3:7], quat_act),
                      base_pose_act(pred[..., 7:], fl_act)], dim=-1)


def activate_head(out, activation="inv_log", conf_activation="expp1"):
    """out (N, C, H, W) -> (pts (N, H, W, C-1), conf (N, H, W)), f32."""
    fmap = out.permute(0, 2, 3, 1).float()
    xyz, conf = fmap[..., :-1], fmap[..., -1]
    if activation == "exp":
        pts = torch.exp(xyz)
    elif activation == "inv_log":
        pts = inverse_log_transform(xyz)
    elif activation == "relu":
        pts = F.relu(xyz)
    elif activation == "linear":
        pts = xyz
    elif activation == "norm_exp":
        d = torch.clamp(torch.linalg.norm(xyz, dim=-1, keepdim=True), min=1e-8)
        pts = xyz / d * torch.expm1(d)
    else:
        raise ValueError(activation)
    if conf_activation == "expp1":
        conf = 1 + torch.exp(conf)
    elif conf_activation == "expp0":
        conf = torch.exp(conf)
    elif conf_activation == "sigmoid":
        conf = torch.sigmoid(conf)
    else:
        raise ValueError(conf_activation)
    return pts, conf


# ---------------------------------------------------------------------------
# camera head
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CameraHeadConfig:
    dim_in: int = 2048
    trunk_depth: int = 4
    num_heads: int = 16
    mlp_ratio: float = 4.0
    init_values: float = 0.01
    target_dim: int = 9
    trans_act: str = "linear"
    quat_act: str = "linear"
    fl_act: str = "relu"

    @property
    def block_cfg(self) -> VGGTBlockConfig:
        # trunk blocks: no qk-norm, no rope
        return VGGTBlockConfig(dim=self.dim_in, num_heads=self.num_heads,
                               mlp_ratio=self.mlp_ratio, qk_norm=False,
                               init_values=self.init_values,
                               rope_frequency=-1.0)


class _PoseBranch(nn.Module):
    def __init__(self, d: int, target_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(d, d // 2)
        self.fc2 = nn.Linear(d // 2, target_dim)


class _ChannelExpand(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.expand_channels = nn.Conv1d(d, 4 * d, 1)

    def init_extra_(self, generator):
        self.expand_channels.weight.data.zero_()
        self.expand_channels.bias.data.zero_()


class CameraHead(nn.Module):
    def __init__(self, cfg: CameraHeadConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim_in
        self.trunk = nn.ModuleList([VGGTBlock(cfg.block_cfg)
                                    for _ in range(cfg.trunk_depth)])
        self.token_norm = nn.LayerNorm(d, eps=1e-5)
        self.trunk_norm = nn.LayerNorm(d, eps=1e-5)
        self.empty_pose_tokens = nn.Parameter(torch.empty(1, 1,
                                                          cfg.target_dim))
        self.embed_pose = nn.Linear(cfg.target_dim, d)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 3 * d))
        self.camera_time_upsample = _ChannelExpand(d)
        self.pose_branch = _PoseBranch(d, cfg.target_dim)

    def init_extra_(self, generator):
        self.empty_pose_tokens.data.zero_()

    def forward(self, last_tokens: torch.Tensor,
                num_iterations: int = 4) -> List[torch.Tensor]:
        """``camera_head_forward``: last_tokens (B, S, P, 2C); the camera
        token of frames >= 1 is upsampled 4x in time (skipping token_norm,
        as trained), then iterative AdaLN refinement."""
        cfg = self.cfg
        pose_tokens = last_tokens[:, :, 0]
        upsampled = channel_expand_reshape(
            self.camera_time_upsample.expand_channels, pose_tokens[:, 1:])
        normed = layer_norm(pose_tokens, self.token_norm.weight,
                            self.token_norm.bias, 1e-5)
        pose_tokens = torch.cat([normed[:, 0:1], upsampled], dim=1)
        B = pose_tokens.shape[0]
        preds, pred = [], None
        for _ in range(num_iterations):
            if pred is None:
                inp = self.empty_pose_tokens.to(pose_tokens.dtype).expand(
                    B, 1, cfg.target_dim)
            else:
                inp = pred
            mod_in = linear(F.silu(linear(inp, self.embed_pose).float()
                                   ).to(pose_tokens.dtype),
                            self.poseLN_modulation[1])
            shift, scale, gate = mod_in.chunk(3, dim=-1)
            h = layer_norm(pose_tokens, eps=1e-6)
            h = gate * modulate(h, shift, scale) + pose_tokens
            for blk in self.trunk:
                h = blk(h)
            h = layer_norm(h, self.trunk_norm.weight, self.trunk_norm.bias,
                           1e-5)
            pb = self.pose_branch
            delta = linear(F.gelu(linear(h, pb.fc1)), pb.fc2)
            pred = delta if pred is None else pred + delta
            preds.append(activate_pose(pred, cfg.trans_act, cfg.quat_act,
                                       cfg.fl_act))
        return preds


# ---------------------------------------------------------------------------
# DPT head (causal-3D)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DPTHeadConfig:
    dim_in: int = 2048
    patch_size: int = 16
    output_dim: int = 4
    activation: str = "inv_log"
    conf_activation: str = "expp1"
    features: int = 256
    out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    intermediate_layer_idx: Tuple[int, ...] = (23, 17, 11, 7)
    pos_embed: bool = True
    down_ratio: int = 1
    feature_only: bool = False


@functools.lru_cache(maxsize=16)
def _pos_embed_2d(n_ch: int, h: int, w: int, full_w: int, full_h: int,
                  ratio: float = 0.1) -> np.ndarray:
    """UV-grid sin/cos position embedding, host float64 -> (n_ch, h, w)
    f32. Cached: at the 336x592 output it costs ~0.7 s of host time, and
    the frame-chunked stage 3 asks for it once per chunk."""
    aspect = full_w / full_h
    diag = (aspect ** 2 + 1.0) ** 0.5
    span_x, span_y = aspect / diag, 1.0 / diag
    xs = np.linspace(-span_x * (w - 1) / w, span_x * (w - 1) / w, w)
    ys = np.linspace(-span_y * (h - 1) / h, span_y * (h - 1) / h, h)
    uu, vv = np.meshgrid(xs, ys, indexing="xy")
    grid = np.stack([uu, vv], axis=-1)

    def sincos(dim, pos, omega_0=100.0):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / omega_0 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb = np.concatenate([sincos(n_ch // 2, grid[..., 0]),
                          sincos(n_ch // 2, grid[..., 1])], axis=-1)
    out = (emb.reshape(h, w, n_ch).transpose(2, 0, 1) * ratio
           ).astype(np.float32)
    out.flags.writeable = False
    return out


def _add_pos_embed(x: torch.Tensor, full_w: int, full_h: int) -> torch.Tensor:
    pe = torch.tensor(_pos_embed_2d(x.shape[1], x.shape[2], x.shape[3],
                                    full_w, full_h), device=x.device)
    return x + pe.to(x.dtype)


class _ResConfUnit(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)

    def forward(self, x):
        # the reference's in-place ReLU also feeds the skip connection
        x = F.relu(x.float()).to(x.dtype)
        h = F.relu(conv2d(self.conv1, x).float()).to(x.dtype)
        return conv2d(self.conv2, h) + x


class FusionBlock(nn.Module):
    def __init__(self, f: int, has_residual: bool = True):
        super().__init__()
        self.out_conv = nn.Conv2d(f, f, 1)
        if has_residual:
            self.resConfUnit1 = _ResConfUnit(f)
        self.resConfUnit2 = _ResConfUnit(f)

    def forward(self, x, res=None, size=None):
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        if size is None:
            size = (x.shape[-2] * 2, x.shape[-1] * 2)
        x = bilinear_align_corners(x, size)
        return conv2d(self.out_conv, x, padding=(0, 0))


class _Scratch(nn.Module):
    def __init__(self, cfg: DPTHeadConfig):
        super().__init__()
        f, oc = cfg.features, cfg.out_channels
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(oc[i], f, 3, padding=1, bias=False))
        self.refinenet1 = FusionBlock(f)
        self.refinenet2 = FusionBlock(f)
        self.refinenet3 = FusionBlock(f)
        self.refinenet4 = FusionBlock(f, has_residual=False)
        if cfg.feature_only:
            # the track head's feature extractor stops after output_conv1,
            # which then keeps all ``features`` channels
            self.output_conv1 = nn.Conv2d(f, f, 3, padding=1)
            return
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, cfg.output_dim, 1))


class DPTHead(nn.Module):
    def __init__(self, cfg: DPTHeadConfig):
        super().__init__()
        self.cfg = cfg
        oc = cfg.out_channels
        self.norm = nn.LayerNorm(cfg.dim_in, eps=1e-5)
        self.projects = nn.ModuleList([nn.Conv2d(cfg.dim_in, oc[i], 1)
                                       for i in range(4)])
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.temporal_upsamplers = nn.ModuleList(
            [WanVAEDPTUpsampler(oc[i]) for i in range(4)])
        self.scratch = _Scratch(cfg)

    def stage1_project(self, aggregated_tokens: List[torch.Tensor],
                       spatial_hw: Tuple[int, int], patch_start_idx: int
                       ) -> List[torch.Tensor]:
        """Per-tap LayerNorm + 1x1 projection + position embedding + resize;
        returns 4 levels, each (B, C_l, S, h_l, w_l)."""
        cfg = self.cfg
        ph, pw = spatial_hw
        H, W = ph * cfg.patch_size, pw * cfg.patch_size
        B, S = aggregated_tokens[0].shape[:2]
        feats = []
        for i, layer_idx in enumerate(cfg.intermediate_layer_idx):
            x = aggregated_tokens[layer_idx][:, :, patch_start_idx:]
            x = x.reshape(B * S, ph * pw, cfg.dim_in)
            x = layer_norm(x, self.norm.weight, self.norm.bias, 1e-5)
            x = x.transpose(1, 2).reshape(B * S, cfg.dim_in, ph, pw)
            x = conv2d(self.projects[i], x, padding=(0, 0))
            if cfg.pos_embed:
                x = _add_pos_embed(x, W, H)
            rl = self.resize_layers[i]
            if i in (0, 1):
                x = F.conv_transpose2d(x, rl.weight.to(x.dtype),
                                       rl.bias.to(x.dtype), stride=rl.stride)
            elif i == 3:
                x = conv2d(rl, x, stride=(2, 2), padding=(1, 1))
            feats.append(x.reshape(B, S, *x.shape[1:]).transpose(1, 2))
        return feats

    def stage2_upsample(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        """Temporal 4x upsample per level (S -> 1 + 4*(S-1))."""
        return [self.temporal_upsamplers[i](feats[i]) for i in range(4)]

    def stage3_fuse(self, levels: List[torch.Tensor],
                    spatial_hw: Tuple[int, int]):
        """Scratch fusion + output convs on (N, C_l, h_l, w_l) frames;
        strictly per frame. Returns activated (preds (N, H, W, out-1),
        conf (N, H, W)), or with ``feature_only`` the feature maps (N,
        features, H / down_ratio, W / down_ratio)."""
        cfg, sc = self.cfg, self.scratch
        ph, pw = spatial_hw
        H, W = ph * cfg.patch_size, pw * cfg.patch_size
        rn = [conv2d(getattr(sc, f"layer{i + 1}_rn"), x)
              for i, x in enumerate(levels)]
        out = sc.refinenet4(rn[3], size=rn[2].shape[-2:])
        out = sc.refinenet3(out, rn[2], size=rn[1].shape[-2:])
        out = sc.refinenet2(out, rn[1], size=rn[0].shape[-2:])
        out = sc.refinenet1(out, rn[0])
        out = conv2d(sc.output_conv1, out)
        out = bilinear_align_corners(out, (H // cfg.down_ratio,
                                           W // cfg.down_ratio))
        if cfg.feature_only:
            return out
        if cfg.pos_embed:
            out = _add_pos_embed(out, W, H)
        out = conv2d(sc.output_conv2[0], out)
        out = F.relu(out.float()).to(out.dtype)
        out = conv2d(sc.output_conv2[2], out, padding=(0, 0))
        return activate_head(out, cfg.activation, cfg.conf_activation)

    def forward(self, aggregated_tokens: List[torch.Tensor],
                spatial_hw: Tuple[int, int], patch_start_idx: int):
        """``dpt_head_forward``: per-layer (B, S, P, dim_in) tokens ->
        (preds (B, T, H, W, out-1), conf (B, T, H, W)), T = 1 + 4*(S-1);
        with ``feature_only``, feature maps (B, T, features, H / down_ratio,
        W / down_ratio)."""
        feats = self.stage1_project(aggregated_tokens, spatial_hw,
                                    patch_start_idx)
        outs = self.stage2_upsample(feats)
        B, T = outs[0].shape[0], outs[0].shape[2]
        frames = [o.transpose(1, 2).reshape(B * T, *o.shape[1:2],
                                            *o.shape[3:]) for o in outs]
        del feats, outs
        chunks = [self.stage3_fuse([x[i:i + STAGE3_FRAMES] for x in frames],
                                   spatial_hw)
                  for i in range(0, B * T, STAGE3_FRAMES)]
        if self.cfg.feature_only:
            fmaps = torch.cat(chunks)
            return fmaps.reshape(B, T, *fmaps.shape[1:])
        preds = torch.cat([p for p, _ in chunks])
        confs = torch.cat([c for _, c in chunks])
        return (preds.reshape(B, T, *preds.shape[1:]),
                confs.reshape(B, T, *confs.shape[1:]))
