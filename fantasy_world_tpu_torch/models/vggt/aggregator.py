"""VGGT aggregator state (``models/vggt/aggregator.py``): special tokens,
the position grid and the frame/global block stacks. In the fusion model
patch tokens arrive as projected DiT features and the fusion loop drives
the blocks itself.

Token layout per frame: [camera(1) | register(4) | patch(h*w)].
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.params import linear, normal_
from ...ops import rope as rope_ops
from .blocks import VGGTBlock, VGGTBlockConfig


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    qk_norm: bool = True
    rope_freq: float = 100.0
    init_values: float = 0.01

    @property
    def patch_start_idx(self) -> int:
        return 1 + self.num_register_tokens

    @property
    def block_cfg(self) -> VGGTBlockConfig:
        return VGGTBlockConfig(dim=self.embed_dim, num_heads=self.num_heads,
                               mlp_ratio=self.mlp_ratio, qk_norm=self.qk_norm,
                               init_values=self.init_values,
                               rope_frequency=self.rope_freq)


class _CamTokenProjector(nn.Module):
    """Pose encodings -> camera tokens (``cam_token_projector``); runs when
    ``joint_forward`` is given ``camera_token``, which no CLI passes."""

    def __init__(self, dim: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(36, 128), nn.GELU(),
                                 nn.Linear(128, dim))

    def forward(self, cam: torch.Tensor) -> torch.Tensor:
        """(B, V, 9) pose encodings -> (B*(V+3)//4, 1, C) camera tokens,
        one per group of four views: view 0 is repeated three times at the
        end, then (B*Vp/4, 36) rows go through Linear, exact GELU, Linear.
        V % 4 must be 1 (one token per latent frame: V = 4f - 3)."""
        B, V, _ = cam.shape
        if V % 4 != 1:
            raise ValueError(f"cam_token_projector needs V % 4 == 1 views "
                             f"(4 * latent frames - 3); got V = {V}")
        cam = torch.cat([cam, cam[:, :1].expand(B, 3, cam.shape[-1])], dim=1)
        rows = cam.reshape(B * (cam.shape[1] // 4), 36)
        m = self.mlp
        out = linear(F.gelu(linear(rows, m[0])), m[2])
        return out.reshape(-1, 1, out.shape[-1])


class Aggregator(nn.Module):
    def __init__(self, cfg: AggregatorConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.embed_dim
        self.camera_token = nn.Parameter(torch.empty(1, 2, 1, C))
        self.register_token = nn.Parameter(
            torch.empty(1, 2, cfg.num_register_tokens, C))
        self.frame_blocks = nn.ModuleList(
            [VGGTBlock(cfg.block_cfg) for _ in range(cfg.depth)])
        self.global_blocks = nn.ModuleList(
            [VGGTBlock(cfg.block_cfg) for _ in range(cfg.depth)])
        self.CamTokenProjector = _CamTokenProjector(C)

    def init_extra_(self, generator):
        normal_(self.camera_token, 1e-6, generator)
        normal_(self.register_token, 1e-6, generator)

    def assemble_tokens(self, patch_tokens: torch.Tensor,
                        camera_token: Optional[torch.Tensor] = None,
                        frames: Optional[Tuple[int, int]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S, H, W, C) patch tokens -> tokens (B*S, P, C) and int
        positions (B*S, P, 2) (aggregator._process_aggregator_input). The
        camera slot holds the learned token, or, given ``camera_token``
        (B, V = 4S - 3, 9) pose encodings, their projection. ``frames``
        (first, total): the S frames are frames first.. of a clip of
        total (a rank's part of the seq split)."""
        B, S, H, W, C = patch_tokens.shape
        f0, total = frames or (0, S)
        patches = patch_tokens.reshape(B * S, H * W, C)

        def special(token):
            t = slice_expand_and_flatten(token, B, total)
            return t.view(B, total, *t.shape[1:])[:, f0:f0 + S].reshape(
                B * S, *t.shape[1:])

        if camera_token is not None:
            cam = self.CamTokenProjector(camera_token)
            cam = cam.view(B, total, *cam.shape[1:])[:, f0:f0 + S].reshape(
                B * S, *cam.shape[1:])
        else:
            cam = special(self.camera_token)
        reg = special(self.register_token)
        tokens = torch.cat([cam.to(patches.dtype), reg.to(patches.dtype),
                            patches], dim=1)
        pos = torch.as_tensor(rope_ops.grid_positions_2d(
            H, W, n_special=self.cfg.patch_start_idx),
            device=patch_tokens.device)
        return tokens, pos.expand(B * S, *pos.shape)


def slice_expand_and_flatten(token: torch.Tensor, B: int, S: int
                             ) -> torch.Tensor:
    """(1, 2, X, C): index 0 for frame 0, index 1 for frames 1..S-1 ->
    (B*S, X, C)."""
    first = token[:, 0:1].expand(B, 1, *token.shape[2:])
    rest = token[:, 1:2].expand(B, S - 1, *token.shape[2:])
    return torch.cat([first, rest], dim=1).reshape(B * S, *token.shape[2:])
