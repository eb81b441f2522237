"""VGGT geometry model consuming Wan DiT features (``models/vggt/model.py``):
the 5120 -> 1024 projection, the fp32 timestep AdaLN embedding, the
aggregator and the camera/depth/point heads, and with ``enable_track`` the
track head (``track.py``), which runs when query points are given. The
denoise leaves the track head off, as the reference's inference does."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import rope as rope_ops
from .aggregator import Aggregator, AggregatorConfig
from .heads import CameraHead, CameraHeadConfig, DPTHead, DPTHeadConfig


@dataclasses.dataclass(frozen=True)
class VGGTConfig:
    embed_dim: int = 1024
    freq_dim: int = 256
    wan_dim: int = 5120
    enable_camera: bool = True
    enable_depth: bool = True
    enable_point: bool = True
    enable_track: bool = False
    dpt_patch_size: int = 16
    dpt_layer_idx: Tuple[int, ...] = (23, 17, 11, 7)
    dpt_features: int = 256
    dpt_out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    camera_num_heads: int = 16
    aggregator: AggregatorConfig = AggregatorConfig()

    @property
    def camera_head(self) -> CameraHeadConfig:
        return CameraHeadConfig(dim_in=2 * self.embed_dim,
                                num_heads=self.camera_num_heads)

    def dpt_head(self, output_dim: int, activation: str) -> DPTHeadConfig:
        return DPTHeadConfig(dim_in=2 * self.embed_dim,
                             patch_size=self.dpt_patch_size,
                             output_dim=output_dim, activation=activation,
                             features=self.dpt_features,
                             out_channels=self.dpt_out_channels,
                             intermediate_layer_idx=self.dpt_layer_idx)

    @property
    def track(self):
        from .track import TrackConfig
        return TrackConfig()

    @property
    def track_dpt(self) -> DPTHeadConfig:
        """The track head's feature extractor: features = the tracker's
        latent width, down_ratio 2, no position embedding, feature only."""
        return DPTHeadConfig(dim_in=2 * self.embed_dim,
                             patch_size=self.dpt_patch_size,
                             output_dim=0, features=self.track.latent_dim,
                             out_channels=self.dpt_out_channels,
                             intermediate_layer_idx=self.dpt_layer_idx,
                             pos_embed=False, down_ratio=2,
                             feature_only=True)


class VGGT(nn.Module):
    # the timestep embedding is an fp32 island: core.params.build keeps
    # these float32 whatever the model dtype
    fp32_children = ("time_embedding", "time_projection")

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.embed_dim
        self.projection_head = nn.Conv3d(cfg.wan_dim, C, 1)
        self.time_embedding = nn.Sequential(nn.Linear(cfg.freq_dim, C),
                                            nn.SiLU(), nn.Linear(C, C))
        self.time_projection = nn.Sequential(nn.SiLU(), nn.Linear(C, 6 * C))
        self.aggregator = Aggregator(cfg.aggregator)
        if cfg.enable_camera:
            self.camera_head = CameraHead(cfg.camera_head)
        if cfg.enable_depth:
            self.depth_head = DPTHead(cfg.dpt_head(2, "exp"))
        if cfg.enable_point:
            self.point_head = DPTHead(cfg.dpt_head(4, "inv_log"))
        if cfg.enable_track:
            from .track import TrackHead
            self.track_head = TrackHead(cfg.track, cfg.track_dpt)

    def process_wan_input(self, wan_features: torch.Tensor,
                          timestep: torch.Tensor):
        """(B, F, H, W, wan_dim) DiT features + timestep (B,) ->
        (patch tokens (B, F, H, W, embed_dim), e0 (B, 6, embed_dim) f32).
        The 1x1x1 Conv3d projection is a linear over channels; the time
        MLPs run entirely in f32."""
        w = self.projection_head.weight
        x = wan_features
        proj = F.linear(x, w.reshape(w.shape[0], -1).to(x.dtype),
                        self.projection_head.bias.to(x.dtype))
        emb = rope_ops.sinusoidal_embedding_1d(self.cfg.freq_dim, timestep)
        te, tp = self.time_embedding, self.time_projection[1]

        def lin32(layer, v):
            return F.linear(v.float(), layer.weight.float(),
                            layer.bias.float())

        e = lin32(te[2], F.silu(lin32(te[0], emb)))
        e0 = lin32(tp, F.silu(e))
        return proj, e0.view(e.shape[0], 6, self.cfg.embed_dim)

    def head_prediction(self, aggregated_tokens: List[torch.Tensor],
                        spatial_hw: Tuple[int, int], patch_start_idx: int,
                        query_points: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
        """Camera/depth/point heads over the per-layer (B, S, P, 2C)
        intermediates; with the track head and query points (B, N, 2) in
        full-resolution pixels, also "track" (the last iteration's (B, T,
        N, 2)), "vis" and "track_conf" (B, T, N)."""
        out: Dict[str, torch.Tensor] = {}
        if self.cfg.enable_camera:
            out["pose_enc"] = self.camera_head(aggregated_tokens[-1])[-1]
        if self.cfg.enable_depth:
            out["depth"], out["depth_conf"] = self.depth_head(
                aggregated_tokens, spatial_hw, patch_start_idx)
        if self.cfg.enable_point:
            out["world_points"], out["world_points_conf"] = self.point_head(
                aggregated_tokens, spatial_hw, patch_start_idx)
        if self.cfg.enable_track and query_points is not None:
            coords, vis, conf = self.track_head(
                aggregated_tokens, spatial_hw, patch_start_idx, query_points)
            out["track"], out["vis"], out["track_conf"] = coords[-1], vis, conf
        return out
