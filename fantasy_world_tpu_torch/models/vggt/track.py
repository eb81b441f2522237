"""CoTracker-style point tracker (``models/vggt/track.py``): the VGGT track
head.

A DPT feature extractor (``heads.DPTHead`` in ``feature_only`` mode,
``down_ratio`` 2) feeds an iterative refinement loop: each iteration
samples a correlation pyramid around the current track coordinates, embeds
it with the flow's sin/cos features and the track features, and a
factorized time / space transformer (``EfficientUpdateFormer``) predicts
coordinate and feature deltas.

  * ``grid_sample`` is a 4-tap gather in pixel space (``bilinear_sample``);
  * the pyramid is built once per forward; each level's correlation volume
    is made and sampled at once, one level at a time, so level 0 -- (B, S,
    N, H/2, W/2) in f32, ~4 GB at 81 frames of 336x592 and 256 points -- is
    the largest tensor alive;
  * ``nn.MultiheadAttention`` keeps its packed ``in_proj_weight`` (3E, E)
    and ``out_proj`` as parameters (the checkpoint's names) and runs
    through ``ops/attention.py:dot_product_attention`` -- the ``d64``
    kernel on the card, its 8 heads of 48 zero-padded to 64.

Parameter names are the reference modules' (``corr_mlp.fc1``,
``updateformer.virual_tracks`` [sic], ``time_blocks.{i}.attn.in_proj_weight``,
``space_point2virtual_blocks.{i}.cross_attn.out_proj``, ``query_ref_token``,
``ffeat_updater.0``, ...), as JAX ``convert/track.py`` reads them.

Quirks kept on purpose:
  * the attention blocks overwrite their input with the normed value, so
    the attention residual adds to ``norm1(x)``, not ``x``;
  * ``get_2d_embedding`` has linear (not geometric) frequencies and
    interleaved sin/cos;
  * the correlation window's offsets come from ``meshgrid(..., "ij")``, so
    the component added to x varies along the row index;
  * the coordinates of frame 0 are reset to the query every iteration.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.params import linear, uniform_fan_in_
from ...ops.attention import dot_product_attention
from ...ops.norms import layer_norm


# ---------------------------------------------------------------------------
# sampling and embedding primitives
# ---------------------------------------------------------------------------

def bilinear_sample(img: torch.Tensor, coords: torch.Tensor,
                    padding_mode: str = "border") -> torch.Tensor:
    """``img`` (B, C, H, W) at pixel coordinates ``coords`` (B, R, 2) =
    (x, y), the align_corners=True convention (normalising and
    grid_sample's denormalising cancel), in f32 -> (B, R, C). "border"
    clamps the coordinates into the image; "zeros" takes 0 for the taps
    outside it."""
    B, C, H, W = img.shape
    flat = img.float().permute(0, 2, 3, 1).reshape(B, H * W, C)
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    if padding_mode == "border":
        x = x.clamp(0.0, W - 1.0)
        y = y.clamp(0.0, H - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]

    def tap(ix, iy):
        gx = ix.clamp(0, W - 1).long()
        gy = iy.clamp(0, H - 1).long()
        idx = (gy * W + gx)[..., None].expand(-1, -1, C)
        val = torch.gather(flat, 1, idx)
        if padding_mode == "zeros":
            ok = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
            val = val * ok[..., None].to(val.dtype)
        return val

    top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
    bot = tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx
    return top * (1 - wy) + bot * wy


def get_2d_embedding(xy: torch.Tensor, C: int) -> torch.Tensor:
    """Interleaved sin/cos of x and of y with LINEAR frequencies: xy (B, N,
    2) -> (B, N, 2C), f32."""
    x = xy[..., 0:1].float()
    y = xy[..., 1:2].float()
    div = torch.from_numpy(np.arange(0, C, 2, dtype=np.float32)
                           * np.float32(1000.0 / C)).to(xy.device)

    def interleave(v):
        return torch.stack([torch.sin(v * div), torch.cos(v * div)],
                           dim=-1).reshape(*v.shape[:-1], C)
    return torch.cat([interleave(x), interleave(y)], dim=-1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_hw: Tuple[int, int]
                            ) -> np.ndarray:
    """(1, embed_dim, H, W) f32, made on the host in f64: the x (width)
    coordinates and the y coordinates each embedded with geometric
    frequencies, the halves concatenated."""
    H, W = grid_hw
    gy, gx = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")

    def embed_1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000.0 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb = np.concatenate([embed_1d(embed_dim // 2, gx),
                          embed_1d(embed_dim // 2, gy)], axis=1)
    return emb.reshape(1, H, W, embed_dim).transpose(0, 3, 1, 2).astype(
        np.float32)


# ---------------------------------------------------------------------------
# correlation pyramid
# ---------------------------------------------------------------------------

def build_corr_pyramid(fmaps: torch.Tensor, num_levels: int
                       ) -> List[torch.Tensor]:
    """fmaps (B, S, C, H, W) -> ``num_levels`` maps, each 2x2-average-pooled
    (in f32, floor sizes) from the one before, in fmaps' dtype."""
    pyramid, cur = [fmaps], fmaps
    for _ in range(num_levels - 1):
        B, S, C, H, W = cur.shape
        x = F.avg_pool2d(cur.reshape(B * S, C, H, W).float(), 2, 2)
        cur = x.reshape(B, S, C, H // 2, W // 2).to(fmaps.dtype)
        pyramid.append(cur)
    return pyramid


def _window(radius: int, device) -> torch.Tensor:
    """(1, (2r+1)^2, 2) offsets added to (x, y): the reference's
    meshgrid(dy, dx, "ij") stacked as given."""
    k = 2 * radius + 1
    d0, d1 = np.meshgrid(np.linspace(-radius, radius, k),
                         np.linspace(-radius, radius, k), indexing="ij")
    return torch.from_numpy(np.stack([d0, d1], axis=-1).reshape(
        1, k * k, 2).astype(np.float32)).to(device)


def corr_pyramid_sample(pyramid: Sequence[torch.Tensor],
                        targets: torch.Tensor, coords: torch.Tensor,
                        radius: int) -> torch.Tensor:
    """targets (B, S, N, C), coords (B, S, N, 2) in level-0 pixels -> (B,
    S, N, L * (2r+1)^2) f32: per level, the correlation volume of the
    targets with the map (f32, scaled by 1/sqrt(C)) sampled in a window
    around the coordinates (zeros outside), then freed."""
    B, S, N, C = targets.shape
    k2 = (2 * radius + 1) ** 2
    delta = _window(radius, coords.device)
    t = targets.float().reshape(B * S, N, C)
    out = []
    for lvl, fm in enumerate(pyramid):
        H, W = fm.shape[-2:]
        corr = torch.bmm(t, fm.float().reshape(B * S, C, H * W)
                         ) / math.sqrt(C)
        centroid = coords.float().reshape(B * S * N, 1, 2) / (2.0 ** lvl)
        sampled = bilinear_sample(corr.reshape(B * S * N, 1, H, W),
                                  centroid + delta, padding_mode="zeros")
        del corr
        out.append(sampled.reshape(B, S, N, k2))
    return torch.cat(out, dim=-1)


# ---------------------------------------------------------------------------
# transformer blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrackConfig:
    latent_dim: int = 128
    hidden_size: int = 384
    corr_levels: int = 7
    corr_radius: int = 4
    iters: int = 4
    depth: int = 6              # space and time depth (use_spaceatt=True)
    num_heads: int = 8
    mlp_ratio: float = 4.0
    num_virtual_tracks: int = 64
    max_scale: float = 518.0
    stride: int = 2
    predict_conf: bool = True

    @property
    def transformer_dim(self) -> int:
        return 3 * self.latent_dim + 4

    @property
    def output_dim(self) -> int:
        return self.latent_dim + 2


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (batch-first, no dropout, no
    bias_k/v): packed ``in_proj_weight`` (3E, E), ``in_proj_bias`` and
    ``out_proj``; the attention through ``dot_product_attention``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def init_extra_(self, generator):
        # each of q, k, v as a linear of its own: U(+-1/sqrt(E)), zero bias
        uniform_fan_in_(self.in_proj_weight, self.in_proj_weight.shape[1],
                        generator)
        self.in_proj_bias.data.zero_()

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor
                ) -> torch.Tensor:
        E = q_in.shape[-1]
        w, b = self.in_proj_weight, self.in_proj_bias
        q = F.linear(q_in.float(), w[:E].float(), b[:E].float())
        kv = F.linear(kv_in.float(), w[E:].float(), b[E:].float())
        B, Lq, Lk = q.shape[0], q.shape[1], kv.shape[1]
        n, hd = self.num_heads, E // self.num_heads
        dt = q_in.dtype
        o = dot_product_attention(
            q.to(dt).view(B, Lq, n, hd), kv[..., :E].to(dt).view(B, Lk, n, hd),
            kv[..., E:].to(dt).view(B, Lk, n, hd))
        return linear(o.reshape(B, Lq, E), self.out_proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)

    def forward(self, x):
        """fc1, exact GELU, fc2, each linear in x's dtype."""
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


class AttnBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MultiheadAttention(dim, num_heads)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        """x is overwritten by norm1(x) before the residual (the
        reference's quirk)."""
        x = layer_norm(x, self.norm1.weight, self.norm1.bias, 1e-5)
        x = x + self.attn(x, x)
        return x + self.mlp(layer_norm(x, self.norm2.weight, self.norm2.bias,
                                       1e-5))


class CrossAttnBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm_context = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn = MultiheadAttention(dim, num_heads)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, context):
        """The same norm-overwrite quirk as ``AttnBlock``."""
        x = layer_norm(x, self.norm1.weight, self.norm1.bias, 1e-5)
        context = layer_norm(context, self.norm_context.weight,
                             self.norm_context.bias, 1e-5)
        x = x + self.cross_attn(x, context)
        return x + self.mlp(layer_norm(x, self.norm2.weight, self.norm2.bias,
                                       1e-5))


class EfficientUpdateFormer(nn.Module):
    """Time attention over each track's frames, then space attention
    through ``num_virtual_tracks`` virtual tracks (virtual <- points,
    virtual self, points <- virtual) in every block."""

    def __init__(self, cfg: TrackConfig):
        super().__init__()
        self.cfg = cfg
        hs, nh, r = cfg.hidden_size, cfg.num_heads, cfg.mlp_ratio
        self.input_norm = nn.LayerNorm(cfg.transformer_dim, eps=1e-5)
        self.input_transform = nn.Linear(cfg.transformer_dim, hs)
        self.output_norm = nn.LayerNorm(hs, eps=1e-5)
        self.flow_head = nn.Linear(hs, cfg.output_dim)
        self.virual_tracks = nn.Parameter(                   # sic
            torch.empty(1, cfg.num_virtual_tracks, 1, hs))
        self.time_blocks = nn.ModuleList(
            [AttnBlock(hs, nh, r) for _ in range(cfg.depth)])
        self.space_virtual_blocks = nn.ModuleList(
            [AttnBlock(hs, nh, r) for _ in range(cfg.depth)])
        self.space_point2virtual_blocks = nn.ModuleList(
            [CrossAttnBlock(hs, nh, r) for _ in range(cfg.depth)])
        self.space_virtual2point_blocks = nn.ModuleList(
            [CrossAttnBlock(hs, nh, r) for _ in range(cfg.depth)])

    def init_extra_(self, generator):
        self.virual_tracks.data.normal_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, T, transformer_dim) -> (B, N, T, latent_dim + 2)."""
        B, N, T, _ = x.shape
        nv = self.cfg.num_virtual_tracks
        tokens = linear(layer_norm(x, self.input_norm.weight,
                                   self.input_norm.bias, 1e-5),
                        self.input_transform)
        init_tokens = tokens
        virtual = self.virual_tracks.to(tokens.dtype).expand(
            B, nv, T, tokens.shape[-1])
        tokens = torch.cat([tokens, virtual], dim=1)
        Nv = N + nv
        for i in range(self.cfg.depth):
            tt = self.time_blocks[i](tokens.reshape(B * Nv, T, -1))
            tokens = tt.reshape(B, Nv, T, -1)
            st = tokens.transpose(1, 2).reshape(B * T, Nv, -1)
            point, virt = st[:, :N], st[:, N:]
            virt = self.space_virtual2point_blocks[i](virt, point)
            virt = self.space_virtual_blocks[i](virt)
            point = self.space_point2virtual_blocks[i](point, virt)
            st = torch.cat([point, virt], dim=1)
            tokens = st.reshape(B, T, Nv, -1).transpose(1, 2)
        tokens = tokens[:, :N] + init_tokens
        return linear(layer_norm(tokens, self.output_norm.weight,
                                 self.output_norm.bias, 1e-5),
                      self.flow_head)


# ---------------------------------------------------------------------------
# the tracker (BaseTrackerPredictor)
# ---------------------------------------------------------------------------

class TrackerPredictor(nn.Module):
    def __init__(self, cfg: TrackConfig):
        super().__init__()
        self.cfg = cfg
        ld = cfg.latent_dim
        corr_dim = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        self.corr_mlp = Mlp(corr_dim, cfg.hidden_size, ld)
        self.query_ref_token = nn.Parameter(
            torch.empty(1, 2, cfg.transformer_dim))
        self.updateformer = EfficientUpdateFormer(cfg)
        self.fmap_norm = nn.LayerNorm(ld, eps=1e-5)
        self.ffeat_norm = nn.GroupNorm(1, ld)
        self.ffeat_updater = nn.Sequential(nn.Linear(ld, ld), nn.GELU())
        self.vis_predictor = nn.Sequential(nn.Linear(ld, 1))
        if cfg.predict_conf:
            self.conf_predictor = nn.Sequential(nn.Linear(ld, 1))

    def init_extra_(self, generator):
        self.query_ref_token.data.normal_(0.0, 1.0, generator=generator)

    def forward(self, query_points: torch.Tensor, fmaps: torch.Tensor,
                iters: Optional[int] = None, down_ratio: int = 1,
                apply_sigmoid: bool = True):
        """``tracker_predict``: query_points (B, N, 2) in full-resolution
        pixels, fmaps (B, S, C, HH, WW) -> ([iters x (B, S, N, 2)], vis
        (B, S, N), conf (B, S, N) or None)."""
        cfg = self.cfg
        iters = cfg.iters if iters is None else iters
        B, N, _ = query_points.shape
        S, C, HH, WW = fmaps.shape[1:]
        ld, D = cfg.latent_dim, cfg.transformer_dim

        fmaps = layer_norm(fmaps.permute(0, 1, 3, 4, 2), self.fmap_norm.weight,
                           self.fmap_norm.bias, 1e-5).permute(0, 1, 4, 2, 3)
        qp = query_points.float()
        if down_ratio > 1:
            qp = qp / float(down_ratio)
        qp = qp / float(cfg.stride)

        coords = qp[:, None].expand(B, S, N, 2)
        query_feat = bilinear_sample(fmaps[:, 0], coords[:, 0])
        track_feats = query_feat[:, None].expand(B, S, N, ld).to(fmaps.dtype)

        pyramid = build_corr_pyramid(fmaps, cfg.corr_levels)
        pos_table = torch.from_numpy(get_2d_sincos_pos_embed(D, (HH, WW))
                                     ).to(fmaps.device)
        sampled_pos = bilinear_sample(pos_table.expand(B, D, HH, WW),
                                      coords[:, 0]).reshape(B * N, 1, D)
        qr = self.query_ref_token.float()
        query_ref = torch.cat([qr[:, 0:1], qr[:, 1:2].expand(1, S - 1, D)],
                              dim=1)

        coord_preds = []
        for _ in range(iters):
            coords = coords.detach()
            fcorrs = corr_pyramid_sample(pyramid, track_feats, coords,
                                         cfg.corr_radius)
            fcorrs_ = self.corr_mlp(fcorrs.transpose(1, 2).reshape(
                B * N, S, fcorrs.shape[-1]))
            flows = (coords - coords[:, 0:1]).transpose(1, 2).reshape(
                B * N, S, 2)
            flows_emb = torch.cat([get_2d_embedding(flows, ld // 2),
                                   flows / cfg.max_scale,
                                   flows / cfg.max_scale], dim=-1)
            track_feats_ = track_feats.transpose(1, 2).reshape(B * N, S, ld)
            x = torch.cat([flows_emb, fcorrs_.float(), track_feats_.float()],
                          dim=-1) + sampled_pos + query_ref
            x = x.reshape(B, N, S, D).to(fmaps.dtype)

            delta = self.updateformer(x).reshape(B * N, S, cfg.output_dim)
            delta_coords = delta[..., :2].float()
            delta_feats = delta[..., 2:].reshape(B * N * S, ld)
            gn = self.ffeat_norm
            upd = F.gelu(linear(layer_norm(delta_feats, gn.weight, gn.bias,
                                           1e-5), self.ffeat_updater[0]))
            track_feats = (upd + track_feats_.reshape(B * N * S, ld)
                           ).reshape(B, N, S, ld).transpose(1, 2)
            coords = coords + delta_coords.reshape(B, N, S, 2).transpose(1, 2)
            coords = torch.cat([qp[:, None], coords[:, 1:]], dim=1)
            coord_preds.append(coords * cfg.stride * max(down_ratio, 1))

        tf = track_feats.float().reshape(B * S * N, ld)
        vis = linear(tf, self.vis_predictor[0]).reshape(B, S, N)
        conf = None
        if cfg.predict_conf:
            conf = linear(tf, self.conf_predictor[0]).reshape(B, S, N)
        if apply_sigmoid:
            vis = torch.sigmoid(vis)
            conf = torch.sigmoid(conf) if conf is not None else None
        return coord_preds, vis, conf


# ---------------------------------------------------------------------------
# the track head
# ---------------------------------------------------------------------------

class TrackHead(nn.Module):
    """``feature_extractor`` (the feature-only causal-3D DPT) and
    ``tracker``."""

    def __init__(self, cfg: TrackConfig, dpt_cfg):
        super().__init__()
        from .heads import DPTHead
        self.cfg = cfg
        self.feature_extractor = DPTHead(dpt_cfg)
        self.tracker = TrackerPredictor(cfg)

    def forward(self, aggregated_tokens: List[torch.Tensor],
                spatial_hw: Tuple[int, int], patch_start_idx: int,
                query_points: torch.Tensor, iters: Optional[int] = None):
        """``track_head_forward``: per-layer (B, S, P, dim_in) tokens and
        query points (B, N, 2) in full-resolution pixels -> (coordinate
        predictions, vis, conf). The feature maps are (B, T, C, H/2, W/2);
        the tracker's stride 2 accounts for the DPT's down ratio, so its
        own down_ratio stays 1."""
        fmaps = self.feature_extractor(aggregated_tokens, spatial_hw,
                                       patch_start_idx)
        return self.tracker(query_points, fmaps, iters=iters)

