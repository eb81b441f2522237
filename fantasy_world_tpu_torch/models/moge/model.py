"""MoGe-2 monocular metric geometry model (``models/moge/model.py``) in
PyTorch.

A DINOv2 ViT-L/14 encoder (24 pre-norm blocks with LayerScale: the port's
VGGT block with RoPE, qk-norm and the modulation off), 1x1 projections of
the intermediate layers summed into one feature map, a ConvStack neck and
points/mask/normal ConvStack heads over a 5-level pyramid conditioned on
the view-plane UV, and an MLP metric-scale head on the class token.

Module paths are the reference checkpoint's state-dict keys
(``encoder.backbone.blocks.0.attn.qkv.weight``, ``neck.res_blocks.1.0.
layers.2.weight``, ``scale_head.4.bias``, ...), so a checkpoint loads as it
is (``convert/moge.py``). The sampler uses it for the scene-scale
normalization of the camera path; the focal/shift solve stays on the host
(``models/moge/infer.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.params import linear, normal_
from ...ops.bicubic import bicubic_matrix
from ...ops.norms import layer_norm
from ..vggt.blocks import VGGTBlock, VGGTBlockConfig

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DINOv2Config:
    patch_size: int = 14
    dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    init_values: float = 1.0
    pos_grid: int = 37            # 518 / 14
    interpolate_offset: float = 0.1

    @property
    def block_cfg(self) -> VGGTBlockConfig:
        return VGGTBlockConfig(dim=self.dim, num_heads=self.num_heads,
                               mlp_ratio=self.mlp_ratio, qk_norm=False,
                               init_values=self.init_values,
                               rope_frequency=-1.0, ln_eps=1e-6)


@dataclasses.dataclass(frozen=True)
class MoGeConfig:
    encoder: DINOv2Config = DINOv2Config()
    intermediate_layers: Tuple[int, ...] = (5, 11, 17, 23)
    dim_proj_out: int = 1024
    dim_res_blocks: Tuple[int, ...] = (1024, 256, 128, 64, 32)
    neck_num_res_blocks: Tuple[int, ...] = (0, 2, 2, 2, 0)
    head_num_res_blocks: Tuple[int, ...] = (0, 1, 1, 1, 0)
    resamplers: Tuple[str, ...] = ("conv_transpose", "conv_transpose",
                                   "conv_transpose", "bilinear")
    scale_head_dims: Tuple[int, ...] = (1024, 1024, 1024, 1)
    remap_output: str = "exp"
    num_tokens_range: Tuple[int, int] = (1200, 3600)
    with_normal_head: bool = True


# ---------------------------------------------------------------------------
# DINOv2
# ---------------------------------------------------------------------------

def interpolate_pos_embed(pos_embed: np.ndarray, grid: int, h0: int, w0: int,
                          offset: float = 0.1) -> np.ndarray:
    """DINOv2's position-embedding interpolation with its scale-factor
    offset, the torch bicubic kernel as two host matmuls in f64.
    pos_embed (1, 1 + grid^2, dim) -> (1, 1 + h0 w0, dim) f32."""
    pos = np.asarray(pos_embed, np.float32)
    if h0 == grid and w0 == grid:
        return pos
    cls_pos, patch = pos[:, :1], pos[:, 1:]
    dim = patch.shape[-1]
    scales = ((h0 + offset) / grid, (w0 + offset) / grid) if offset > 0 \
        else (None, None)
    ah = bicubic_matrix(grid, h0, scales[0])
    aw = bicubic_matrix(grid, w0, scales[1])
    grid_pos = patch.reshape(grid, grid, dim).astype(np.float64)
    out = np.einsum("hi,ijc,wj->hwc", ah, grid_pos, aw, optimize=True)
    return np.concatenate([cls_pos, out.reshape(1, h0 * w0, dim)
                           .astype(np.float32)], axis=1)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: DINOv2Config):
        super().__init__()
        ps = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.dim, ps, ps)

    def forward(self, x):
        """(B, 3, h0 p, w0 p) -> (B, h0 w0, dim): the kernel==stride conv as
        a reshape and a matmul, patch features in (c, dy, dx) order."""
        B, C, H, W = x.shape
        ps = self.proj.kernel_size[0]
        h0, w0 = H // ps, W // ps
        x = x.reshape(B, C, h0, ps, w0, ps).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(B, h0 * w0, C * ps * ps)
        w = self.proj.weight
        return F.linear(x, w.reshape(w.shape[0], -1).to(x.dtype),
                        self.proj.bias.to(x.dtype))


class DINOv2(nn.Module):
    def __init__(self, cfg: DINOv2Config):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.dim))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.pos_grid ** 2 + 1,
                                                  cfg.dim))
        self.blocks = nn.ModuleList([VGGTBlock(cfg.block_cfg,
                                               with_modulation=False)
                                     for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-6)

    def init_extra_(self, generator):
        normal_(self.pos_embed, 0.02, generator)
        self.cls_token.data.zero_()

    def forward(self, image: torch.Tensor, take_layers: Sequence[int]
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """image (B, 3, h0 14, w0 14), ImageNet-normalized -> ([tokens
        (B, 1 + h0 w0, dim) after the final norm at ``take_layers``], the
        class token of the last of them)."""
        cfg = self.cfg
        B = image.shape[0]
        h0, w0 = image.shape[2] // cfg.patch_size, \
            image.shape[3] // cfg.patch_size
        x = self.patch_embed(image)
        cls = self.cls_token.to(x.dtype).expand(B, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
        pos = interpolate_pos_embed(
            self.pos_embed.detach().float().cpu().numpy(), cfg.pos_grid, h0,
            w0, cfg.interpolate_offset)
        x = x + torch.as_tensor(pos, dtype=x.dtype, device=x.device)
        outputs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in take_layers:
                outputs.append(x)
        outputs = [layer_norm(o, self.norm.weight, self.norm.bias, 1e-6)
                   for o in outputs]
        return outputs, outputs[-1][:, 0]


class Encoder(nn.Module):
    def __init__(self, cfg: MoGeConfig):
        super().__init__()
        self.backbone = DINOv2(cfg.encoder)
        self.output_projections = nn.ModuleList([
            nn.Conv2d(cfg.encoder.dim, cfg.dim_proj_out, 1)
            for _ in cfg.intermediate_layers])


# ---------------------------------------------------------------------------
# conv stacks
# ---------------------------------------------------------------------------

def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, padding_mode="replicate")


class ResidualConvBlock(nn.Module):
    """norm 'none', ReLU, conv, norm 'none', ReLU, conv, plus the input
    (the reference's ``layers`` indices: convs at 2 and 5)."""

    def __init__(self, dim: int):
        super().__init__()
        self.layers = nn.Sequential(nn.Identity(), nn.ReLU(),
                                    _conv3x3(dim, dim), nn.Identity(),
                                    nn.ReLU(), _conv3x3(dim, dim))

    def forward(self, x):
        return self.layers(x) + x


class Upsample2x(nn.Module):
    """Bilinear x2 with half-pixel centres and no antialias, in f32."""

    def forward(self, x):
        return F.interpolate(x.float(), scale_factor=2, mode="bilinear",
                             align_corners=False).to(x.dtype)


def _resampler(kind: str, cin: int, cout: int) -> nn.Sequential:
    if kind == "conv_transpose":
        return nn.Sequential(nn.ConvTranspose2d(cin, cout, 2, stride=2),
                             _conv3x3(cout, cout))
    if kind == "bilinear":
        return nn.Sequential(Upsample2x(), _conv3x3(cin, cout))
    raise ValueError(kind)


def _conv1x1_or_none(cin: Optional[int], cout: Optional[int]) -> nn.Module:
    if cin is None or cout is None:
        return nn.Identity()
    return nn.Conv2d(cin, cout, 1)


class ConvStack(nn.Module):
    """Per level: an optional 1x1 input projection added to the running
    map, residual blocks, an optional 1x1 output; a resampler to the next
    level (``conv_stack_apply``)."""

    def __init__(self, dim_in: Sequence[Optional[int]],
                 dim_out: Sequence[Optional[int]], dim_res: Sequence[int],
                 num_res: Sequence[int], resamplers: Sequence[str]):
        super().__init__()
        n = len(dim_res)
        self.has_in = [d is not None for d in dim_in]
        self.has_out = [d is not None for d in dim_out]
        self.input_blocks = nn.ModuleList([
            _conv1x1_or_none(dim_in[i], dim_res[i]) for i in range(n)])
        self.res_blocks = nn.ModuleList([
            nn.Sequential(*[ResidualConvBlock(dim_res[i])
                            for _ in range(num_res[i])]) for i in range(n)])
        self.output_blocks = nn.ModuleList([
            _conv1x1_or_none(dim_res[i], dim_out[i]) for i in range(n)])
        self.resamplers = nn.ModuleList([
            _resampler(resamplers[i], dim_res[i], dim_res[i + 1])
            for i in range(n - 1)])

    def forward(self, features: List[Optional[torch.Tensor]]
                ) -> List[torch.Tensor]:
        outs, x = [], None
        n = len(self.res_blocks)
        for i in range(n):
            feat = features[i]
            if self.has_in[i] and feat is not None:
                feat = self.input_blocks[i](feat)
            if i == 0:
                x = feat
            elif feat is not None:
                x = x + feat
            x = self.res_blocks[i](x)
            outs.append(self.output_blocks[i](x) if self.has_out[i] else x)
            if i < n - 1:
                x = self.resamplers[i](x)
        return outs


def normalized_view_plane_uv(width: int, height: int,
                             aspect_ratio: Optional[float] = None
                             ) -> np.ndarray:
    """(height, width, 2) f32 UV of pixel centres on the view plane,
    spanning a unit diagonal."""
    if aspect_ratio is None:
        aspect_ratio = width / height
    span_x = aspect_ratio / (1 + aspect_ratio ** 2) ** 0.5
    span_y = 1 / (1 + aspect_ratio ** 2) ** 0.5
    u = np.linspace(-span_x * (width - 1) / width,
                    span_x * (width - 1) / width, width, dtype=np.float32)
    v = np.linspace(-span_y * (height - 1) / height,
                    span_y * (height - 1) / height, height, dtype=np.float32)
    uu, vv = np.meshgrid(u, v, indexing="xy")
    return np.stack([uu, vv], axis=-1)


class MoGe(nn.Module):
    def __init__(self, cfg: MoGeConfig = MoGeConfig()):
        super().__init__()
        self.cfg = cfg
        dr = cfg.dim_res_blocks
        self.encoder = Encoder(cfg)
        self.neck = ConvStack([cfg.dim_proj_out + 2, 2, 2, 2, 2], [None] * 5,
                              dr, cfg.neck_num_res_blocks, cfg.resamplers)

        def head(cout):
            return ConvStack(list(dr), [None, None, None, None, cout], dr,
                             cfg.head_num_res_blocks, cfg.resamplers)
        self.points_head = head(3)
        self.mask_head = head(1)
        if cfg.with_normal_head:
            self.normal_head = head(3)
        dims = cfg.scale_head_dims
        layers: List[nn.Module] = []
        for i in range(len(dims) - 1):
            layers.append(nn.Linear(dims[i], dims[i + 1]))
            if i < len(dims) - 2:
                layers.append(nn.ReLU())
        self.scale_head = nn.Sequential(*layers)

    def forward(self, image: torch.Tensor, num_tokens: int
                ) -> Dict[str, torch.Tensor]:
        """image (B, 3, H, W) in [0, 1], in the model's dtype -> points
        (B, H, W, 3), mask (B, H, W), normal (B, H, W, 3) where the model
        has the head, metric_scale (B,) f32, at the input resolution
        (``moge_forward``)."""
        cfg = self.cfg
        B, _, img_h, img_w = image.shape
        aspect = img_w / img_h
        base_h = int((num_tokens / aspect) ** 0.5)
        base_w = int((num_tokens * aspect) ** 0.5)
        ps = cfg.encoder.patch_size
        x14 = F.interpolate(image.float(), size=(base_h * ps, base_w * ps),
                            mode="bilinear", align_corners=False,
                            antialias=True)
        mean = torch.tensor(IMAGE_MEAN, device=image.device).view(1, 3, 1, 1)
        std = torch.tensor(IMAGE_STD, device=image.device).view(1, 3, 1, 1)
        x14 = ((x14 - mean) / std).to(image.dtype)

        tokens, cls_token = self.encoder.backbone(x14,
                                                  cfg.intermediate_layers)
        feats = None
        for proj, tok in zip(self.encoder.output_projections, tokens):
            fmap = proj(tok[:, 1:].transpose(1, 2).reshape(
                B, cfg.encoder.dim, base_h, base_w))
            feats = fmap if feats is None else feats + fmap

        levels = []
        for level in range(5):
            uv = normalized_view_plane_uv(base_w * 2 ** level,
                                          base_h * 2 ** level, aspect)
            uv = torch.as_tensor(uv.transpose(2, 0, 1)[None], dtype=feats.dtype,
                                 device=feats.device).expand(B, -1, -1, -1)
            levels.append(torch.cat([feats, uv], dim=1) if level == 0 else uv)
        neck = self.neck(levels)

        def up(v):
            return F.interpolate(v.float(), size=(img_h, img_w),
                                 mode="bilinear", align_corners=False)

        points = up(self.points_head(neck)[-1]).permute(0, 2, 3, 1)
        if cfg.remap_output == "exp":
            xy, z = points[..., :2], torch.exp(points[..., 2:])
            points = torch.cat([xy * z, z], dim=-1)
        elif cfg.remap_output == "sinh":
            points = torch.sinh(points)
        out = {"points": points,
               "mask": torch.sigmoid(up(self.mask_head(neck)[-1])[:, 0])}
        if cfg.with_normal_head:
            nrm = up(self.normal_head(neck)[-1]).permute(0, 2, 3, 1)
            out["normal"] = nrm / nrm.norm(dim=-1, keepdim=True).clamp_min(
                1e-12)
        scale = cls_token
        for m in self.scale_head:
            scale = F.relu(scale) if isinstance(m, nn.ReLU) else linear(scale,
                                                                          m)
        out["metric_scale"] = torch.exp(scale[:, 0].float())
        return out
