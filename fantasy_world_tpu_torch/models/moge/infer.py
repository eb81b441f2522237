"""MoGe inference (``models/moge/infer.py``): image -> metric depth, points,
intrinsics and mask.

The forward runs on the model's device in its dtype; the focal/shift
recovery (a small scipy Levenberg-Marquardt solve over a 64x64 nearest
downsample) and the projection-consistent re-unprojection run on the host.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .model import MoGe, normalized_view_plane_uv


def solve_optimal_focal_shift(uv: np.ndarray, xyz: np.ndarray):
    """(shift, focal) minimising the reprojection error of the affine point
    map ``xyz`` onto the view-plane ``uv``."""
    from scipy.optimize import least_squares
    uv = uv.reshape(-1, 2)
    xy = xyz[..., :2].reshape(-1, 2)
    z = xyz[..., 2].reshape(-1)

    def fn(shift):
        xy_proj = xy / (z + shift)[:, None]
        f = (xy_proj * uv).sum() / np.square(xy_proj).sum()
        return (f * xy_proj - uv).ravel()

    sol = least_squares(fn, x0=0, ftol=1e-3, method="lm")
    shift = float(np.squeeze(sol["x"]))
    xy_proj = xy / (z + shift)[:, None]
    focal = float((xy_proj * uv).sum() / np.square(xy_proj).sum())
    return shift, focal


def _nearest_resize(x: np.ndarray, size):
    h, w = x.shape[:2]
    th, tw = size
    iy = np.minimum((np.arange(th) * h) // th, h - 1)
    ix = np.minimum((np.arange(tw) * w) // tw, w - 1)
    return x[iy][:, ix]


def recover_focal_shift(points: np.ndarray, mask: Optional[np.ndarray],
                        downsample=(64, 64)):
    """points (H, W, 3) affine point map -> (focal, shift)."""
    H, W = points.shape[:2]
    uv = normalized_view_plane_uv(W, H)
    pts_lr = _nearest_resize(points, downsample)
    uv_lr = _nearest_resize(uv, downsample)
    if mask is not None:
        m_lr = _nearest_resize(mask.astype(np.float32), downsample) > 0
        pts_sel, uv_sel = pts_lr[m_lr], uv_lr[m_lr]
    else:
        pts_sel, uv_sel = pts_lr.reshape(-1, 3), uv_lr.reshape(-1, 2)
    if pts_sel.shape[0] < 2:
        return 1.0, 0.0
    shift, focal = solve_optimal_focal_shift(uv_sel, pts_sel)
    return focal, shift


@torch.no_grad()
def moge_infer(model: MoGe, image01: np.ndarray,
               num_tokens: Optional[int] = None, resolution_level: int = 9,
               apply_mask: bool = True) -> Dict[str, np.ndarray]:
    """image01 (H, W, 3) in [0, 1] -> {"points" (H, W, 3), "depth" (H, W),
    "intrinsics" (3, 3) normalized, "mask" (H, W) bool}, numpy f32; points
    and depth are inf outside the mask when ``apply_mask``."""
    H, W = image01.shape[:2]
    aspect = W / H
    if num_tokens is None:
        lo, hi = model.cfg.num_tokens_range
        num_tokens = int(lo + (resolution_level / 9) * (hi - lo))
    weight = model.encoder.backbone.pos_embed
    img = torch.as_tensor(np.asarray(image01, np.float32).transpose(2, 0, 1)
                          [None], device=weight.device).to(weight.dtype)
    out = model(img, num_tokens)
    points = out["points"][0].float().cpu().numpy()
    mask = out["mask"][0].float().cpu().numpy()
    metric_scale = float(out["metric_scale"][0])
    mask_binary = mask > 0.5

    focal, shift = recover_focal_shift(points, mask_binary)
    fx = focal / 2 * (1 + aspect ** 2) ** 0.5 / aspect
    fy = focal / 2 * (1 + aspect ** 2) ** 0.5
    intrinsics = np.array([[fx, 0, 0.5], [0, fy, 0.5], [0, 0, 1]], np.float32)
    depth = points[..., 2] + shift
    mask_binary &= depth > 0

    # projection-consistent points from depth and intrinsics
    u = (np.arange(W) + 0.5) / W
    v = (np.arange(H) + 0.5) / H
    uu, vv = np.meshgrid(u, v, indexing="xy")
    pts = np.stack([(uu - 0.5) / fx * depth, (vv - 0.5) / fy * depth, depth],
                   axis=-1)
    pts *= metric_scale
    depth = depth * metric_scale
    if apply_mask:
        pts = np.where(mask_binary[..., None], pts, np.inf)
        depth = np.where(mask_binary, depth, np.inf)
    return {"points": pts, "depth": depth, "intrinsics": intrinsics,
            "mask": mask_binary}
