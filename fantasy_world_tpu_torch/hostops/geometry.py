"""Host geometry in numpy (the port's copy of the SE3, depth unprojection
and scene-scale functions of ``fantasy_world_tpu/hostops/geometry.py``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def closed_form_inverse_se3(se3: np.ndarray) -> np.ndarray:
    """(N, 4, 4) or (N, 3, 4) camera-from-world -> inverse (N, 4, 4)."""
    R = se3[:, :3, :3]
    T = se3[:, :3, 3:]
    Rt = np.transpose(R, (0, 2, 1))
    out = np.tile(np.eye(4, dtype=np.float64), (len(se3), 1, 1))
    out[:, :3, :3] = Rt
    out[:, :3, 3:] = -Rt @ T
    return out.astype(se3.dtype)


def depth_to_cam_coords_points(depth: np.ndarray, K: np.ndarray
                               ) -> np.ndarray:
    H, W = depth.shape
    fu, fv, cu, cv = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    return np.stack([(u - cu) * depth / fu, (v - cv) * depth / fv, depth],
                    axis=-1).astype(np.float32)


def depth_to_world_coords_points(depth: np.ndarray, extrinsic: np.ndarray,
                                 K: np.ndarray, eps: float = 1e-8
                                 ) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """extrinsic: (3, 4) camera-from-world. Returns (world (H, W, 3),
    cam (H, W, 3), valid mask)."""
    mask = depth > eps
    cam = depth_to_cam_coords_points(depth, K)
    c2w = closed_form_inverse_se3(extrinsic[None])[0]
    world = cam @ c2w[:3, :3].T + c2w[:3, 3]
    return world.astype(np.float32), cam, mask


def normalize_scene(extrinsics: np.ndarray, first_world: np.ndarray,
                    first_mask: np.ndarray) -> np.ndarray:
    """Rebase all extrinsics to the first camera and divide translations by
    the mean scene distance of the 95th-percentile inliers of frame 0's
    world points. extrinsics (S, 3, 4) camera-from-world, first_world
    (H, W, 3), first_mask (H, W) -> (S, 4, 4)."""
    S = extrinsics.shape[0]
    homog = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    homog[:, :3, :] = extrinsics
    first_inv = closed_form_inverse_se3(homog[:1])[0]
    new_extr = homog @ first_inv[None]

    # the reference re-transforms the world points by the first w2c (a
    # no-op when the first frame is the identity; kept for exact parity)
    R, t = extrinsics[0, :3, :3], extrinsics[0, :3, 3]
    pts = first_world.astype(np.float32) @ R.T + t

    dist = np.linalg.norm(pts, axis=-1)
    mask = first_mask.astype(bool)
    final_mask = np.zeros_like(mask)
    valid = dist[mask]
    if valid.size > 0:
        thresh = np.quantile(valid, 0.95)
        final_mask = mask & (dist <= thresh)
    avg_scale = (dist * final_mask).sum() / (final_mask.sum() + 1e-3)
    avg_scale = np.clip(avg_scale, 1e-6, 1e6)
    new_extr[:, :3, 3] /= avg_scale
    return new_extr
