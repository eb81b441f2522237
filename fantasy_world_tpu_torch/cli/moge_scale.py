"""Scene-scale normalization of the camera path (``cli/moge_scale.py``).

With a ``moge_infer`` callable (image (H, W, 3) in [0, 1] -> {"depth",
optionally "mask"}; ``models/moge/infer.py`` over a loaded model), frame
0's predicted depth sets the scale the camera translations are divided by.
Without one it warns and only rebases the path on its first camera, as
the JAX package does when no MoGe weights are installed.
"""
from __future__ import annotations

import numpy as np

from ..hostops.geometry import (closed_form_inverse_se3,
                                depth_to_world_coords_points,
                                normalize_scene)


def moge_scale_normalize(image01: np.ndarray, extrinsics: np.ndarray,
                         intrinsics: np.ndarray,
                         moge_infer=None) -> np.ndarray:
    """extrinsics (S, 4, 4) w2c, intrinsics (S, 3, 3) -> rebased (and, with
    ``moge_infer``, scaled) (S, 4, 4) extrinsics."""
    if moge_infer is None:
        print("[warn] MoGe unavailable; skipping scale normalization")
        S = extrinsics.shape[0]
        out = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
        out[:, :3, :] = extrinsics[:, :3, :]
        first_inv = closed_form_inverse_se3(out[:1])[0]
        return (out @ first_inv[None]).astype(np.float32)

    pred = moge_infer(image01)
    depth = np.asarray(pred["depth"], np.float32)
    depth[~np.isfinite(depth)] = 0
    world, _, mask = depth_to_world_coords_points(
        depth, extrinsics[0, :3, :], intrinsics[0])
    if "mask" in pred:
        mask = mask & np.asarray(pred["mask"], bool)
    return normalize_scene(extrinsics[:, :3, :], world, mask)
