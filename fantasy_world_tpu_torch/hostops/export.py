"""Video and point-cloud export on the host (the port's copy of
``fantasy_world_tpu/hostops/export.py``): world points re-unprojected from
the predicted depth and cameras, a binary little-endian colored PLY, and
the MP4 through imageio, with a raw ``.npy`` of the frames where imageio
cannot write one."""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from .camera import pose_encoding_to_extri_intri
from .geometry import depth_to_world_coords_points


def get_pointclouds(prediction: dict, fix_first_frame: bool = False
                    ) -> np.ndarray:
    """prediction (numpy, batch 0): depth (1, F, H, W, 1) and pose_enc
    (1, F, 9) -> world points (F, H, W, 3)."""
    depth = np.asarray(prediction["depth"])[0, ..., 0]     # (F, H, W)
    F, H, W = depth.shape
    pose_enc = np.asarray(prediction["pose_enc"])[0]
    extr, intr = pose_encoding_to_extri_intri(pose_enc, (H, W))
    if fix_first_frame:
        extr[0] = np.eye(3, 4)
    pts = []
    for f in range(F):
        wp, _, _ = depth_to_world_coords_points(depth[f], extr[f], intr[f])
        pts.append(wp)
    return np.stack(pts)


def save_colored_pointcloud_ply(points: np.ndarray, colors: np.ndarray,
                                out_path, stride: int = 1,
                                max_points: Optional[int] = None,
                                valid_mask: Optional[np.ndarray] = None,
                                save_first_frame: bool = True) -> None:
    assert points.ndim == 4 and points.shape[-1] == 3
    if not save_first_frame:
        points, colors = points[1:], colors[1:]
        if valid_mask is not None:
            valid_mask = valid_mask[1:]
    points = points[:, ::stride, ::stride, :]
    colors = colors[:, ::stride, ::stride, :]
    if valid_mask is not None:
        m = valid_mask[:, ::stride, ::stride].astype(bool)
        pts = points[m].reshape(-1, 3)
        cols = colors[m].reshape(-1, 3)
    else:
        pts = points.reshape(-1, 3)
        cols = colors.reshape(-1, 3)

    finite = np.isfinite(pts).all(axis=1)
    pts, cols = pts[finite], cols[finite]
    if max_points is not None and pts.shape[0] > max_points:
        idx = np.random.choice(pts.shape[0], max_points, replace=False)
        pts, cols = pts[idx], cols[idx]

    if cols.dtype != np.uint8:
        c = cols.astype(np.float32)
        if c.size and c.max() <= 1.0:
            c = c * 255.0
        cols = np.clip(c, 0, 255).astype(np.uint8)

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    header = "\n".join([
        "ply", "format binary_little_endian 1.0",
        f"element vertex {pts.shape[0]}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        "end_header\n",
    ]).encode("ascii")
    body = np.empty(pts.shape[0],
                    dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    body["xyz"] = pts.astype(np.float32)
    body["rgb"] = cols
    with open(out_path, "wb") as f:
        f.write(header)
        f.write(body.tobytes())


def save_video(frames: np.ndarray, out_path, fps: int = 16) -> str:
    """frames (F, H, W, 3) uint8 -> an MP4 through imageio; where imageio
    is missing or its MP4 backend is absent or cannot write (a served job
    keeps its frames), the raw frames as ``<out_path>.npy``. Returns the
    path written."""
    try:
        import imageio
        imageio.mimwrite(str(out_path), frames, fps=fps, quality=8,
                         macro_block_size=1)
        return str(out_path)
    except Exception as exc:  # noqa: BLE001 -- any backend failure
        alt = str(out_path) + ".npy"
        np.save(alt, frames)
        print(f"imageio unavailable ({exc}); wrote raw frames to {alt}")
        return alt
