"""Cameras -> Plucker ray video, on the host in numpy (``hostops/camera.py``
and ``hostops/geometry.py``): camera JSON and 19-float camera entries,
the inference path's pose-encoding round trip, first-frame-relative poses
with zero translation and per-pixel [o x d, d] rays. The quaternion
functions live in ``hostops/rotation.py`` and are re-exported here."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .rotation import mat_to_quat, quat_to_mat


@dataclasses.dataclass
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    w2c_mat: np.ndarray      # (4, 4)

    @property
    def c2w_mat(self) -> np.ndarray:
        return np.linalg.inv(self.w2c_mat)

    @classmethod
    def from_entry(cls, entry: Sequence[float]) -> "Camera":
        """A 19-float entry: ``ts fx fy cx cy k1 k2`` then the 3x4 w2c
        rows (the RE10K and camera-controller layout)."""
        fx, fy, cx, cy = entry[1:5]
        w2c = np.eye(4)
        w2c[:3, :] = np.asarray(entry[7:], np.float64).reshape(3, 4)
        return cls(fx, fy, cx, cy, w2c)


def cameras_json_to_camera_list(data: dict, image_size: Tuple[int, int]
                                ) -> List[Camera]:
    """{focal_length, cameras_interp: [16-float c2w ...]} -> cameras with
    the principal point at the image centre."""
    fx = fy = float(data.get("focal_length", 500))
    H, W = image_size
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    cams = []
    for c2w in data["cameras_interp"]:
        w2c = np.eye(4)
        w2c[:3, :] = np.linalg.inv(
            np.asarray(c2w, np.float64).reshape(4, 4))[:3, :]
        cams.append(Camera(fx, fy, cx, cy, w2c))
    return cams


def extri_intri_to_pose_encoding(extrinsics: np.ndarray,
                                 intrinsics: np.ndarray,
                                 image_size_hw: Tuple[int, int]) -> np.ndarray:
    """(S, 3, 4) + (S, 3, 3) -> (S, 9) [T | quat | fov_h, fov_w]."""
    quat = mat_to_quat(extrinsics[:, :3, :3])
    H, W = image_size_hw
    fov_h = 2 * np.arctan((H / 2) / intrinsics[:, 1, 1])
    fov_w = 2 * np.arctan((W / 2) / intrinsics[:, 0, 0])
    return np.concatenate([extrinsics[:, :3, 3], quat, fov_h[:, None],
                           fov_w[:, None]], axis=-1).astype(np.float32)


def pose_encoding_to_extri_intri(pose_enc: np.ndarray,
                                 image_size_hw: Tuple[int, int]):
    """(S, 9) -> (extrinsics (S, 3, 4), intrinsics (S, 3, 3))."""
    T, quat = pose_enc[..., :3], pose_enc[..., 3:7]
    fov_h, fov_w = pose_enc[..., 7], pose_enc[..., 8]
    extr = np.concatenate([quat_to_mat(quat), T[..., None]], axis=-1)
    H, W = image_size_hw
    intr = np.zeros(pose_enc.shape[:-1] + (3, 3), pose_enc.dtype)
    intr[..., 0, 0] = (W / 2.0) / np.tan(fov_w / 2.0)
    intr[..., 1, 1] = (H / 2.0) / np.tan(fov_h / 2.0)
    intr[..., 0, 2] = W / 2
    intr[..., 1, 2] = H / 2
    intr[..., 2, 2] = 1.0
    return extr.astype(np.float32), intr


def cameras_from_extri_intri(extrinsics: np.ndarray,
                             intrinsics: np.ndarray) -> List[Camera]:
    """(S, 3, 4) w2c + (S, 3, 3) -> cameras."""
    cams = []
    for ext, K in zip(extrinsics, intrinsics):
        w2c = np.eye(4)
        w2c[:3, :] = ext
        cams.append(Camera(float(K[0, 0]), float(K[1, 1]),
                           float(K[0, 2]), float(K[1, 2]), w2c))
    return cams


def get_relative_pose(cams: List[Camera]) -> np.ndarray:
    """First-frame-centric c2w poses, zero translation on frame 0."""
    target = np.eye(4)
    abs2rel = target @ cams[0].w2c_mat
    poses = [target] + [abs2rel @ c.c2w_mat for c in cams[1:]]
    return np.asarray(poses, np.float32)


def ray_condition(K: np.ndarray, c2w: np.ndarray, H: int, W: int
                  ) -> np.ndarray:
    """K (V, 4) [fx fy cx cy] in pixels, c2w (V, 4, 4) -> (V, H, W, 6)
    Plucker [o x d, d] at half-pixel centres."""
    V = K.shape[0]
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    i = i.reshape(1, H * W) + 0.5
    j = j.reshape(1, H * W) + 0.5
    fx, fy, cx, cy = (K[:, k:k + 1] for k in range(4))
    zs = np.ones_like(i) * np.ones((V, 1), np.float32)
    dirs = np.stack([np.broadcast_to((i - cx) / fx, (V, H * W)),
                     np.broadcast_to((j - cy) / fy, (V, H * W)), zs], -1)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays_d = dirs @ np.transpose(c2w[:, :3, :3], (0, 2, 1)).astype(np.float32)
    rays_o = np.broadcast_to(c2w[:, None, :3, 3], rays_d.shape
                             ).astype(np.float32)
    plucker = np.concatenate([np.cross(rays_o, rays_d), rays_d], axis=-1)
    return plucker.reshape(V, H, W, 6)


def plucker_from_pose_encoding(pose_enc: np.ndarray,
                               image_size_hw: Tuple[int, int]) -> np.ndarray:
    """pose_enc (S, 9) -> Plucker video (1, S, H, W, 6): relative poses with
    a zero-translation first frame, and the intrinsics multiplied by the
    image size again, as the reference was trained."""
    H, W = image_size_hw
    cams = cameras_from_extri_intri(*pose_encoding_to_extri_intri(
        pose_enc, (H, W)))
    K = np.asarray([[c.fx * W, c.fy * H, c.cx * W, c.cy * H] for c in cams],
                   np.float32)
    return ray_condition(K, get_relative_pose(cams), H, W)[None]


def camera_matrices(cams: List[Camera]) -> Tuple[np.ndarray, np.ndarray]:
    """Camera list -> (extrinsics (S, 4, 4) w2c, intrinsics (S, 3, 3)),
    f32."""
    intr = np.stack([[[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1]]
                     for c in cams]).astype(np.float32)
    extr = np.stack([c.w2c_mat for c in cams]).astype(np.float32)
    return extr, intr


def plucker_from_cameras(cams: List[Camera], image_size_hw: Tuple[int, int]
                         ) -> np.ndarray:
    """Camera list -> Plucker video (1, S, H, W, 6) without scene-scale
    normalization (the sampler's ``prepare_camera(using_scale=False)``)."""
    extr, intr = camera_matrices(cams)
    return plucker_from_pose_encoding(
        extri_intri_to_pose_encoding(extr[:, :3, :], intr, image_size_hw),
        image_size_hw)


def load_camera_json(path: str, image_size: Tuple[int, int],
                     num_frames: Optional[int] = None) -> List[Camera]:
    import json
    with open(path) as fh:
        cams = cameras_json_to_camera_list(json.load(fh), image_size)
    return cams if num_frames is None else cams[:num_frames]

