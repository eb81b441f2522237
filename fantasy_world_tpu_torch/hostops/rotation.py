"""Quaternion <-> rotation matrix in numpy, XYZW (scalar last), as the
JAX package's ``hostops/rotation.py`` has them (PyTorch3D's construction,
by way of VGGT)."""
from __future__ import annotations

import numpy as np


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    """(..., 4) XYZW quaternions -> (..., 3, 3) rotation matrices."""
    i, j, k, r = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / (q * q).sum(-1)
    o = np.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j)], axis=-1)
    return o.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrices -> XYZW quaternions with a non-negative w."""
    f = m.reshape(m.shape[:-2] + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = (f[..., i]
                                                  for i in range(9))
    q_abs = np.sqrt(np.maximum(np.stack([
        1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], axis=-1), 0.0))
    quat_by_rijk = np.stack([
        np.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        np.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        np.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        np.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], axis=-2)
    cand = quat_by_rijk / (2.0 * np.maximum(q_abs[..., None], 0.1))
    best = q_abs.argmax(axis=-1)
    out = np.take_along_axis(cand, best[..., None, None].repeat(4, -1),
                             axis=-2)[..., 0, :]
    out = out[..., [1, 2, 3, 0]]                  # rijk -> ijkr
    return np.where(out[..., 3:4] < 0, -out, out)
