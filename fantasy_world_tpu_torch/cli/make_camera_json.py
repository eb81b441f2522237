"""Write a ``camera_data.json`` camera path for the inference CLIs
(``cli/make_camera_json.py``), from a motion preset or from the keyframe
pair of an existing file.

    python -m fantasy_world_tpu_torch.cli.make_camera_json --out cams.json \\
        [--motion dolly_in] [--frames 81] [--distance 0.5] [--angle 20] \\
        [--keyframes camera_data.json]

The presets (static, dolly, truck, pedestal, pan, tilt, orbit) move the
camera over ``--distance`` scene units or turn it by ``--angle`` degrees;
``--keyframes`` re-interpolates a file's first and last ``cameras`` to
``--frames`` poses (slerp of the rotation by quaternions, lerp of the
centre). The schema, which ``hostops/camera.py:
cameras_json_to_camera_list`` reads:

    {"focal_length": F, "scale": 1,
     "cameras": [first c2w, last c2w], "cameras_interp": [n c2w 4x4]}

OpenCV cameras (x right, y down, z forward), c2w, frame 0 at the identity.
With ``--using_scale`` the inference CLIs rescale the path by MoGe's depth
of the image, so the presets move by modest fractions of a unit.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..hostops.rotation import mat_to_quat, quat_to_mat

MOTIONS = ("static", "dolly_in", "dolly_out", "truck_left", "truck_right",
           "pedestal_up", "pedestal_down", "pan_left", "pan_right",
           "tilt_up", "tilt_down", "orbit_left", "orbit_right")


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _c2w(R=None, t=None):
    m = np.eye(4)
    if R is not None:
        m[:3, :3] = R
    if t is not None:
        m[:3, 3] = t
    return m


def _preset_pose(motion: str, d: float, a: float, distance: float):
    """The c2w pose ``d`` scene units or ``a`` radians into ``motion``."""
    translations = {"static": None, "dolly_in": [0, 0, d],
                    "dolly_out": [0, 0, -d], "truck_left": [-d, 0, 0],
                    "truck_right": [d, 0, 0],
                    "pedestal_up": [0, -d, 0],          # y points down
                    "pedestal_down": [0, d, 0]}
    if motion in translations:
        return _c2w(t=translations[motion])
    rotations = {"pan_left": _rot_y(-a), "pan_right": _rot_y(a),
                 "tilt_up": _rot_x(-a), "tilt_down": _rot_x(a)}
    if motion in rotations:
        return _c2w(R=rotations[motion])
    if motion in ("orbit_left", "orbit_right"):
        # the centre turns about a pivot ``distance`` ahead of the start,
        # which stays in the middle of the view
        R = _rot_y((-1.0 if motion == "orbit_left" else 1.0) * a)
        pivot = np.array([0, 0, distance])
        return _c2w(R=R, t=pivot - R @ pivot)
    raise ValueError(f"unknown motion preset {motion!r}")


def preset_trajectory(motion: str, n: int, distance: float,
                      angle_deg: float) -> np.ndarray:
    """(n, 4, 4) c2w path from the identity pose."""
    ang = np.deg2rad(angle_deg)
    return np.stack([_preset_pose(motion, distance * t, ang * t, distance)
                     for t in np.linspace(0.0, 1.0, n)])


def interpolate_keyframes(c2w_a: np.ndarray, c2w_b: np.ndarray,
                          n: int) -> np.ndarray:
    """(n, 4, 4) c2w poses from ``c2w_a`` to ``c2w_b`` inclusive: slerp of
    the rotation along the shorter arc, lerp of the camera centre."""
    qa = mat_to_quat(np.asarray(c2w_a[:3, :3], np.float64)[None])[0]
    qb = mat_to_quat(np.asarray(c2w_b[:3, :3], np.float64)[None])[0]
    if float(np.dot(qa, qb)) < 0.0:
        qb = -qb
    theta = np.arccos(float(np.clip(np.dot(qa, qb), -1.0, 1.0)))
    ta, tb = np.asarray(c2w_a[:3, 3]), np.asarray(c2w_b[:3, 3])
    out = []
    for t in np.linspace(0.0, 1.0, n):
        if theta < 1e-8:
            q = (1 - t) * qa + t * qb
        else:
            q = (np.sin((1 - t) * theta) * qa + np.sin(t * theta) * qb) \
                / np.sin(theta)
        q = q / np.linalg.norm(q)
        out.append(_c2w(R=quat_to_mat(q[None])[0], t=(1 - t) * ta + t * tb))
    return np.stack(out)


def build_camera_json(c2w: np.ndarray, focal_length: float) -> dict:
    return {
        "focal_length": float(focal_length),
        "scale": 1,
        "cameras": [c2w[0].tolist(), c2w[-1].tolist()],
        "cameras_interp": [m.tolist() for m in c2w],
    }


def main(argv=None) -> dict:
    """Write --out; returns the JSON written."""
    p = argparse.ArgumentParser(
        description="generate camera_data.json for infer_wan21 / infer_wan22")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--motion", type=str, default="dolly_in", choices=MOTIONS)
    p.add_argument("--frames", type=int, default=81)
    p.add_argument("--focal_length", type=float, default=500.0)
    p.add_argument("--distance", type=float, default=0.5,
                   help="total translation (scene units) / orbit radius")
    p.add_argument("--angle", type=float, default=20.0,
                   help="total rotation in degrees (pan/tilt/orbit)")
    p.add_argument("--keyframes", type=str, default=None,
                   help="a camera_data.json whose 'cameras' keyframe pair "
                        "is re-interpolated to --frames (--motion is then "
                        "ignored)")
    args = p.parse_args(argv)

    if args.keyframes:
        with open(args.keyframes) as f:
            kf = json.load(f)
        cams = [np.asarray(c, np.float64) for c in kf["cameras"]]
        c2w = interpolate_keyframes(cams[0], cams[-1], args.frames)
        focal = kf.get("focal_length", args.focal_length)
    else:
        c2w = preset_trajectory(args.motion, args.frames, args.distance,
                                args.angle)
        focal = args.focal_length
    data = build_camera_json(c2w, focal)
    with open(args.out, "w") as f:
        json.dump(data, f)
    print(f"wrote {args.out}: {args.frames} poses "
          f"({'keyframes' if args.keyframes else args.motion})")
    return data


if __name__ == "__main__":
    main()
