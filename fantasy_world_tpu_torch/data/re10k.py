"""RealEstate10K camera files -> Plucker ray video, on the host in numpy
(``data/re10k.py``), as the trainer reads a clip's ``poses.txt``: the
first n cameras, posed relative to the first one, which sits at the
origin. Intrinsics in the files are normalized; the rays multiply them by
the sample size."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..hostops.camera import Camera, get_relative_pose, ray_condition


def load_re10k_cameras(pose_file: str) -> List[Camera]:
    """An optional first line holding the clip's YouTube URL, then one row
    per frame: ``ts fx fy cx cy k1 k2`` and the 3x4 w2c rows."""
    with open(pose_file) as f:
        lines = f.readlines()
    if "youtube" in lines[0]:
        lines = lines[1:]
    return [Camera.from_entry([float(x) for x in line.strip().split(" ")])
            for line in lines]


def re10k_plucker(pose_file: str, n_frames: int,
                  sample_size: Tuple[int, int]) -> np.ndarray:
    """The file's first ``n_frames`` cameras -> (1, n_frames, H, W, 6)
    rays at sample_size (H, W)."""
    cams = load_re10k_cameras(pose_file)
    if len(cams) < n_frames:
        raise ValueError(f"{pose_file}: {len(cams)} cameras for {n_frames} "
                         f"frames")
    cams = cams[:n_frames]
    H, W = sample_size
    K = np.asarray([[c.fx * W, c.fy * H, c.cx * W, c.cy * H] for c in cams],
                   np.float32)
    return ray_condition(K, get_relative_pose(cams), H, W)[None]
