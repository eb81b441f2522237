"""RealEstate10K camera files -> Plucker ray video, on the host in numpy
(``data/re10k.py``): ``RealEstate10KPoseProcessor`` samples a clip's
cameras (strided, the stride backing off where the clip is short,
optionally shuffled), corrects fx or fy where the source's aspect ratio
differs from the sample's, poses them absolutely or relative to the first,
and turns them into rays, flipped left-right at random. Intrinsics in the
files are normalized; the rays multiply them by the sample size (the
pose-encoding path, whose intrinsics are in pixels, multiplies them again,
as the reference model was trained). The trainer reads a clip's
``poses.txt`` through it (``cli/train.py:read_clip``)."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..hostops.camera import (Camera, cameras_from_extri_intri,
                              get_relative_pose, pose_encoding_to_extri_intri,
                              ray_condition)


def load_re10k_cameras(pose_file: str) -> List[Camera]:
    """An optional first line holding the clip's YouTube URL, then one row
    per frame: ``ts fx fy cx cy k1 k2`` and the 3x4 w2c rows."""
    with open(pose_file) as f:
        lines = f.readlines()
    if "youtube" in lines[0]:
        lines = lines[1:]
    return [Camera.from_entry([float(x) for x in line.strip().split(" ")])
            for line in lines]


class RealEstate10KPoseProcessor:
    """Cameras -> (1, n, H, W, 6) rays at ``sample_size`` (H, W).

    Every random draw comes from ``rng`` (an ``np.random.Generator``), in
    this order: the backed-off stride (``integers``), the shuffle
    (``permutation``), the flip (``random``); one seeded generator thus
    gives the JAX package's processor the same frames, order and flip."""

    def __init__(self, sample_stride: int = 4, minimum_sample_stride: int = 1,
                 sample_n_frames: int = 16, relative_pose: bool = False,
                 zero_t_first_frame: bool = False,
                 sample_size: Sequence[int] = (256, 384),
                 rescale_fxy: bool = False, shuffle_frames: bool = False,
                 use_flip: bool = False, is_i2v: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.sample_stride = sample_stride
        self.minimum_sample_stride = minimum_sample_stride
        self.sample_n_frames = sample_n_frames
        self.relative_pose = relative_pose
        self.zero_t_first_frame = zero_t_first_frame
        self.sample_size = (tuple(sample_size)
                            if not isinstance(sample_size, int)
                            else (sample_size, sample_size))
        self.sample_wh_ratio = self.sample_size[1] / self.sample_size[0]
        self.rescale_fxy = rescale_fxy
        self.shuffle_frames = shuffle_frames
        self.use_flip = use_flip
        self.is_i2v = is_i2v
        self.rng = rng or np.random.default_rng()

    def sample_frame_indices(self, total_frames: int) -> np.ndarray:
        """``sample_n_frames`` indices spread evenly over the first
        n * stride frames; where the clip is shorter than that, the stride
        is drawn from [minimum_sample_stride, total // n]. Shuffled under
        ``shuffle_frames``."""
        n = self.sample_n_frames
        if total_frames < n:
            raise ValueError(f"{total_frames} cameras for {n} frames")
        stride = self.sample_stride
        if total_frames < n * stride:
            stride = int(self.rng.integers(self.minimum_sample_stride,
                                           total_frames // n + 1))
        end = min(n * stride, total_frames)
        idx = np.linspace(0, end - 1, n, dtype=int)
        if self.shuffle_frames:
            idx = idx[self.rng.permutation(n)]
        return idx

    def _rescale(self, cams: List[Camera],
                 image_wh: Optional[Tuple[int, int]]) -> None:
        """Under ``rescale_fxy``, correct fx (a source wider than the
        sample) or fy (narrower) of ``cams`` in place for a source of
        ``image_wh`` (W, H) resized to cover the sample."""
        if not self.rescale_fxy or image_wh is None:
            return
        ori_w, ori_h = image_wh
        ori_ratio = ori_w / ori_h
        if ori_ratio > self.sample_wh_ratio:
            resized_w = self.sample_size[0] * ori_ratio
            for c in cams:
                c.fx = resized_w * c.fx / self.sample_size[1]
        else:
            resized_h = self.sample_size[1] / ori_ratio
            for c in cams:
                c.fy = resized_h * c.fy / self.sample_size[0]

    def _embed(self, cams: List[Camera], flip: bool) -> np.ndarray:
        H, W = self.sample_size
        K = np.asarray([[c.fx * W, c.fy * H, c.cx * W, c.cy * H]
                        for c in cams], np.float32)
        if self.relative_pose:
            c2w = get_relative_pose(cams, self.zero_t_first_frame)
        else:
            c2w = np.asarray([c.c2w_mat for c in cams], np.float32)
        plucker = ray_condition(K, c2w, H, W)
        if flip:
            # the rays of the mirrored pixel grid: W reversed
            plucker = plucker[:, :, ::-1]
        return plucker[None]

    def get_plucker_embedding(self, pose_file: str,
                              image_wh: Optional[Tuple[int, int]] = None
                              ) -> np.ndarray:
        """A RealEstate10K camera file -> (1, n, H, W, 6) rays of the
        sampled frames, flipped with probability 1/2 under ``use_flip``."""
        cams = load_re10k_cameras(pose_file)
        if len(cams) < self.sample_n_frames:
            raise ValueError(f"{pose_file}: {len(cams)} cameras for "
                             f"{self.sample_n_frames} frames")
        cams = [cams[i] for i in self.sample_frame_indices(len(cams))]
        self._rescale(cams, image_wh)
        flip = bool(self.use_flip and self.rng.random() < 0.5)
        return self._embed(cams, flip)

    def get_plucker_embedding_direct_from_cam_params(
            self, pose_enc: np.ndarray, image_size: Tuple[int, int],
            image_wh: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """A pose encoding (S, 9) [T | quat | fov_h, fov_w] at
        ``image_size`` (H, W) -> (1, n, H', W', 6) rays of the sampled
        frames at the sample size, never flipped."""
        cams = cameras_from_extri_intri(*pose_encoding_to_extri_intri(
            np.asarray(pose_enc), image_size))
        cams = [cams[i] for i in self.sample_frame_indices(len(cams))]
        self._rescale(cams, image_wh)
        return self._embed(cams, flip=False)
