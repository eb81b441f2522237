"""Training-era image, depth and camera bookkeeping on the host, in numpy
and PIL (``hostops/geometry_train.py``): crops about the principal point
and short-side resizes that carry the intrinsics (and point tracks) along,
percentile depth thresholding, 90-degree rotations of an image with its
depth, extrinsics, intrinsics and tracks, and readers of images and depth
maps. cv2 is optional: without it the nearest-neighbour depth resize
indexes in numpy.
"""
from __future__ import annotations

import math
import time
from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# crops / resizes with intrinsic bookkeeping
# ---------------------------------------------------------------------------

def crop_image_depth_and_intrinsic_by_pp(image, depth_map, intrinsic,
                                         target_shape, track=None,
                                         strict=False, conf_map=None):
    """Crop centred on the principal point, shifting cx/cy (and the track)
    with it; ``strict`` zero-pads up to target_shape. The axis convention
    is the reference's: cx = intrinsic[1, 2] indexes image rows. Returns
    (image, depth_map, intrinsic, track, conf_map)."""
    original = np.array(image.shape)
    intrinsic = np.copy(intrinsic)
    target_shape = np.asarray(target_shape)
    if original[0] < target_shape[0] or original[1] < target_shape[1]:
        raise AssertionError(
            f"image {original[:2]} smaller than target {target_shape}")

    cx = intrinsic[1, 2]
    cy = intrinsic[0, 2]
    if strict:
        half_x = min(target_shape[0] / 2, cx)
        half_y = min(target_shape[1] / 2, cy)
    else:
        half_x = min(target_shape[0] / 2, cx, original[0] - cx)
        half_y = min(target_shape[1] / 2, cy, original[1] - cy)
    start_x = math.floor(cx) - math.floor(half_x)
    start_y = math.floor(cy) - math.floor(half_y)
    assert start_x >= 0 and start_y >= 0
    if strict:
        end_x = start_x + int(target_shape[0])
        end_y = start_y + int(target_shape[1])
    else:
        end_x = start_x + 2 * math.floor(half_x)
        end_y = start_y + 2 * math.floor(half_y)

    image = image[start_x:end_x, start_y:end_y, :]
    if depth_map is not None:
        depth_map = depth_map[start_x:end_x, start_y:end_y]
    if conf_map is not None:
        conf_map = conf_map[start_x:end_x, start_y:end_y]
    intrinsic[1, 2] -= start_x
    intrinsic[0, 2] -= start_y
    if track is not None:
        track = np.copy(track)
        track[:, 1] -= start_x
        track[:, 0] -= start_y

    if strict and tuple(image.shape[:2]) != tuple(target_shape[:2]):
        pad_h = int(target_shape[0]) - image.shape[0]
        pad_w = int(target_shape[1]) - image.shape[1]
        if pad_h < 0 or pad_w < 0:
            raise ValueError("cropped image bigger than target shape")
        image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)))
        if depth_map is not None:
            depth_map = np.pad(depth_map, ((0, pad_h), (0, pad_w)))
        if conf_map is not None:
            conf_map = np.pad(conf_map, ((0, pad_h), (0, pad_w)))
    return image, depth_map, intrinsic, track, conf_map


def _resize_nearest(arr: np.ndarray, out_wh: Tuple[int, int]) -> np.ndarray:
    try:
        import cv2
        return cv2.resize(arr, out_wh, interpolation=cv2.INTER_NEAREST)
    except ImportError:
        h, w = arr.shape[:2]
        yi = (np.arange(out_wh[1]) * h / out_wh[1]).astype(int)
        xi = (np.arange(out_wh[0]) * w / out_wh[0]).astype(int)
        return arr[yi[:, None], xi[None, :]]


def resize_by_short_side_and_update_intrinsics(image, depth_map, intrinsic,
                                               short_side_target, track=None,
                                               pixel_center=True,
                                               conf_map=None):
    """Scale so the image covers short_side_target by short_side_target *
    592 / 336 (the 336x592 aspect) on its short and long sides, updating
    fx/fy/cx/cy about half-pixel centres (``pixel_center``). Returns
    (image, depth_map, intrinsic, track, conf_map)."""
    from PIL import Image
    long_side_target = short_side_target * 592.0 / 336.0
    h, w = image.shape[:2]
    scale_h = (long_side_target / h if h > w else short_side_target / h)
    scale_w = (short_side_target / w if h > w else long_side_target / w)
    scale = max(scale_h, scale_w)

    intrinsic = np.copy(intrinsic)
    new_w, new_h = int(round(w * scale)), int(round(h * scale))
    resample = (Image.LANCZOS if scale < 1 else Image.BICUBIC)
    image = np.asarray(Image.fromarray(image).resize((new_w, new_h),
                                                     resample=resample))
    if depth_map is not None:
        depth_map = _resize_nearest(depth_map, (new_w, new_h))
    if conf_map is not None:
        conf_map = _resize_nearest(conf_map, (new_w, new_h))

    if pixel_center:
        intrinsic[0, 2] += 0.5
        intrinsic[1, 2] += 0.5
    intrinsic[:2, :] *= scale
    if track is not None:
        track = track * scale
    if pixel_center:
        intrinsic[0, 2] -= 0.5
        intrinsic[1, 2] -= 0.5
    return image, depth_map, intrinsic, track, conf_map


def threshold_depth_map(depth_map: Optional[np.ndarray],
                        max_percentile: float = 99,
                        min_percentile: float = 1,
                        max_depth: float = -1) -> Optional[np.ndarray]:
    """Depths above ``max_depth`` (when > 0) and outside the
    [min_percentile, max_percentile] percentiles zeroed, as float64."""
    if depth_map is None:
        return None
    depth_map = depth_map.astype(float, copy=True)
    if max_depth > 0:
        depth_map[depth_map > max_depth] = 0.0
    if max_percentile > 0:
        hi = np.nanpercentile(depth_map, max_percentile)
        if hi > 0:
            depth_map[depth_map > hi] = 0.0
    if min_percentile > 0:
        lo = np.nanpercentile(depth_map, min_percentile)
        if lo > 0:
            depth_map[depth_map < lo] = 0.0
    return depth_map


# ---------------------------------------------------------------------------
# 90-degree rotations with the cameras' bookkeeping
# ---------------------------------------------------------------------------

def rotate_image_and_depth_rot90(image, depth_map, clockwise):
    axis = 1 if clockwise else 0
    rot_img = np.flip(np.transpose(image, (1, 0, 2)), axis=axis)
    rot_depth = None
    if depth_map is not None:
        rot_depth = np.flip(np.transpose(depth_map, (1, 0)), axis=axis)
        rot_depth = np.copy(rot_depth)
    return np.copy(rot_img), rot_depth


def adjust_extrinsic_matrix_rot90(extri_opencv, clockwise):
    R, t = extri_opencv[:, :3], extri_opencv[:, 3]
    rot = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]] if clockwise else
                   [[0, 1, 0], [-1, 0, 0], [0, 0, 1]], extri_opencv.dtype)
    return np.hstack((rot @ R, (rot @ t).reshape(-1, 1)))


def adjust_intrinsic_matrix_rot90(intri_opencv, image_width, image_height,
                                  clockwise):
    fx, fy = intri_opencv[0, 0], intri_opencv[1, 1]
    cx, cy = intri_opencv[0, 2], intri_opencv[1, 2]
    out = np.eye(3)
    out[0, 0], out[1, 1] = fy, fx
    if clockwise:
        out[0, 2], out[1, 2] = image_height - cy, cx
    else:
        out[0, 2], out[1, 2] = cy, image_width - cx
    return out


def adjust_track_rot90(track, image_width, image_height, clockwise):
    """(N, 2) pixel tracks under a 90-degree image rotation, by the same
    pixel map as the image and the intrinsics: clockwise (x, y) -> (H - 1
    - y, x), counter-clockwise (x, y) -> (y, W - 1 - x). (The reference's
    clockwise branch applies the counter-clockwise map, which puts every
    point 180 degrees from the pixel it annotates; the JAX package fixed
    that, and so does this copy.)"""
    if clockwise:
        # (x, y) -> (H - 1 - y, x), matching the image/intrinsic maps
        return np.stack((image_height - 1 - track[:, 1], track[:, 0]),
                        axis=-1)
    return np.stack((track[:, 1], image_width - 1 - track[:, 0]), axis=-1)


def rotate_90_degrees(image, depth_map, extri_opencv, intri_opencv,
                      clockwise=True):
    """Rotate the image and depth map by 90 degrees and their cameras with
    them: (image, depth_map, extrinsic, intrinsic)."""
    h, w = image.shape[:2]
    image, depth_map = rotate_image_and_depth_rot90(image, depth_map,
                                                    clockwise)
    extri = (adjust_extrinsic_matrix_rot90(extri_opencv, clockwise)
             if extri_opencv is not None else None)
    intri = (adjust_intrinsic_matrix_rot90(intri_opencv, w, h, clockwise)
             if intri_opencv is not None else None)
    return image, depth_map, extri, intri


# ---------------------------------------------------------------------------
# readers; an image read retries on transient file-system errors
# ---------------------------------------------------------------------------

def read_image_retry(path: str, rgb: bool = True, retries: int = 3,
                     delay_s: float = 0.1) -> np.ndarray:
    """An image as (H, W, 3) uint8, RGB (BGR with ``rgb`` False), read
    through PIL; ``retries`` tries ``delay_s`` apart, then IOError."""
    last = None
    for _ in range(retries):
        try:
            from PIL import Image
            img = np.asarray(Image.open(path).convert("RGB"))
            return img if rgb else img[..., ::-1]
        except Exception as e:                       # noqa: BLE001
            last = e
            time.sleep(delay_s)
    raise IOError(f"failed to read {path} after {retries} tries: {last}")


def load_16bit_png_depth(depth_png: str) -> np.ndarray:
    """A 16-bit PNG whose bits are float16 depths (CO3D's storage) ->
    float32 (H, W)."""
    from PIL import Image
    with Image.open(depth_png) as img:
        arr = np.array(img, dtype=np.uint16)
    return arr.view(np.float16).astype(np.float32).reshape(arr.shape)


def read_depth(path: str, scale_adjustment: float = 1.0) -> np.ndarray:
    """A depth map: ``.png`` as ``load_16bit_png_depth``, ``.npy``, or the
    first array of an ``.npz``; times ``scale_adjustment``, non-finite
    values zeroed."""
    if path.endswith(".png"):
        depth = load_16bit_png_depth(path)
    elif path.endswith(".npy"):
        depth = np.load(path).astype(np.float32)
    elif path.endswith(".npz"):
        with np.load(path) as z:
            depth = z[list(z.keys())[0]].astype(np.float32)
    else:
        raise ValueError(f"unsupported depth format: {path}")
    depth = depth * scale_adjustment
    depth[~np.isfinite(depth)] = 0.0
    return depth
