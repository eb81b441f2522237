"""The port's training-era host utilities against the JAX package's, on the
CPU: every function of ``hostops/geometry_train.py``, the camera
controller's ``generate_camera_coordinates`` and ``process_pose_file``
(``hostops/camera.py``), ``VideoData``'s length, shape and frame writers
and ``save_video`` (``data/video.py``), and ``FlowMatchScheduler``'s
``step``, ``add_noise``, ``training_target`` and ``training_weight``. Each
case gives both packages the same seeded arrays. Integer images, indices
and shapes must agree exactly; float geometry within 1e-6 relative to its
largest value (the same numpy operations); the scheduler's tensors within
1e-6 (f32 against JAX's f32)."""
import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from fantasy_world_tpu.data import video as jvideo
from fantasy_world_tpu.hostops import camera as jcamera
from fantasy_world_tpu.hostops import geometry_train as jgt
from fantasy_world_tpu.schedulers import FlowMatchScheduler as JSched

from fantasy_world_tpu_torch.data import video
from fantasy_world_tpu_torch.hostops import camera
from fantasy_world_tpu_torch.hostops import geometry_train as gt
from fantasy_world_tpu_torch.schedulers.flow_match import FlowMatchScheduler

TOL = 1e-6


def _same(got, want, tol=TOL):
    """Tuples element by element; None alike; integer arrays exactly, float
    arrays within tol of their largest value (NaN where the other has
    NaN)."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b, tol)
        return
    if want is None:
        assert got is None
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating):
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        got, want = got[~nan], want[~nan]
        scale = max(1.0, float(np.abs(want).max(initial=0.0)))
        assert np.abs(got - want).max(initial=0.0) <= tol * scale
    else:
        np.testing.assert_array_equal(got, want)


def _sample(seed, H=30, W=40):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (H, W, 3), np.uint8)
    depth = rng.uniform(0.5, 8.0, (H, W)).astype(np.float32)
    conf = rng.uniform(0, 1, (H, W)).astype(np.float32)
    intr = np.array([[rng.uniform(20, 40), 0, rng.uniform(15, 25)],
                     [0, rng.uniform(20, 40), rng.uniform(12, 18)],
                     [0, 0, 1]])
    extr = np.hstack([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                      rng.normal(size=(3, 1))])
    track = np.stack([rng.uniform(0, W - 1, 7), rng.uniform(0, H - 1, 7)], -1)
    return img, depth, conf, intr, extr, track


# ---------------------------------------------------------------------------
# hostops/geometry_train.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target,strict", [((16, 20), False),
                                           ((16, 20), True),
                                           ((24, 30), True),
                                           ((30, 40), False)])
def test_crop_by_principal_point_matches_jax(target, strict):
    img, depth, conf, intr, _, track = _sample(1)
    args = (img, depth, intr, target)
    kw = dict(track=track, strict=strict, conf_map=conf)
    _same(gt.crop_image_depth_and_intrinsic_by_pp(*args, **kw),
          jgt.crop_image_depth_and_intrinsic_by_pp(*args, **kw))
    _same(gt.crop_image_depth_and_intrinsic_by_pp(img, None, intr, target),
          jgt.crop_image_depth_and_intrinsic_by_pp(img, None, intr, target))
    with pytest.raises(AssertionError, match="smaller than target"):
        gt.crop_image_depth_and_intrinsic_by_pp(img, depth, intr, (31, 20))


@pytest.mark.parametrize("short,pixel_center", [(16, True), (48, True),
                                                (20, False)])
def test_resize_by_short_side_matches_jax(short, pixel_center):
    """Down (LANCZOS) and up (BICUBIC) through PIL, depth and confidence
    nearest-neighbour, on a wide and a tall image."""
    for H, W in ((30, 40), (40, 30)):
        img, depth, conf, intr, _, track = _sample(2, H, W)
        args = (img, depth, intr, short)
        kw = dict(track=track, pixel_center=pixel_center, conf_map=conf)
        _same(gt.resize_by_short_side_and_update_intrinsics(*args, **kw),
              jgt.resize_by_short_side_and_update_intrinsics(*args, **kw))


def test_nearest_resize_fallback_matches_jax(monkeypatch):
    """Without cv2 both packages index in numpy, to the same pixels."""
    import builtins
    real = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    _, depth, _, _, _, _ = _sample(3)
    for wh in ((17, 11), (80, 60), (40, 30)):
        _same(gt._resize_nearest(depth, wh), jgt._resize_nearest(depth, wh))


@pytest.mark.parametrize("kw", [dict(), dict(max_depth=5.0),
                                dict(max_percentile=90, min_percentile=10),
                                dict(max_percentile=0, min_percentile=0)])
def test_threshold_depth_map_matches_jax(kw):
    _, depth, _, _, _, _ = _sample(4)
    depth[3, 4] = np.nan
    _same(gt.threshold_depth_map(depth, **kw),
          jgt.threshold_depth_map(depth, **kw))
    assert gt.threshold_depth_map(None) is None


@pytest.mark.parametrize("clockwise", [True, False])
def test_rot90_matches_jax(clockwise):
    """The rotation of pixels, depth, cameras and tracks, part by part and
    whole; four turns restore the sample."""
    img, depth, _, intr, extr, track = _sample(5)
    H, W = img.shape[:2]
    _same(gt.rotate_image_and_depth_rot90(img, depth, clockwise),
          jgt.rotate_image_and_depth_rot90(img, depth, clockwise))
    _same(gt.rotate_image_and_depth_rot90(img, None, clockwise),
          jgt.rotate_image_and_depth_rot90(img, None, clockwise))
    _same(gt.adjust_extrinsic_matrix_rot90(extr, clockwise),
          jgt.adjust_extrinsic_matrix_rot90(extr, clockwise))
    _same(gt.adjust_intrinsic_matrix_rot90(intr, W, H, clockwise),
          jgt.adjust_intrinsic_matrix_rot90(intr, W, H, clockwise))
    _same(gt.adjust_track_rot90(track, W, H, clockwise),
          jgt.adjust_track_rot90(track, W, H, clockwise))
    _same(gt.rotate_90_degrees(img, depth, extr, intr, clockwise),
          jgt.rotate_90_degrees(img, depth, extr, intr, clockwise))
    _same(gt.rotate_90_degrees(img, None, None, None, clockwise),
          jgt.rotate_90_degrees(img, None, None, None, clockwise))
    out = (img, depth, extr, intr)
    for _ in range(4):
        out = gt.rotate_90_degrees(*out, clockwise=clockwise)
    _same(out, (img, depth, extr, intr), 1e-12)


def test_readers_match_jax(tmp_path):
    """An image (RGB and BGR), a 16-bit PNG of float16 depths, .npy and
    .npz depths with non-finite values, scaled; a missing file retried,
    then IOError."""
    from PIL import Image
    img, depth, _, _, _, _ = _sample(6)
    Image.fromarray(img).save(tmp_path / "im.png")
    for rgb in (True, False):
        _same(gt.read_image_retry(str(tmp_path / "im.png"), rgb),
              jgt.read_image_retry(str(tmp_path / "im.png"), rgb))
    bits = depth.astype(np.float16).view(np.uint16)
    Image.fromarray(bits).save(tmp_path / "d.png")
    depth[2, 2], depth[5, 1] = np.inf, np.nan
    np.save(tmp_path / "d.npy", depth)
    np.savez(tmp_path / "d.npz", depth=depth)
    for name in ("d.png", "d.npy", "d.npz"):
        _same(gt.read_depth(str(tmp_path / name), 0.5),
              jgt.read_depth(str(tmp_path / name), 0.5))
    _same(gt.load_16bit_png_depth(str(tmp_path / "d.png")),
          jgt.load_16bit_png_depth(str(tmp_path / "d.png")))
    with pytest.raises(IOError, match="after 2 tries"):
        gt.read_image_retry(str(tmp_path / "none.png"), retries=2,
                            delay_s=0.0)
    with pytest.raises(ValueError, match="unsupported depth format"):
        gt.read_depth(str(tmp_path / "d.exr"))


# ---------------------------------------------------------------------------
# hostops/camera.py: the camera controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["push_in", "pull_out", "move_left",
                                       "move_right", "pan_left",
                                       "pan_right", "orbit_left",
                                       "orbit_right"])
def test_generate_camera_coordinates_matches_jax(direction):
    for length, speed in ((1, 1 / 54), (6, 1 / 54), (4, 0.5)):
        got = camera.generate_camera_coordinates(direction, length, speed)
        want = jcamera.generate_camera_coordinates(direction, length, speed)
        assert got == want and len(got) == length
    with pytest.raises(ValueError, match="unknown camera direction"):
        camera.generate_camera_coordinates("spin", 3)


def _interp(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = 0.05 * i + rng.normal(0, 0.01)
        out.append([np.cos(a), 0, np.sin(a), 0.02 * i, 0, 1, 0, 0.01 * i,
                    -np.sin(a), 0, np.cos(a), 0.03 * i])
    return out


def test_generate_camera_coordinates_interp_matches_jax():
    interp = _interp(5, 1)
    got = camera.generate_camera_coordinates("push_in", 5,
                                             cameras_interp=interp)
    want = jcamera.generate_camera_coordinates("push_in", 5,
                                               cameras_interp=interp)
    assert got == want
    with pytest.raises(ValueError, match="4 cameras for 5 frames"):
        camera.generate_camera_coordinates("push_in", 5,
                                           cameras_interp=interp[:4])


@pytest.mark.parametrize("size,pose_wh", [((64, 32), (1280, 720)),
                                          ((32, 48), (1280, 720)),
                                          ((40, 40), (640, 960))])
def test_process_pose_file_matches_jax(size, pose_wh):
    """Both aspect branches (the poses wider, then narrower, than the
    sample), on a direction walk and an interpolated path."""
    width, height = size
    for entries in (camera.generate_camera_coordinates("orbit_left", 4),
                    camera.generate_camera_coordinates(
                        "push_in", 5, cameras_interp=_interp(5, 2))):
        kw = dict(width=width, height=height, original_pose_width=pose_wh[0],
                  original_pose_height=pose_wh[1])
        got = camera.process_pose_file(entries, **kw)
        assert got.shape == (1, len(entries), height, width, 6)
        _same(got, jcamera.process_pose_file(entries, **kw))
    assert camera.process_pose_file(entries, return_poses=True) is entries


# ---------------------------------------------------------------------------
# data/video.py
# ---------------------------------------------------------------------------

def _folder(tmp_path, n=5, H=18, W=30):
    from PIL import Image
    rng = np.random.default_rng(7)
    folder = tmp_path / "frames"
    folder.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (H, W, 3), np.uint8)).save(
            folder / f"{i}.png")
    return str(folder)


def test_video_data_extras_match_jax(tmp_path):
    """set_length, set_shape, shape, raw_data and save_images on an image
    folder: the same frames as JAX's, written as the same PNGs."""
    folder = _folder(tmp_path)
    mine = video.VideoData(image_folder=folder)
    theirs = jvideo.VideoData(image_folder=folder)
    assert mine.shape() == theirs.shape() == (18, 30)
    for v in (mine, theirs):
        v.set_length(3)
        v.set_shape(12, 16)
    assert len(mine) == len(theirs) == 3
    assert mine.shape() == theirs.shape() == (12, 16)
    got, want = mine.raw_data(), theirs.raw_data()
    assert len(got) == 3
    for a, b in zip(got, want):
        _same(a, b)
    mine.save_images(str(tmp_path / "mine"))
    theirs.save_images(str(tmp_path / "theirs"))
    assert sorted(os.listdir(tmp_path / "mine")) == ["0.png", "1.png",
                                                     "2.png"]
    for name in os.listdir(tmp_path / "theirs"):
        assert (tmp_path / "mine" / name).read_bytes() == \
            (tmp_path / "theirs" / name).read_bytes()
    mine.set_length(None)
    assert len(mine) == 5


class _NpyVideo:
    """imageio's writer and reader interface over a ``.npy`` of frames: the
    test's stand-in for an encoder (imageio writes MP4 only through an
    ffmpeg or pyav plugin, which need binaries of their own). It records
    the writer's arguments."""

    def __init__(self):
        self.calls = []

    def get_writer(self, path, **kw):
        self.calls.append((os.path.basename(path), kw))
        frames = []

        class Writer:
            def append_data(self, frame):
                frames.append(np.array(frame))

            def close(self):
                np.save(path + ".npy", np.stack(frames))
        return Writer()

    def get_reader(self, path):
        frames = np.load(path + ".npy")

        class Reader:
            def count_frames(self):
                return len(frames)

            def get_data(self, i):
                return frames[i]

            def close(self):
                pass
        return Reader()


def test_save_video_round_trip_matches_jax(tmp_path, monkeypatch):
    """``save_video`` hands the writer what JAX's hands it (fps, quality,
    ffmpeg parameters, each frame), and the port's reader reads the frames
    back."""
    folder = _folder(tmp_path)
    frames = video.VideoData(image_folder=folder).raw_data()
    fake = _NpyVideo()
    monkeypatch.setattr(video, "_imageio", lambda: fake)
    monkeypatch.setattr(jvideo, "_imageio", lambda: fake)
    video.save_video(frames, str(tmp_path / "mine.mp4"), fps=12, quality=7,
                     ffmpeg_params=["-crf", "18"])
    jvideo.save_video(frames, str(tmp_path / "theirs.mp4"), fps=12,
                      quality=7, ffmpeg_params=["-crf", "18"])
    assert [kw for _, kw in fake.calls] == [
        {"fps": 12, "quality": 7, "ffmpeg_params": ["-crf", "18"]}] * 2
    back = video.VideoData(str(tmp_path / "mine.mp4"))
    assert len(back) == len(frames) and back.shape() == (18, 30)
    for a, b in zip(back.raw_data(), frames):
        _same(a, b)
    np.testing.assert_array_equal(np.load(tmp_path / "mine.mp4.npy"),
                                  np.load(tmp_path / "theirs.mp4.npy"))


# ---------------------------------------------------------------------------
# schedulers/flow_match.py
# ---------------------------------------------------------------------------

def _scheds(n, **kw):
    return (FlowMatchScheduler(**kw).set_timesteps(n),
            JSched(**kw).set_timesteps(n))


@pytest.mark.parametrize("kw", [dict(), dict(inverse_timesteps=True),
                                dict(reverse_sigmas=True, shift=3.0)])
def test_flow_match_step_and_noise_match_jax(kw):
    """``step`` at every index (the last to the final sigma, and
    ``to_final`` early), ``add_noise`` and ``training_target``."""
    n = 6
    mine, theirs = _scheds(n, **kw)
    rng = np.random.default_rng(8)
    x, v, noise = (rng.standard_normal((2, 4, 3, 5)).astype(np.float32)
                   for _ in range(3))
    tx, tv, tn = map(torch.from_numpy, (x, v, noise))
    jx, jv, jn = map(jnp.asarray, (x, v, noise))
    for i in range(n):
        for final in (False, True):
            _same(mine.step(tv, i, tx, to_final=final).numpy(),
                  np.asarray(theirs.step(jv, i, jx, to_final=final)))
        _same(mine.add_noise(tx, tn, i).numpy(),
              np.asarray(theirs.add_noise(jx, jn, i)))
    _same(mine.training_target(tx, tn, 2).numpy(),
          np.asarray(theirs.training_target(jx, jn, 2)))


@pytest.mark.parametrize("n", [1000, 50])
def test_flow_match_training_weight_matches_jax(n):
    mine, theirs = _scheds(1000)
    got = mine.training_weight(n)
    _same(got, theirs.training_weight(n))
    assert got.shape == (1000,) and got.dtype == np.float32
