"""The port's host data layer against the JAX package's, in numpy on the CPU:
the video and image-folder readers, the RealEstate10K rays as the trainer
reads them, the camera functions of ``hostops/camera.py`` and
``hostops/rotation.py``, and ``cli/make_camera_json.py``. Each case gives
both the same seeded inputs. Readers and JSON must agree exactly; the
float geometry within 1e-6 (f32 on both sides, the same operations in the
same order)."""
import json
import os
import sys

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

from fantasy_world_tpu.cli import make_camera_json as jmcj
from fantasy_world_tpu.data import re10k as jre10k
from fantasy_world_tpu.data import video as jvideo
from fantasy_world_tpu.hostops import camera as jcamera
from fantasy_world_tpu.hostops import rotation as jrot

from fantasy_world_tpu_torch.cli import make_camera_json as mcj
from fantasy_world_tpu_torch.data import re10k
from fantasy_world_tpu_torch.data import video
from fantasy_world_tpu_torch.hostops import camera
from fantasy_world_tpu_torch.hostops import rotation

TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERAS = os.path.join(REPO, "examples", "cameras", "camera_data.json")


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max(initial=0.0) <= tol * max(
        1.0, np.abs(want).max(initial=0.0))


# ---------------------------------------------------------------------------
# data/video.py
# ---------------------------------------------------------------------------

class _Cv2Reader:
    """An MP4 reader with imageio's ffmpeg-reader interface (count_frames,
    get_data, close), decoding through OpenCV: imageio reads MP4 only
    through its ffmpeg or pyav plugin, which need binaries of their own."""

    def __init__(self, path):
        import cv2
        cap = cv2.VideoCapture(str(path))
        self.frames = []
        ok, frame = cap.read()
        while ok:
            self.frames.append(frame[..., ::-1].copy())      # BGR -> RGB
            ok, frame = cap.read()
        cap.release()
        if not self.frames:
            raise ValueError(f"no frames decoded from {path}")

    def count_frames(self):
        return len(self.frames)

    def get_data(self, i):
        return self.frames[i]

    def close(self):
        self.frames = []


def _write_mp4(path, frames, fps=8):
    import cv2
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    assert writer.isOpened()
    for f in frames:
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()


def _frames(n, h, w, seed=0):
    """Smooth seeded frames (a codec keeps most of their content)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        phase = rng.uniform(0, 2 * np.pi, 3)
        img = np.stack([127 + 120 * np.sin(xx / 9.0 + yy / 13.0 + t / 3.0
                                           + p) for p in phase], -1)
        out.append(img.astype(np.uint8))
    return np.stack(out)


@pytest.fixture
def mp4_reader(monkeypatch):
    """imageio.get_reader opens MP4 files through ``_Cv2Reader`` for both
    packages (they call ``imageio.get_reader``)."""
    import imageio
    monkeypatch.setattr(imageio, "get_reader", _Cv2Reader)


@pytest.mark.parametrize("source", ["mp4", "png_folder"])
def test_video_readers_match_jax(tmp_path, mp4_reader, source):
    """VideoData over an MP4 and over a PNG folder (names 0..10: natural
    order, not the lexicographic 0, 1, 10, 2, ...), at the source's size
    and centre-cropped and resized to 32 x 48: the same frames, exactly."""
    frames = _frames(11, 50, 90)
    if source == "mp4":
        path = tmp_path / "video.mp4"
        _write_mp4(path, frames)
        kw = {"video_file": str(path)}
    else:
        folder = tmp_path / "frames"
        video.save_frames(frames, str(folder))
        kw = {"image_folder": str(folder)}
        assert video.search_for_images(str(folder)) == [
            str(folder / f"{i}.png") for i in range(11)]
        assert video.search_for_images(str(folder)) == \
            jvideo.search_for_images(str(folder))
    for size in ({}, {"height": 32, "width": 48}):
        got, want = video.VideoData(**kw, **size), jvideo.VideoData(
            **kw, **size)
        assert len(got) == len(want) == 11
        for i in range(len(got)):
            a, b = got[i], want[i]
            assert a.dtype == np.uint8 and a.shape == b.shape == (
                (32, 48, 3) if size else (50, 90, 3))
            np.testing.assert_array_equal(a, b)
        if source == "png_folder" and not size:
            np.testing.assert_array_equal(
                np.stack([got[i] for i in range(11)]), frames)


@pytest.mark.parametrize("hw", [(64, 96), (96, 64), (50, 50)])
def test_crop_and_resize_matches_jax(hw):
    img = _frames(1, 77, 131, seed=3)[0]
    np.testing.assert_array_equal(video.crop_and_resize(img, *hw),
                                  jvideo.crop_and_resize(img, *hw))
    assert video.crop_and_resize(img, *hw).shape == hw + (3,)


def test_natural_sort_key_matches_jax():
    names = ["f10.png", "f2.png", "f1.png", "g0.jpg", "f02b.png", "10.png",
             "9.png", "a.png", "frame_7_v2.jpg"]
    for n in names:
        assert video.split_file_name(n) == jvideo.split_file_name(n)
    assert sorted(names[:5], key=video.split_file_name) == [
        "f1.png", "f2.png", "f02b.png", "f10.png", "g0.jpg"]
    assert sorted(["10.png", "9.png", "1.png"], key=video.split_file_name
                  ) == ["1.png", "9.png", "10.png"]


def test_save_frames_writes_what_jax_writes(tmp_path):
    frames = _frames(3, 20, 30)
    video.save_frames(frames, str(tmp_path / "port"))
    jvideo.save_frames(frames, str(tmp_path / "jax"))
    for i in range(3):
        assert (tmp_path / "port" / f"{i}.png").read_bytes() == (
            tmp_path / "jax" / f"{i}.png").read_bytes()


def test_video_io_needs_imageio(tmp_path, monkeypatch):
    """Without imageio a video file cannot be read: the same ImportError
    as the JAX package's, and no substitute reader."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    path = str(tmp_path / "video.mp4")
    for mod in (video, jvideo):
        with pytest.raises(ImportError) as exc:
            mod.VideoData(path)
        assert "video IO requires imageio" in str(exc.value)
    with pytest.raises(ValueError, match="Cannot open"):
        video.VideoData()


# ---------------------------------------------------------------------------
# data/re10k.py
# ---------------------------------------------------------------------------

def _pose_rows(n, seed):
    """RE10K rows: ts, normalized fx fy cx cy, k1 k2, a 3x4 w2c of a
    camera turning and moving along a path."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        angle = 0.05 * i + rng.normal(0, 0.01)
        c, s = np.cos(angle), np.sin(angle)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        t = np.array([0.1 * i, rng.normal(0, 0.02), 0.05 * i])
        w2c = np.hstack([R, t[:, None]])
        rows.append([1000 * i, 0.53 + rng.normal(0, 0.01),
                     0.95 + rng.normal(0, 0.01), 0.5, 0.5, 0.0, 0.0]
                    + w2c.flatten().tolist())
    return rows


def _write_poses(path, rows, url=True):
    with open(path, "w") as fh:
        if url:
            fh.write("https://www.youtube.com/watch?v=xyz\n")
        for r in rows:
            fh.write(" ".join(repr(float(x)) for x in r) + "\n")
    return str(path)


def test_load_re10k_cameras_matches_jax(tmp_path):
    rows = _pose_rows(6, 0)
    for url in (True, False):
        path = _write_poses(tmp_path / f"p{url}.txt", rows, url)
        got, want = re10k.load_re10k_cameras(path), \
            jre10k.load_re10k_cameras(path)
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            assert (a.fx, a.fy, a.cx, a.cy) == (b.fx, b.fy, b.cx, b.cy)
            np.testing.assert_array_equal(a.w2c_mat, b.w2c_mat)


@pytest.mark.parametrize("n,size,url", [
    (9, (24, 40), True), (20, (24, 40), False), (5, (16, 24), True),
    (1, (12, 20), True)])
def test_re10k_plucker_matches_jax(tmp_path, n, size, url):
    """The trainer's rays: the first n cameras of a 20-row file, as JAX's
    processor gives them with the JAX trainer's settings (stride 1,
    relative poses, frame 0 at the origin), within 1e-6."""
    path = _write_poses(tmp_path / "poses.txt", _pose_rows(20, 1), url)
    got = re10k.re10k_plucker(path, n, size)
    want = jre10k.RealEstate10KPoseProcessor(
        sample_stride=1, sample_n_frames=n, sample_size=size,
        relative_pose=True, zero_t_first_frame=True,
        is_i2v=True).get_plucker_embedding(path)
    assert got.shape == (1, n) + size + (6,)
    _close(got, want)


def test_re10k_plucker_needs_a_camera_per_frame(tmp_path):
    path = _write_poses(tmp_path / "poses.txt", _pose_rows(4, 1))
    with pytest.raises(ValueError, match="4 cameras for 5 frames"):
        re10k.re10k_plucker(path, 5, (12, 20))


def test_re10k_trainer_rays_are_the_pose_files(tmp_path):
    """The trainer's processor on a file holds the rays of its cameras:
    frame 0 has the identity pose (o = 0, so o x d = 0, and d the pixel
    directions); a frame's ray origins are its camera centre relative to
    frame 0's camera -- a transposed or inverted pose breaks this."""
    rows = _pose_rows(9, 4)
    path = _write_poses(tmp_path / "poses.txt", rows)
    H, W = 12, 20
    out = re10k.re10k_plucker(path, 9, (H, W))[0]
    assert out.shape == (9, H, W, 6)
    np.testing.assert_allclose(out[0, ..., :3], 0.0, atol=1e-6)
    cam = camera.Camera.from_entry(rows[0])
    u = (np.arange(W) + 0.5 - cam.cx * W) / (cam.fx * W)
    v = (np.arange(H) + 0.5 - cam.cy * H) / (cam.fy * H)
    d = np.stack(np.broadcast_arrays(u[None, :], v[:, None],
                                     np.ones((H, W))), -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(out[0, ..., 3:], d, atol=1e-6)
    w2c0 = camera.Camera.from_entry(rows[0]).w2c_mat
    for i in (3, 8):
        c2w = np.linalg.inv(camera.Camera.from_entry(rows[i]).w2c_mat)
        rel = w2c0 @ c2w                     # camera i in frame 0's frame
        o, dirs = rel[:3, 3], out[i, ..., 3:]
        np.testing.assert_allclose(out[i, ..., :3],
                                   np.cross(np.broadcast_to(o, dirs.shape),
                                            dirs), atol=1e-5)


# ---------------------------------------------------------------------------
# hostops/camera.py, hostops/rotation.py
# ---------------------------------------------------------------------------

def test_rotation_matches_jax_and_round_trips():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(16, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = rotation.quat_to_mat(q)
    _close(R, jrot.quat_to_mat(q))
    _close(rotation.mat_to_quat(R), jrot.mat_to_quat(R))
    back = rotation.mat_to_quat(R)
    _close(np.abs(np.sum(back * q, -1)), np.ones(16))
    assert camera.quat_to_mat is rotation.quat_to_mat
    assert camera.mat_to_quat is rotation.mat_to_quat


@pytest.mark.parametrize("seed", [8, 9])
def test_relative_pose_matches_jax(seed):
    rows = _pose_rows(6, seed)
    got = [camera.Camera.from_entry(r) for r in rows]
    want = [jcamera.Camera.from_entry(r) for r in rows]
    _close(camera.get_relative_pose(got),
           jcamera.get_relative_pose(want, zero_t_first_frame=True))
    extr = np.stack([c.w2c_mat[:3] for c in got])
    intr = np.stack([[[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1]]
                     for c in got])
    a = camera.cameras_from_extri_intri(extr, intr)
    b = jcamera.cameras_from_extri_intri(extr, intr)
    for x, y in zip(a, b):
        assert (x.fx, x.fy, x.cx, x.cy) == (y.fx, y.fy, y.cx, y.cy)
        np.testing.assert_array_equal(x.w2c_mat, y.w2c_mat)


# ---------------------------------------------------------------------------
# cli/make_camera_json.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("motion", mcj.MOTIONS)
def test_make_camera_json_matches_jax(tmp_path, motion, capsys):
    argv = ["--motion", motion, "--frames", "9", "--distance", "0.7",
            "--angle", "25"]
    data = mcj.main(["--out", str(tmp_path / "port.json"), *argv])
    jmcj.main(["--out", str(tmp_path / "jax.json"), *argv])
    assert (tmp_path / "port.json").read_text() == (
        tmp_path / "jax.json").read_text()
    assert len(data["cameras_interp"]) == 9
    np.testing.assert_array_equal(data["cameras_interp"][0], np.eye(4))
    assert f"9 poses ({motion})" in capsys.readouterr().out


def test_make_camera_json_keyframes_match_jax(tmp_path):
    """The example path's keyframe pair re-interpolated to 21 poses: the
    same file as JAX's, and the inference loader reads it."""
    argv = ["--keyframes", CAMERAS, "--frames", "21"]
    mcj.main(["--out", str(tmp_path / "port.json"), *argv])
    jmcj.main(["--out", str(tmp_path / "jax.json"), *argv])
    assert (tmp_path / "port.json").read_text() == (
        tmp_path / "jax.json").read_text()
    cams = camera.load_camera_json(str(tmp_path / "port.json"), (24, 40))
    assert len(cams) == 21
    with open(CAMERAS) as fh:
        ends = json.load(fh)["cameras"]
    _close(np.linalg.inv(cams[-1].w2c_mat), np.asarray(ends[-1]))
    with pytest.raises(ValueError, match="unknown motion"):
        mcj.preset_trajectory("roll", 3, 1.0, 10.0)
