"""The port's RealEstate10K pose processor (``data/re10k.py``) against the
JAX package's, in numpy on the CPU. Each case gives both processors the
same camera file (or pose encoding) and a generator of one seed each, so
the stride drawn where the clip is short, the shuffle and the flip must
come out alike: the sampled indices equal, the rays within 1e-6 relative
to their largest value (f32 on both sides, the same operations). The
trainer's ``read_clip`` is held to the JAX trainer's ``_data_batches``
call of the processor, and to the rays of the clip's first n cameras as
the port computed them before the processor (the same bits)."""
import argparse
import os

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

from fantasy_world_tpu.cli import train as jtrain
from fantasy_world_tpu.data import re10k as jre10k
from fantasy_world_tpu.hostops import camera as jcamera

from fantasy_world_tpu_torch.cli import train as train_cli
from fantasy_world_tpu_torch.data import re10k
from fantasy_world_tpu_torch.hostops import camera

from test_torch_data import _close, _pose_rows, _write_poses

TOL = 1e-6
SIZE = (12, 20)

# (name, the processors' keyword arguments, the source (W, H) or None)
CASES = [
    ("stride", dict(sample_stride=2, sample_n_frames=6), None),
    ("stride_backed_off", dict(sample_stride=4, sample_n_frames=6,
                               minimum_sample_stride=1), None),
    ("shuffled", dict(sample_stride=3, sample_n_frames=5,
                      shuffle_frames=True), None),
    ("backed_off_shuffled", dict(sample_stride=8, sample_n_frames=7,
                                 shuffle_frames=True), None),
    ("rescale_wider", dict(sample_stride=1, sample_n_frames=5,
                           rescale_fxy=True), (1280, 720)),
    ("rescale_narrower", dict(sample_stride=1, sample_n_frames=5,
                              rescale_fxy=True), (480, 640)),
    ("absolute", dict(sample_stride=2, sample_n_frames=6,
                      relative_pose=False), None),
    ("relative_zero_t", dict(sample_stride=2, sample_n_frames=6,
                             relative_pose=True, zero_t_first_frame=True),
     None),
    ("relative_t", dict(sample_stride=2, sample_n_frames=6,
                        relative_pose=True, zero_t_first_frame=False), None),
    ("flip", dict(sample_stride=4, sample_n_frames=6, use_flip=True,
                  shuffle_frames=True, relative_pose=True), None),
]
FRAMES = 20          # rows of the camera file: a stride of 4 x 6 backs off


def _processors(kw, seed):
    return (re10k.RealEstate10KPoseProcessor(
                sample_size=SIZE, rng=np.random.default_rng(seed), **kw),
            jre10k.RealEstate10KPoseProcessor(
                sample_size=SIZE, rng=np.random.default_rng(seed), **kw))


@pytest.mark.parametrize("name,kw,image_wh", CASES,
                         ids=[c[0] for c in CASES])
def test_processor_matches_jax(tmp_path, name, kw, image_wh):
    """Three calls on one generator each (its draws run on from call to
    call): the indices each draws, then the rays of three more calls."""
    path = _write_poses(tmp_path / "poses.txt", _pose_rows(FRAMES, 2))
    for seed in range(3):
        mine, theirs = _processors(kw, seed)
        for _ in range(3):
            got = mine.sample_frame_indices(FRAMES)
            want = theirs.sample_frame_indices(FRAMES)
            np.testing.assert_array_equal(got, want)
        for _ in range(3):
            _close(mine.get_plucker_embedding(path, image_wh),
                   theirs.get_plucker_embedding(path, image_wh), TOL)


def test_processor_draws_every_mode(tmp_path):
    """The cases above reach each mode: the stride backs off to more than
    one value, the shuffle permutes, the flip both flips and does not
    (the flipped rays are the unflipped ones with W reversed), and each
    rescale branch moves its focal length only."""
    n = 6
    strides = set()
    for seed in range(8):
        mine, _ = _processors(dict(sample_stride=4, sample_n_frames=n), seed)
        idx = mine.sample_frame_indices(FRAMES)
        assert np.all(np.diff(idx) > 0) and (idx[-1] + 1) % n == 0
        strides.add((int(idx[-1]) + 1) // n)      # the last is n * stride - 1
    assert len(strides) > 1 and strides <= {1, 2, 3}
    mine, _ = _processors(dict(sample_stride=2, sample_n_frames=n,
                               shuffle_frames=True), 0)
    idx = mine.sample_frame_indices(FRAMES)
    even = np.linspace(0, 2 * n - 1, n, dtype=int)
    assert sorted(idx) == list(even) and list(idx) != list(even)

    path = _write_poses(tmp_path / "poses.txt", _pose_rows(FRAMES, 2))
    plain = re10k.RealEstate10KPoseProcessor(
        sample_stride=1, sample_n_frames=n, sample_size=SIZE,
        relative_pose=True).get_plucker_embedding(path)
    flips = []
    for seed in range(6):
        proc = re10k.RealEstate10KPoseProcessor(
            sample_stride=1, sample_n_frames=n, sample_size=SIZE,
            relative_pose=True, use_flip=True,
            rng=np.random.default_rng(seed))
        out = proc.get_plucker_embedding(path)
        flips.append(not np.array_equal(out, plain))
        np.testing.assert_array_equal(out, plain[:, :, :, ::-1]
                                      if flips[-1] else plain)
    assert any(flips) and not all(flips)

    for wh, moved in (((1280, 720), "fx"), ((480, 640), "fy")):
        proc = re10k.RealEstate10KPoseProcessor(
            sample_size=SIZE, rescale_fxy=True)
        cams = [camera.Camera.from_entry(r) for r in _pose_rows(3, 5)]
        before = [(c.fx, c.fy, c.cx, c.cy) for c in cams]
        proc._rescale(cams, wh)
        for c, (fx, fy, cx, cy) in zip(cams, before):
            assert (c.cx, c.cy) == (cx, cy)
            assert (c.fx != fx) == (moved == "fx")
            assert (c.fy != fy) == (moved == "fy")


@pytest.mark.parametrize("kw", [
    dict(sample_stride=1, sample_n_frames=5, relative_pose=True,
         zero_t_first_frame=True),
    dict(sample_stride=3, sample_n_frames=4, shuffle_frames=True,
         relative_pose=False),
    dict(sample_stride=1, sample_n_frames=5, relative_pose=True,
         zero_t_first_frame=False, rescale_fxy=True)],
    ids=["relative", "shuffled_absolute", "rescaled_t"])
def test_direct_from_cam_params_matches_jax(kw):
    """A pose encoding (S, 9) at (H, W) through both processors' direct
    path: the same rays, never flipped."""
    rng = np.random.default_rng(6)
    S = 9
    q = rng.normal(size=(S, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    enc = np.concatenate([rng.normal(0, 0.5, (S, 3)), q,
                          rng.uniform(0.6, 1.2, (S, 2))], -1
                         ).astype(np.float32)
    for seed in range(2):
        mine, theirs = _processors(dict(kw, use_flip=True), seed)
        _close(mine.get_plucker_embedding_direct_from_cam_params(
                   enc, (48, 80), (1280, 720)),
               theirs.get_plucker_embedding_direct_from_cam_params(
                   enc, (48, 80), (1280, 720)), TOL)


def test_relative_pose_with_translation_matches_jax():
    """``get_relative_pose(zero_t_first_frame=False)``: frame 0 moved along
    -y by its camera's distance from the origin, as JAX's."""
    rows = _pose_rows(5, 7)
    got = camera.get_relative_pose(
        [camera.Camera.from_entry(r) for r in rows], zero_t_first_frame=False)
    want = jcamera.get_relative_pose(
        [jcamera.Camera.from_entry(r) for r in rows],
        zero_t_first_frame=False)
    _close(got, want, TOL)
    assert got[0, 1, 3] < 0


def test_short_file_raises(tmp_path):
    path = _write_poses(tmp_path / "poses.txt", _pose_rows(4, 1))
    proc = re10k.RealEstate10KPoseProcessor(sample_n_frames=5,
                                            sample_size=SIZE)
    with pytest.raises(ValueError, match="4 cameras for 5 frames"):
        proc.get_plucker_embedding(path)
    with pytest.raises(ValueError, match="4 cameras for 5 frames"):
        proc.sample_frame_indices(4)


def _clip(root, n_png, n_poses):
    from PIL import Image
    clip = os.path.join(root, "clip")
    os.makedirs(os.path.join(clip, "frames"))
    rng = np.random.default_rng(3)
    for i in range(n_png):
        Image.fromarray(rng.integers(0, 255, (24, 36, 3), np.uint8)).save(
            os.path.join(clip, "frames", f"{i}.png"))
    with open(os.path.join(clip, "prompt.txt"), "w") as fh:
        fh.write("a street")
    _write_poses(os.path.join(clip, "poses.txt"), _pose_rows(n_poses, 4))
    return clip


def _first_cameras_rays(pose_file, n, size):
    """The rays of a clip's first n cameras, relative to the first, which
    sits at the origin: what ``read_clip`` returned before it went through
    the processor."""
    cams = re10k.load_re10k_cameras(pose_file)[:n]
    H, W = size
    K = np.asarray([[c.fx * W, c.fy * H, c.cx * W, c.cy * H] for c in cams],
                   np.float32)
    return camera.ray_condition(K, camera.get_relative_pose(cams), H, W)[None]


@pytest.mark.parametrize("frames", [5, 7])
def test_read_clip_rays_match_jax_data_batches(tmp_path, monkeypatch,
                                               frames):
    """``read_clip``'s rays are the JAX trainer's: ``_data_batches`` hands
    its processor's rays to ``build_train_batch`` (caught here), and the
    port's equal them bit for bit, and equal the first n cameras' rays."""
    from fantasy_world_tpu.training import data as jdata
    _clip(tmp_path, 7, 9)
    seen = []
    monkeypatch.setattr(jdata, "build_train_batch",
                        lambda pipe, fr, prompt, key, plucker_embedding:
                        seen.append((fr, plucker_embedding)))
    args = argparse.Namespace(data_root=str(tmp_path), seed=0, height=16,
                              width=24, frames=frames)
    batches = jtrain._data_batches(None, args)
    next(batches, None)
    want_frames, want = seen[0]
    got_frames, prompt, got = train_cli.read_clip(
        os.path.join(tmp_path, "clip"), 16, 24, frames)
    assert prompt == "a street"
    np.testing.assert_array_equal(got_frames, want_frames)
    assert got.shape == (1, frames, 16, 24, 6)
    np.testing.assert_array_equal(got, want)
    assert got.tobytes() == _first_cameras_rays(
        os.path.join(tmp_path, "clip", "poses.txt"), frames,
        (16, 24)).tobytes()


def test_read_clip_short_pose_file_raises(tmp_path):
    clip = _clip(tmp_path, 7, 5)
    with pytest.raises(ValueError, match="5 cameras for 7 frames"):
        train_cli.read_clip(clip, 16, 24, 9)
    frames, _, plucker = train_cli.read_clip(clip, 16, 24, 9,
                                             with_plucker=False)
    assert frames.shape == (7, 16, 24, 3) and plucker is None
