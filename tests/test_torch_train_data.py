"""Fine-tuning on clips, the port against the JAX package in f32 on the CPU,
at the tiny configuration of ``tests/test_torch_sampler.py`` (the same
weights on both sides):

  * ``training/data.py:build_train_batch`` on a 9-frame clip: the clean
    latents, umT5 context, CLIP tokens, y and Plucker features within
    1e-5 of the largest magnitude (summation order through the VAE, umT5,
    CLIP and the pose encoder); sigma and timestep a pair of the
    scheduler's tables and the noise of the latents' shape (the JAX side
    draws from ``jax.random``, which the port cannot reproduce);
  * two LoRA steps on one such batch: losses within 1e-4;
  * ``cli.train --data_root`` on the reference layout in a fresh
    interpreter (no JAX): 2 steps saved, a resume to step 3 equal to an
    unbroken 3-step run; its exits; and ``--profile_dir`` on
    ``cli.infer_wan21``."""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax
import jax.numpy as jnp
import optax

from fantasy_world_tpu.data.re10k import (
    RealEstate10KPoseProcessor as JProcessor)
from fantasy_world_tpu.models.fusion.model import split_trainable
from fantasy_world_tpu.pipelines.wan_video import FantasyWorldPipeline as JPipe
from fantasy_world_tpu.training import lora as jlora
from fantasy_world_tpu.training.data import (
    build_train_batch as jax_build_train_batch)

from fantasy_world_tpu_torch.cli import infer_wan21
from fantasy_world_tpu_torch.cli import train as train_cli
from fantasy_world_tpu_torch.convert.from_jax import lora_state_dict
from fantasy_world_tpu_torch.data.video import save_frames
from fantasy_world_tpu_torch.pipelines.wan_video import FantasyWorldPipeline
from fantasy_world_tpu_torch.schedulers.flow_match import FlowMatchScheduler
from fantasy_world_tpu_torch.training.data import build_train_batch
from fantasy_world_tpu_torch.training.lora import (init_lora, lora_state,
                                                   make_lora_train_step)
from test_torch_data import _pose_rows, _write_poses
from test_torch_sampler import (H, J_CFG, J_CLIP, J_POSE, J_T5, J_VAE, PROMPT,
                                W, _cli_argv, _write_reference_layout,
                                make_env)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 9                       # 4k + 1: 3 latent frames
BATCH_RTOL = 1e-5
LOSS_RTOL = 1e-4
RANK = 4


def _clip_frames(n, seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([np.stack([
        127 + 100 * np.sin(xx / (7.0 + c) + yy / 11.0 + 0.4 * t)
        + rng.normal(0, 10, (h, w)) for c in range(3)], -1)
        for t in range(n)]).clip(0, 255).astype(np.uint8)


def _write_clip(root, name, frames, prompt, n_poses, seed):
    clip = root / name
    save_frames(frames, str(clip / "frames"))
    (clip / "prompt.txt").write_text(prompt + "\n")
    _write_poses(clip / "poses.txt", _pose_rows(n_poses, seed))
    return clip


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    env = make_env(root)
    wan, model = _write_reference_layout(root, env["modules"],
                                         np.random.default_rng(7))
    env.update(wan=wan, model=model)
    clips = root / "clips"
    # a 9-frame clip at twice the size (cropped and resized), and an
    # 11-frame clip of which --frames 9 keeps the first 9
    _write_clip(clips, "a", _clip_frames(9, 1, 2 * H, 3 * W), PROMPT, 9, 2)
    _write_clip(clips, "b", _clip_frames(11, 3), "a river at night", 11, 4)
    env["clips"] = str(clips)
    return env


def _pipes(env):
    m = env["modules"]
    tpipe = FantasyWorldPipeline(m["fusion"], m["pose"], t5=m["t5"],
                                 clip=m["clip"], vae=m["vae"],
                                 tokenizer_path=env["tok"])
    jpipe = JPipe(cfg=J_CFG, params=env["trees"], t5_cfg=J_T5,
                  clip_cfg=J_CLIP, vae_cfg=J_VAE, pose_cfg=J_POSE,
                  tokenizer_path=env["tok"])
    return tpipe, jpipe


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def batches(env):
    """The first clip as the trainer reads it, through both packages'
    build_train_batch."""
    frames, prompt, plucker = train_cli.read_clip(
        os.path.join(env["clips"], "a"), H, W, FRAMES)
    tpipe, jpipe = _pipes(env)
    stages = []
    port = build_train_batch(tpipe, frames, prompt,
                             torch.Generator().manual_seed(0),
                             plucker_embedding=plucker,
                             stage_callback=stages.append)
    want = jax_build_train_batch(jpipe, frames, prompt,
                                 jax.random.PRNGKey(0),
                                 plucker_embedding=plucker)
    return {"port": port, "jax": want, "stages": stages, "frames": frames,
            "plucker": plucker}


def test_read_clip(env):
    """min(frames, --frames) frames at --height x --width, not rounded to
    4k + 1; the prompt; one Plucker frame per video frame, equal to the
    JAX processor's as the JAX trainer sets it up."""
    for name, n_frames, want_n in (("a", 9, 9), ("b", 9, 9), ("b", 20, 11),
                                   ("b", 6, 6)):
        clip = os.path.join(env["clips"], name)
        frames, prompt, plucker = train_cli.read_clip(clip, H, W, n_frames)
        assert frames.shape == (want_n, H, W, 3) and frames.dtype == np.uint8
        assert prompt == (PROMPT if name == "a" else "a river at night")
        assert plucker.shape == (1, want_n, H, W, 6)
        want = JProcessor(sample_stride=1, sample_n_frames=want_n,
                          sample_size=(H, W), relative_pose=True,
                          zero_t_first_frame=True, is_i2v=True
                          ).get_plucker_embedding(os.path.join(clip,
                                                               "poses.txt"))
        np.testing.assert_array_equal(plucker, want)


def test_build_train_batch_matches_jax(batches):
    port, want = batches["port"], batches["jax"]
    assert batches["stages"] == ["vae_encode", "clip", "y", "t5", "noise",
                                 "plucker"]
    assert set(port) == set(want)
    # 9 frames -> 3 latent frames of (H / 8, W / 8)
    assert tuple(port["clean_latents"].shape) == (1, 16, 3, H // 8, W // 8)
    for k in ("clean_latents", "context", "clip_feature", "y",
              "plucker_fea"):
        assert port[k].dtype == torch.float32, k
        assert _rel(port[k].numpy(), want[k]) <= BATCH_RTOL, k
    assert port["noise"].shape == port["clean_latents"].shape
    assert tuple(want["noise"].shape) == tuple(port["noise"].shape)
    sched = FlowMatchScheduler().set_timesteps(1000)
    for b in (port, want):
        sigma, t = float(b["sigma"]), float(np.asarray(b["timestep"])[0])
        assert np.asarray(b["timestep"]).shape == (1,)
        pairs = np.flatnonzero((np.float32(sched.sigmas) == np.float32(sigma))
                               & (np.float32(sched.timesteps)
                                  == np.float32(t)))
        assert pairs.size, (sigma, t)


def test_build_train_batch_draws_from_the_generator(env, batches):
    """The same generator seed gives the same batch; another, other noise
    and (almost surely) another timestep."""
    tpipe, _ = _pipes(env)
    again = build_train_batch(tpipe, batches["frames"], PROMPT,
                              torch.Generator().manual_seed(0),
                              plucker_embedding=batches["plucker"])
    other = build_train_batch(tpipe, batches["frames"], PROMPT,
                              torch.Generator().manual_seed(1))
    for k, v in batches["port"].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(again[k], v), k
        else:
            assert again[k] == v, k
    assert not torch.equal(other["noise"], batches["port"]["noise"])
    assert "plucker_fea" not in other
    assert torch.equal(other["clean_latents"],
                       batches["port"]["clean_latents"])


def test_two_lora_steps_on_a_clip_match_jax(env, batches):
    """Two steps of AdamW (constant lr 1e-3) on the clip's batch from the
    same factors (up nonzero, so both factors learn): the losses agree."""
    lite, scan = split_trainable(env["trees"]["fusion"], J_CFG)
    lora = jlora.init_lora(1, scan, rank=RANK, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    lora = {k: {"down": e["down"],
                "up": jnp.asarray(rng.standard_normal(e["up"].shape) * 0.1,
                                  jnp.float32)} for k, e in lora.items()}
    port = batches["port"]
    jbatch = {k: (jnp.float32(v) if isinstance(v, float)
                  else jnp.asarray(v.numpy())) for k, v in port.items()}
    opt = optax.adamw(1e-3, weight_decay=1e-4)
    state = opt.init(lora)
    step = jax.jit(jlora.make_lora_train_step(J_CFG, opt, remat=False))
    want, lo = [], lora
    for _ in range(2):
        lo, state, loss = step(lo, state, (lite, scan), jbatch)
        want.append(float(loss))

    model = copy.deepcopy(env["modules"]["fusion"])
    init_lora(model, RANK, generator=torch.Generator().manual_seed(0))
    factors = lora_state(model)
    with torch.no_grad():
        for name, t in lora_state_dict(lora, model).items():
            factors[name].copy_(t)
    opt_t = torch.optim.AdamW(list(factors.values()), lr=1e-3,
                              weight_decay=1e-4, eps=1e-8)
    step_t = make_lora_train_step(model, opt_t, remat=True)
    got = [float(step_t(port)) for _ in range(2)]
    assert got[1] != got[0]
    for a, b in zip(got, want):
        assert a == pytest.approx(b, rel=LOSS_RTOL)


def _train_argv(env, ckpt, steps, *extra):
    return ["--data_root", env["clips"], "--wan_ckpt_path", env["wan"],
            "--model_ckpt", env["model"], "--tokenizer_path", env["tok"],
            "--lora_rank", "4", "--steps", str(steps), "--height", str(H),
            "--width", str(W), "--frames", str(FRAMES), "--warmup", "1",
            "--lr", "1e-3", "--log_every", "1", "--save_every", "100",
            "--checkpoint_dir", str(ckpt), "--device", "cpu", *extra]


def test_train_cli_on_clips_and_resume(env, tmp_path):
    """``cli.train --data_root`` in a fresh interpreter, which never
    imports JAX: 2 LoRA steps over both clips saved, a resume to step 3,
    and an unbroken 3-step run whose last loss the resumed step equals."""
    runs = [_train_argv(env, tmp_path / "ckpt", 2),
            _train_argv(env, tmp_path / "ckpt", 3),
            _train_argv(env, tmp_path / "straight", 3)]
    code = (
        "import json, sys\n"
        "from fantasy_world_tpu_torch.cli.train import main\n"
        "runs = json.loads(sys.argv[1])\n"
        "print('losses', json.dumps([main(argv) for argv in runs]))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'fantasy_world_tpu')]\n"
        "assert not bad, bad\n")
    env_vars = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code, json.dumps(runs)],
                         cwd=REPO, env=env_vars, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "train done: 2 step(s)" in res.stdout
    assert "train done: 1 step(s)" in res.stdout
    assert "resumed from" in res.stderr
    losses = json.loads(res.stdout.split("losses ", 1)[1].splitlines()[0])
    assert all(np.isfinite(losses))
    assert losses[1] == losses[2]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000002",
                                                     "step_00000003"]
    state = torch.load(tmp_path / "ckpt" / "step_00000003" / "state.pt",
                       weights_only=True)
    names = set(state["trainable"])
    assert names and all(".lora." in n for n in names)
    assert any(t.any() for n, t in state["trainable"].items()
               if n.endswith(".up"))


@pytest.mark.parametrize("drop,extra,message", [
    ("--wan_ckpt_path", (), "needs --wan_ckpt_path, --model_ckpt and "
                            "--data_root"),
    ("--data_root", (), "needs --wan_ckpt_path"),
    (None, ("--mesh_data", "2"), "multi-GPU"),
    (None, ("--pipe_stages", "2"), "multi-GPU"),
])
def test_train_cli_data_mode_exits(env, tmp_path, drop, extra, message):
    argv = _train_argv(env, tmp_path / "x", 1, *extra)
    if drop:
        i = argv.index(drop)
        del argv[i:i + 2]
    with pytest.raises(SystemExit, match=message):
        train_cli.main(argv)
    assert not (tmp_path / "x").exists()


def test_train_cli_data_mode_needs_clips_and_files(env, tmp_path,
                                                   monkeypatch):
    """No clip directories; missing checkpoint files (named); no card
    without --device cpu -- each exits before anything is loaded."""
    empty = tmp_path / "empty"
    empty.mkdir()
    argv = _train_argv(env, tmp_path / "x", 1)
    argv[argv.index("--data_root") + 1] = str(empty)
    with pytest.raises(SystemExit, match="no clip subdirectories"):
        train_cli.main(argv)
    argv = _train_argv(env, tmp_path / "x", 1)
    argv[argv.index("--wan_ckpt_path") + 1] = str(empty)
    with pytest.raises(SystemExit, match="Wan2.1_VAE.pth"):
        train_cli.main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _train_argv(env, tmp_path / "x", 1)[:-2]      # no --device cpu
    with pytest.raises(SystemExit, match="--device cpu"):
        train_cli.main(argv)
    assert not (tmp_path / "x").exists()


def test_infer_wan21_profile_dir(env, tmp_path, capsys):
    """``--profile_dir`` traces the generation into DIR/trace.json and the
    run completes with its outputs."""
    argv = _cli_argv(env, env, tmp_path / "out", "--device", "cpu",
                     "--profile_dir", str(tmp_path / "prof"))
    argv[argv.index("--sample_steps") + 1] = "1"
    r = infer_wan21.main(argv)
    assert "outputs written" in capsys.readouterr().out
    assert os.path.isfile(r["ply"])
    with open(tmp_path / "prof" / "trace.json") as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)            # the VAE ran inside
