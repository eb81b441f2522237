"""The port's conditioning units against the JAX package, in f32 on the
CPU: the runner's semantics (the negative side of a ``seperate_cfg`` unit
aliases the positive outputs at cfg_scale 1), every unit of
``DEFAULT_UNITS`` on the same inputs and weights (umT5, CLIP and the 2.1
VAE: JAX ``init_*`` trees carried across; the 38-block VAE: one
reference-layout state dict through JAX ``convert_wan_vae38`` and the
port's loader), and ``run_condition`` for TI2V-5B and for Wan2.2, with the
noise handed across."""
import types

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from fantasy_world_tpu.convert.wan_vae import convert_wan_vae38
from fantasy_world_tpu.models.wan import clip as jclip
from fantasy_world_tpu.models.wan import t5 as jt5
from fantasy_world_tpu.models.wan import vae as jvae
from fantasy_world_tpu.models.wan import vae38 as jv38
from fantasy_world_tpu.models.wan.dit import WanDiTConfig as JDiTCfg
from fantasy_world_tpu.pipelines import units as ju
from fantasy_world_tpu.pipelines.wan_video import FantasyWorldPipeline as JPipe

from fantasy_world_tpu_torch.convert.checkpoint import _strip, load_into
from fantasy_world_tpu_torch.convert.from_jax import (clip_state_dict,
                                                      encoder_config_from,
                                                      t5_state_dict,
                                                      vae_state_dict)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.wan.clip import (CLIPVision,
                                                     CLIPVisionConfig)
from fantasy_world_tpu_torch.models.wan.dit import WanDiTConfig
from fantasy_world_tpu_torch.models.wan.t5 import T5Config, T5Encoder
from fantasy_world_tpu_torch.models.wan.vae import (RMSGamma, VAEConfig,
                                                    WanVAE)
from fantasy_world_tpu_torch.models.wan.vae38 import VAE38Config, WanVAE38
from fantasy_world_tpu_torch.pipelines import units as tu
from fantasy_world_tpu_torch.pipelines.wan_video import (DiTConfig,
                                                         FantasyWorldPipeline)
from test_cli_e2e import _write_tiny_tokenizer

torch.set_num_threads(1)

# f32 on both sides: summation order only, relative to the largest
# magnitude of each output
RTOL = 1e-4
H, W, FRAMES = 32, 48, 9
PROMPT, NEG = "a scenic mountain valley", "a river"
J_T5 = jt5.T5Config(vocab=64, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
                    num_layers=2)
J_CLIP = jclip.CLIPVisionConfig(dim=64, num_heads=4, num_layers=3)
J_VAE = jvae.VAEConfig(dim=16, z_dim=16)
J_VAE38 = jv38.VAE38Config(dim=16, dec_dim=16, z_dim=48)
# the DiT flags the units read: Wan2.1 (CLIP and y), Wan2.2 Fun-Control-
# Camera (y, no CLIP) and TI2V-5B (the fused first frame)
DIT_FLAGS = {
    "wan21": dict(text_dim=32, in_dim=36, has_image_input=True),
    "wan22": dict(text_dim=32, in_dim=36, has_image_input=False),
    "ti2v": dict(text_dim=32, in_dim=48, out_dim=48, has_image_input=False,
                 require_vae_embedding=False, seperated_timestep=True,
                 fuse_vae_embedding_in_latents=True)}


def _cpu(ctor):
    return build(ctor, device="cpu", dtype=torch.float32)


def _rel_max(got, want):
    a, b = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """JAX and port pipes on the same weights, one pair per DiT kind (the
    TI2V pair holds the 38-block VAE, the others the 2.1 VAE)."""
    tok = _write_tiny_tokenizer(str(tmp_path_factory.mktemp("tok")))
    trees = {"t5": jt5.init_t5(2, J_T5, jnp.float32),
             "clip": jclip.init_clip_vision(4, J_CLIP, jnp.float32),
             "vae": jvae.init_wan_vae(3, J_VAE, jnp.float32)}
    t5 = _cpu(lambda: T5Encoder(encoder_config_from(T5Config, J_T5)))
    t5.load_state_dict(t5_state_dict(trees["t5"], t5), strict=True)
    clip = _cpu(lambda: CLIPVision(encoder_config_from(CLIPVisionConfig,
                                                       J_CLIP)))
    clip.load_state_dict(clip_state_dict(trees["clip"], clip), strict=True)
    vae = _cpu(lambda: WanVAE(encoder_config_from(VAEConfig, J_VAE)))
    vae.load_state_dict(vae_state_dict(trees["vae"], vae), strict=True)
    cfg38 = encoder_config_from(VAE38Config, J_VAE38)
    src = build(lambda: WanVAE38(cfg38), device="cpu", dtype=torch.float32,
                generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for m in src.modules():
            if isinstance(m, RMSGamma):
                m.gamma.fill_(1.0)
    sd = {"model." + k: v.clone() for k, v in src.state_dict().items()}
    tree38 = convert_wan_vae38({k: v.numpy() for k, v in sd.items()},
                               J_VAE38)
    vae38 = load_into(_cpu(lambda: WanVAE38(cfg38)), _strip(sd, ("model.",)),
                      "vae38")
    pipes = {}
    for kind, flags in DIT_FLAGS.items():
        ti2v = kind == "ti2v"
        jparams = {"t5": trees["t5"], "vae": tree38 if ti2v else trees["vae"]}
        pipe = FantasyWorldPipeline(t5=t5, vae=vae38 if ti2v else vae,
                                    tokenizer_path=tok)
        if kind == "wan21":
            jparams["clip"] = trees["clip"]
            pipe.clip = clip
        pipe.cfg = DiTConfig(WanDiTConfig(**flags))
        jpipe = JPipe(cfg=types.SimpleNamespace(dit=JDiTCfg(**flags)),
                      params=jparams, t5_cfg=J_T5, clip_cfg=J_CLIP,
                      vae_cfg=J_VAE38 if ti2v else J_VAE, tokenizer_path=tok)
        pipes[kind] = (jpipe, pipe)
    return pipes


def _image(seed, h=H, w=W):
    return np.random.default_rng(seed).uniform(-1, 1, (h, w, 3)).astype(
        np.float32)


def _video(seed, frames=FRAMES):
    return np.random.default_rng(seed).uniform(
        -1, 1, (1, 3, frames, H, W)).astype(np.float32)


def _noise(z, sd, seed=9):
    return np.random.default_rng(seed).standard_normal(
        (1, z, (FRAMES - 1) // 4 + 1, H // sd, W // sd)).astype(np.float32)


class _StubPipe:
    """Prompts embedded as their length, to watch the runner."""

    def __init__(self):
        self.calls = []

    def encode_prompt(self, prompt):
        self.calls.append(prompt)
        return torch.full((1, 2, 4), float(len(prompt)))


def test_runner_semantics():
    """seperate_cfg: each side from its own key, the negative side skipped
    and aliased to the positive outputs at cfg_scale 1; shared units read
    and update the shared dict; take_over units get all three."""
    runner, pipe = tu.PipelineUnitRunner(), _StubPipe()
    shared, posi, nega = runner(tu.PromptEmbedder(), pipe,
                                {"cfg_scale": 5.0}, {"prompt": "a cat"},
                                {"negative_prompt": "blurry"})
    assert pipe.calls == ["a cat", "blurry"]
    assert float(posi["context"][0, 0, 0]) == 5.0
    assert float(nega["context"][0, 0, 0]) == 6.0
    pipe.calls.clear()
    shared, posi, nega = runner(tu.PromptEmbedder(), pipe, {"cfg_scale": 1},
                                {"prompt": "a cat"},
                                {"negative_prompt": "blurry"})
    assert pipe.calls == ["a cat"] and nega["context"] is posi["context"]
    shared, _, _ = runner(tu.ShapeChecker(), pipe,
                          {"height": 479, "width": 833, "num_frames": 80,
                           "cfg_scale": 5.0}, {}, {})
    assert (shared["height"], shared["width"], shared["num_frames"]) == (
        480, 848, 81)
    shared, _, _ = runner(tu.CfgMerger(), pipe, shared, posi, nega)
    assert tuple(shared["context_merged"].shape) == (2, 2, 4)


def _shared(kind, unit):
    """The inputs of ``unit`` for the pipe kind."""
    sd = 16 if kind == "ti2v" else 8
    base = {"height": H, "width": W, "num_frames": FRAMES, "cfg_scale": 5.0,
            "seed": 3, "tiled": False}
    z = 48 if kind == "ti2v" else 16
    return dict(base, **{
        "noise": {},
        "input_video": {"input_video": _video(1), "noise": _noise(z, sd),
                        "denoising_strength": 0.7,
                        "num_inference_steps": 10},
        "clip": {"input_image": _image(2), "end_image": _image(3)},
        "vae_encode": {"input_image": _image(2), "end_image": _image(3),
                       "mid_images_list": [_image(4)],
                       "mid_images_id_list": [5]},
        "vae_encode_fused": {"input_image": _image(2),
                             "latents": _noise(z, sd)},
        "fun_control": {"control_video": _video(6), "clip_feature": None,
                        "y": None, "noise": _noise(z, sd)},
        "fun_reference": {"reference_image": _image(7)},
        "camera_control": {"plucker_embedding": np.random.default_rng(
            8).standard_normal((1, FRAMES, H, W, 6)).astype(np.float32)},
        "speed_control": {"motion_bucket_id": 31},
        "shape_check": {"height": 479, "width": 833, "num_frames": 80},
    }.get(unit.name, {}))


def _as_j(v):
    return jnp.asarray(v) if isinstance(v, np.ndarray) else v




UNIT_CASES = [("shape_check", "wan21"), ("noise", "ti2v"), ("t5", "wan21"),
              ("input_video", "wan21"), ("clip", "wan21"),
              ("vae_encode", "wan22"), ("vae_encode_fused", "ti2v"),
              ("fun_control", "wan21"), ("fun_reference", "wan21"),
              ("camera_control", "wan22"), ("speed_control", "wan21"),
              ("cfg_merge", "wan21")]


@pytest.mark.parametrize("name,kind", UNIT_CASES)
def test_unit_matches_jax(env, name, kind):
    """Each unit of DEFAULT_UNITS (by name) against its JAX counterpart:
    every output key, the noise by shape (the port draws from a torch
    generator)."""
    jpipe, pipe = env[kind]
    unit = next(u for u in tu.DEFAULT_UNITS if u.name == name)
    junit = next(u for u in ju.DEFAULT_UNITS
                 if type(u).__name__ == type(unit).__name__)
    inputs = _shared(kind, unit)
    jshared = {k: _as_j(v) for k, v in inputs.items()}
    # the port takes images and videos as arrays, latents as tensors
    tshared = {k: torch.from_numpy(v) if k in ("noise", "latents") else v
               for k, v in inputs.items()}
    sides = [({"prompt": PROMPT}, {"negative_prompt": NEG}) for _ in (0, 1)]
    if name == "cfg_merge":
        ctx = np.random.default_rng(0).standard_normal((1, 4, 8)).astype(
            np.float32)
        sides = [({"context": f(ctx)}, {"context": f(ctx * 2)})
                 for f in (jnp.asarray, torch.from_numpy)]
    given = [dict(d) for d in (jshared, *sides[0])], \
        [dict(d) for d in (tshared, *sides[1])]
    jout = ju.PipelineUnitRunner()(junit, jpipe, jshared, *sides[0])
    tout = tu.PipelineUnitRunner()(unit, pipe, tshared, *sides[1])
    changed = 0
    for jd, td, jg, tg in zip(jout, tout, *given):
        keys = {k for k in jd if k not in jg or jd[k] is not jg[k]}
        assert keys == {k for k in td if k not in tg or td[k] is not tg[k]}
        for k in keys:
            want, got = jd[k], td[k]
            changed += 1
            if isinstance(want, (int, float, bool, str)):
                assert got == want, (name, k)
                continue
            got = got.numpy() if torch.is_tensor(got) else got
            if k == "noise":
                assert got.shape == np.shape(want)
                np.testing.assert_array_equal(
                    got, pipe.generate_noise(got.shape, seed=3).numpy())
            else:
                assert _rel_max(got, want) <= RTOL, (name, k)
    assert changed


@pytest.mark.parametrize("cfg_scale", [5.0, 1.0])
def test_run_condition_ti2v_matches_jax(env, monkeypatch, cfg_scale):
    """TI2V-5B: the 16x noise grid, frame 0 replaced by the 38-block VAE's
    latent of the image, both contexts, the merged context."""
    jpipe, pipe = env["ti2v"]
    noise = _noise(48, 16)
    monkeypatch.setattr(jpipe, "generate_noise",
                        lambda shape, seed=None: jnp.asarray(noise))
    monkeypatch.setattr(pipe, "generate_noise",
                        lambda shape, seed=None: torch.from_numpy(noise))
    kw = dict(input_image=_image(2), height=H, width=W, num_frames=FRAMES,
              seed=3, cfg_scale=cfg_scale)
    want = ju.run_condition(jpipe, PROMPT, NEG, **kw)
    stages = []
    got = tu.run_condition(pipe, PROMPT, NEG, stage_callback=stages.append,
                           **kw)
    assert stages == [u.name for u in tu.DEFAULT_UNITS]
    shared = got[0]
    assert shared["fuse_vae_embedding_in_latents"] is True
    assert tuple(shared["latents"].shape) == (1, 48, 3, 2, 3)
    np.testing.assert_array_equal(shared["latents"][:, :, 1:].numpy(),
                                  noise[:, :, 1:])
    for key in ("latents", "first_frame_latents", "context_merged"):
        assert _rel_max(shared[key].numpy(), want[0][key]) <= RTOL, key
    for side in (1, 2):
        assert _rel_max(got[side]["context"].numpy(),
                        want[side]["context"]) <= RTOL
    if cfg_scale == 1.0:
        assert got[2]["context"] is got[1]["context"]


def test_run_condition_wan22_matches_jax(env, monkeypatch):
    """Wan2.2 Fun-Control-Camera: y with the end image (untiled, and over
    a tile grid wider than the latents), the contexts, the latents."""
    jpipe, pipe = env["wan22"]
    noise = _noise(16, 8)
    monkeypatch.setattr(jpipe, "generate_noise",
                        lambda shape, seed=None: jnp.asarray(noise))
    monkeypatch.setattr(pipe, "generate_noise",
                        lambda shape, seed=None: torch.from_numpy(noise))
    kw = dict(input_image=_image(2), end_image=_image(3), height=H, width=W,
              num_frames=FRAMES, seed=3)
    want = ju.run_condition(jpipe, PROMPT, NEG, **kw)
    for tiled in (False, True):
        got = tu.run_condition(pipe, PROMPT, NEG, tiled=tiled, **kw)
        assert tuple(got[0]["y"].shape) == (1, 20, 3, H // 8, W // 8)
        assert "first_frame_latents" not in got[0]
        for key in ("y", "latents", "context_merged"):
            assert _rel_max(got[0][key].numpy(), want[0][key]) <= RTOL, key
        for side in (1, 2):
            assert _rel_max(got[side]["context"].numpy(),
                            want[side]["context"]) <= RTOL
