"""The port's Wan2.2-Fun-A14B-Control-Camera path against the JAX package,
in f32 on the CPU: the control adapter, the control-latent fold, the
forward with control tokens, the dual-expert denoise over the boundary
(with the JAX noise injected), the Reward-LoRA merge, y with the end
image, the loader of the Wan2.2 layout against JAX's ``load_expert``, and
``cli.infer_wan22`` with ``--moge_ckpt`` in a fresh interpreter that never
imports JAX, against the JAX stages on the same files."""
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax
import jax.numpy as jnp

from fantasy_world_tpu.cli.infer_wan22 import load_expert
from fantasy_world_tpu.convert.lora import (
    merge_lora_into_state_dict as j_merge_lora)
from fantasy_world_tpu.hostops.camera import (
    cameras_json_to_camera_list as j_cameras)
from fantasy_world_tpu.models.fusion import bicross as jbi
from fantasy_world_tpu.models.fusion.model import FusionConfig as JFusionCfg
from fantasy_world_tpu.models.fusion.model import (init_fusion,
                                                   joint_forward as j_joint,
                                                   prepare_scan_params)
from fantasy_world_tpu.models.moge import infer as jinfer
from fantasy_world_tpu.models.moge import model as jmoge
from fantasy_world_tpu.models.vggt.aggregator import AggregatorConfig
from fantasy_world_tpu.models.vggt.model import VGGTConfig
from fantasy_world_tpu.models.wan import t5 as jt5
from fantasy_world_tpu.models.wan import vae as jvae
from fantasy_world_tpu.models.wan.camera import simple_adapter_apply
from fantasy_world_tpu.models.wan.dit import (WanDiTConfig,
                                              control_adapter_tokens)
from fantasy_world_tpu.pipelines import wan_video_22 as jw22
from fantasy_world_tpu.pipelines.units import ImageEmbedderVAE, run_condition
from fantasy_world_tpu.pipelines.wan_video import FantasyWorldPipeline as JPipe
from fantasy_world_tpu.sampler import FantasyWorldSampler as JSampler

from fantasy_world_tpu_torch.convert import checkpoint as ckpt
from fantasy_world_tpu_torch.convert.from_jax import (
    encoder_config_from, fusion_config_from, fusion_state_dict,
    moge_state_dict, t5_state_dict, vae_state_dict)
from fantasy_world_tpu_torch.convert.lora import merge_lora_into_state_dict
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.fusion.model import FusionModel
from fantasy_world_tpu_torch.models.moge.model import MoGe
from fantasy_world_tpu_torch.models.wan.camera import SimpleAdapter
from fantasy_world_tpu_torch.models.wan.t5 import T5Config, T5Encoder
from fantasy_world_tpu_torch.models.wan.vae import VAEConfig, WanVAE
from fantasy_world_tpu_torch.pipelines import wan_video_22 as w22
from fantasy_world_tpu_torch.pipelines.wan_video import FantasyWorldPipeline
from test_cli_e2e import _tiny_camera_json, _write_tiny_tokenizer
from test_torch_moge import CFG as MOGE_CFG
from test_torch_moge import J_CFG as J_MOGE

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on both sides: summation order, relative to the largest magnitude
# of each output (the clip: through umT5, MoGe, the VAE, 3 denoise steps
# of two experts with the heads, the decode)
RTOL = 1e-3
MODULE_RTOL = 1e-4
# the Wan2.2 CLI has no frame flag: 81 frames, at a tiny geometry
H, W, FRAMES, STEPS, SEED = 32, 48, 81, 3, 5
PROMPT = "a scenic mountain valley with a river"
NEG = "a river"
# every head dim differs: DiT 4x16, VGGT 4x8, bicross 4x12
J_CFG = JFusionCfg(
    dit=WanDiTConfig(dim=64, ffn_dim=128, num_heads=4, num_layers=3,
                     text_dim=32, has_image_input=False,
                     require_vae_embedding=True, add_control_adapter=True,
                     in_dim_control_adapter=24, camera_adapter_end=0),
    vggt=VGGTConfig(embed_dim=32, wan_dim=64, dpt_layer_idx=(1, 1, 0, 0),
                    dpt_features=16, dpt_out_channels=(8, 16, 32, 32),
                    camera_num_heads=4,
                    aggregator=AggregatorConfig(embed_dim=32, depth=2,
                                                num_heads=4)),
    bicross=jbi.BicrossConfig(m1_dim=64, m2_dim=32, hidden=48, num_heads=4),
    start_index=1, camera_control=True)
J_T5 = jt5.T5Config(vocab=64, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
                    num_layers=2)
J_VAE = jvae.VAEConfig(dim=16, z_dim=16)


def _wake(fusion, rng):
    """Random values for the zero-initialised gates so they contribute."""
    for b in fusion["bicross"]:
        for k in ("gamma_m1", "gamma_m2"):
            b[k] = rng.standard_normal(b[k].shape).astype(np.float32) * 0.5
    ch = fusion["vggt"]["camera_head"]["camera_time_upsample"]
    ch["kernel"] = rng.standard_normal(ch["kernel"].shape).astype(
        np.float32) * 0.05
    return fusion


def _cpu(ctor):
    return build(ctor, device="cpu", dtype=torch.float32)


def _fusion_module(tree):
    m = _cpu(lambda: FusionModel(fusion_config_from(J_CFG)))
    m.load_state_dict(fusion_state_dict(tree, m), strict=True)
    return m


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("wan22")
    rng = np.random.default_rng(0)
    trees = {"high": _wake(init_fusion(0, J_CFG, jnp.float32), rng),
             "low": _wake(init_fusion(1, J_CFG, jnp.float32), rng),
             "t5": jt5.init_t5(2, J_T5, jnp.float32),
             "vae": jvae.init_wan_vae(3, J_VAE, jnp.float32),
             "moge": jmoge.init_moge(4, J_MOGE, jnp.float32)}
    t5 = _cpu(lambda: T5Encoder(encoder_config_from(T5Config, J_T5)))
    t5.load_state_dict(t5_state_dict(trees["t5"], t5), strict=True)
    vae = _cpu(lambda: WanVAE(encoder_config_from(VAEConfig, J_VAE)))
    vae.load_state_dict(vae_state_dict(trees["vae"], vae), strict=True)
    moge = _cpu(lambda: MoGe(MOGE_CFG))
    moge.load_state_dict(moge_state_dict(trees["moge"], moge), strict=True)
    from PIL import Image
    image = rng.integers(0, 255, (64, 96, 3), np.uint8)
    Image.fromarray(image).save(root / "input.png")
    end = rng.integers(0, 255, (64, 96, 3), np.uint8)
    Image.fromarray(end).save(root / "end.png")
    return {"root": root, "trees": trees,
            "modules": {"high": _fusion_module(trees["high"]),
                        "low": _fusion_module(trees["low"]), "t5": t5,
                        "vae": vae, "moge": moge},
            "tok": _write_tiny_tokenizer(str(root / "tok")),
            "cams": _tiny_camera_json(str(root / "cameras.json"), n=FRAMES),
            "image": image / 255.0, "end": end / 255.0,
            "image_path": str(root / "input.png"),
            "end_path": str(root / "end.png")}


def _rel_max(got, want):
    a, b = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_simple_adapter_matches_jax(env):
    ca = env["trees"]["high"]["dit"]["control_adapter"]
    x = np.random.default_rng(1).standard_normal((1, 24, 3, 32, 48)).astype(
        np.float32)
    want = simple_adapter_apply(ca, jnp.asarray(x))
    got = env["modules"]["high"].dit.control_adapter
    assert isinstance(got, SimpleAdapter)
    with torch.no_grad():
        got = got(torch.from_numpy(x))
    assert tuple(got.shape) == (1, 64, 3, 2, 3)
    assert _rel_max(got.numpy(), want) <= MODULE_RTOL


def test_control_camera_latents_exact():
    plucker = np.random.default_rng(2).standard_normal(
        (1, 9, 8, 10, 6)).astype(np.float32)
    got = w22.control_camera_latents_from_plucker(plucker)
    want = jw22.control_camera_latents_from_plucker(plucker)
    assert got.shape == (1, 24, 3, 8, 10)
    np.testing.assert_array_equal(got, want)


def _inputs(rng, f=3):
    return {"lat": rng.standard_normal((2, 16, f, H // 8, W // 8)),
            "ctx": rng.standard_normal((2, 12, 32)),
            "y": rng.standard_normal((2, 20, f, H // 8, W // 8)),
            "ctrl": rng.standard_normal((1, 24, f, H, W))}


def test_joint_forward_with_control_tokens_matches_jax(env):
    """The CFG pair with the control tokens of one row, hoisted once as
    the pipelines do (the heads: ``test_dual_denoise_matches_jax``)."""
    tree = env["trees"]["high"]
    x = {k: v.astype(np.float32) for k, v in
         _inputs(np.random.default_rng(3)).items()}
    t = np.array([900.0, 900.0], np.float32)
    ctok = control_adapter_tokens(tree["dit"], J_CFG.dit,
                                  jnp.asarray(np.repeat(x["ctrl"], 2, 0)))
    want, _ = j_joint(tree, prepare_scan_params(tree, J_CFG), J_CFG,
                      jnp.asarray(x["lat"]), jnp.asarray(t),
                      jnp.asarray(x["ctx"]), None, jnp.asarray(x["y"]),
                      control_tokens=ctok)
    m = env["modules"]["high"]
    with torch.no_grad():
        tok = m.dit.control_adapter_tokens(torch.from_numpy(x["ctrl"]))
        assert tok.shape[0] == 1
        got, _ = m.joint_forward(
            torch.from_numpy(x["lat"]), torch.from_numpy(t),
            torch.from_numpy(x["ctx"]), None, torch.from_numpy(x["y"]),
            control_tokens=tok)
    assert _rel_max(got.numpy(), want) <= MODULE_RTOL


def _dual(env):
    m = env["modules"]
    return w22.DualModelDenoiser(m["high"], m["low"])


@pytest.mark.parametrize("boundary,n_high", [(900.0, 2), (0.0, 3)])
def test_dual_denoise_matches_jax(env, monkeypatch, boundary, n_high):
    """3 steps (t ~ 1000, 909, 715): the high expert while t > boundary,
    the low one after, the heads on the last step's expert; the JAX
    PRNG's noise handed to the port."""
    rng = np.random.default_rng(4)
    ctx_p, ctx_n = (rng.standard_normal((1, 512, 32)).astype(np.float32)
                    for _ in range(2))
    y = rng.standard_normal((1, 20, 21, H // 8, W // 8)).astype(np.float32)
    ctrl = rng.standard_normal((1, 24, 21, H, W)).astype(np.float32)
    kw = dict(num_frames=FRAMES, num_inference_steps=STEPS, seed=SEED,
              control_camera_latents=ctrl)
    t = env["trees"]
    jden = jw22.DualModelDenoiser(cfg=J_CFG, params_high=t["high"],
                                  params_low=t["low"],
                                  timestep_boundary=boundary)
    want, wpred = jden.denoise(jnp.asarray(ctx_p), jnp.asarray(ctx_n),
                               jnp.asarray(y), H, W, **kw)
    jnoise = np.asarray(jax.random.normal(jax.random.PRNGKey(SEED),
                                          (1, 16, 21, H // 8, W // 8),
                                          jnp.float32))
    monkeypatch.setattr(w22.DualModelDenoiser, "generate_noise",
                        staticmethod(lambda shape, seed: torch.tensor(
                            jnoise).reshape(shape)))
    den = _dual(env)
    den.timestep_boundary = boundary
    used, stages = [], []
    for high, model in den.experts.items():
        fwd = model.joint_forward

        def record(*a, _high=high, _fwd=fwd, **k):
            used.append((_high, k["return_prediction"]))
            return _fwd(*a, **k)
        monkeypatch.setattr(model, "joint_forward", record)
    got, gpred = den.denoise(torch.from_numpy(ctx_p), torch.from_numpy(ctx_n),
                             torch.from_numpy(y), H, W,
                             stage_callback=stages.append, **kw)
    assert used == [(i < n_high, i == STEPS - 1) for i in range(STEPS)]
    assert stages == ["control_adapter_high"] + (
        ["control_adapter_low"] if n_high < STEPS else [])
    assert _rel_max(got.numpy(), want) <= RTOL
    assert set(gpred) == set(wpred)
    for k in wpred:
        assert _rel_max(gpred[k].numpy(), wpred[k]) <= RTOL, k


def test_lora_merge_matches_jax():
    """kohya and peft keys, alpha and none, a 1x1 conv, a prefix-less key
    matched by its unique suffix, and unmatched layers."""
    rng = np.random.default_rng(5)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)
    sd = {"blocks.0.self_attn.q.weight": r(8, 6),
          "blocks.0.cross_attn.q.weight": r(8, 6),
          "blocks.1.ffn.0.weight": r(12, 8),
          "control_adapter.conv.weight": r(8, 6, 1, 1),
          "head.head.weight": r(4, 8), "blocks.0.norm3.bias": r(8)}
    lora = {
        "lora_unet_blocks_0_self_attn_q.lora_up.weight": r(8, 2),
        "lora_unet_blocks_0_self_attn_q.lora_down.weight": r(2, 6),
        "lora_unet_blocks_0_self_attn_q.alpha": np.float32(4.0),
        "blocks.1.ffn.0.lora_A.default.weight": r(3, 8),
        "blocks.1.ffn.0.lora_B.default.weight": r(12, 3),
        "lora_unet_control_adapter_conv.lora_up.weight": r(8, 2, 1, 1),
        "lora_unet_control_adapter_conv.lora_down.weight": r(2, 6, 1, 1),
        "lora_unet_head_head.lora_up.weight": r(4, 1),
        "lora_unet_head_head.lora_down.weight": r(1, 8),
        "lora_unet_attn_q.lora_up.weight": r(8, 2),      # ambiguous
        "lora_unet_attn_q.lora_down.weight": r(2, 6),
        "lora_unet_blocks_9_ffn_2.lora_up.weight": r(8, 2),   # no target
        "lora_unet_blocks_9_ffn_2.lora_down.weight": r(2, 12),
        "lora_unet_blocks_0_norm3.dora_scale": r(8)}
    want = j_merge_lora(sd, lora, multiplier=0.55)
    got = merge_lora_into_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()},
        {k: torch.from_numpy(np.asarray(v)) for k, v in lora.items()},
        multiplier=0.55)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    changed = {k for k in sd if not np.array_equal(want[k], sd[k])}
    assert changed == {"blocks.0.self_attn.q.weight", "blocks.1.ffn.0.weight",
                       "control_adapter.conv.weight", "head.head.weight"}


def test_end_image_y_matches_jax(env):
    """y with the end image: the last frame in the mask and in the video
    the VAE encodes; tiled over a grid wider than the image, one tile."""
    img = (env["image"][:H, :W] * 2 - 1).astype(np.float32)
    end = (env["end"][:H, :W] * 2 - 1).astype(np.float32)
    jpipe = JPipe(cfg=J_CFG, params={"vae": env["trees"]["vae"]},
                  vae_cfg=J_VAE)
    want = ImageEmbedderVAE().process(jpipe, img, end, FRAMES, H, W)["y"]
    pipe = FantasyWorldPipeline(vae=env["modules"]["vae"])
    for tiled in (False, True):
        got = pipe.encode_y(img, FRAMES, H, W, end_image=end, tiled=tiled)
        assert tuple(got.shape) == (1, 20, 21, H // 8, W // 8)
        mask = got[0, :4, :, 0, 0].numpy()       # (4 frames, latent frame)
        assert mask[:, 0].all() and mask[3, -1] == 1
        assert mask.sum() == 5
        assert _rel_max(got.numpy(), want) <= MODULE_RTOL


# ---------------------------------------------------------------------------
# the Wan2.2 layout on disk, the clip and the CLI
# ---------------------------------------------------------------------------

def _lora_files(names, rng, peft):
    """A rank-2 LoRA on each named base weight, kohya or peft keys, with
    one layer the merge cannot match."""
    out = {}
    for k, shape in names.items():
        layer = k[:-len(".weight")]
        up = rng.standard_normal((shape[0], 2)).astype(np.float32) * 0.1
        down = rng.standard_normal((2, shape[1])).astype(np.float32) * 0.1
        if peft:
            out[layer + ".lora_A.default.weight"] = down
            out[layer + ".lora_B.default.weight"] = up
        else:
            mangled = "lora_unet_" + layer.replace(".", "_")
            out[mangled + ".lora_up.weight"] = up
            out[mangled + ".lora_down.weight"] = down
            out[mangled + ".alpha"] = np.float32(4.0)
    out["lora_unet_no_such_layer.lora_up.weight"] = np.ones((2, 2),
                                                            np.float32)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


def _write_wan22_layout(root, modules, rng):
    """The port's state dicts as the Wan2.2 files: each expert's base DiT
    shards (its IRG blocks and head holding stale values the fusion file
    overrides), its Reward-LoRA over block 0's and an IRG block's linears,
    its fusion .pth; the shared VAE and umT5 .pth; configs.json."""
    from safetensors.torch import save_file
    si = J_CFG.start_index
    wan = root / "wan22"
    paths = {}
    for high, name in ((True, "high"), (False, "low")):
        base, fusion = {}, {}
        for k, v in modules[name].state_dict().items():
            m = re.match(r"dit\.blocks\.(\d+)\.(.*)", k)
            irg = re.match(r"(vggt\.aggregator\.global_blocks|bicross)\."
                           r"(\d+)\.(.*)", k)
            if m and int(m.group(1)) >= si:
                fusion[f"IRGBlock.{int(m.group(1)) - si}.x_dit."
                       f"{m.group(2)}"] = v
                base[k[4:]] = torch.from_numpy(rng.standard_normal(
                    tuple(v.shape)).astype(np.float32))
            elif k.startswith("dit."):
                base[k[4:]] = v
            elif irg:
                part = ("x_agg" if irg.group(1).startswith("vggt")
                        else "bicross_attention")
                fusion[f"IRGBlock.{irg.group(2)}.{part}.{irg.group(3)}"] = v
            else:
                fusion[k] = v
        fusion["pipe.dit.head.head.weight"] = base["head.head.weight"]
        base["head.head.weight"] = torch.zeros_like(base["head.head.weight"])
        shard_dir = os.path.dirname(os.path.join(
            wan, ckpt.EXPERT_SHARDS[high]))
        os.makedirs(shard_dir, exist_ok=True)
        names = sorted(base)
        half = len(names) // 2
        for i, part in enumerate((names[:half], names[half:])):
            save_file({k: base[k].contiguous() for k in part},
                      os.path.join(shard_dir, f"diffusion_pytorch_model-"
                                              f"0000{i + 1}-of-00002"
                                              ".safetensors"))
        targets = {k: tuple(v.shape) for k, v in base.items()
                   if re.match(r"blocks\.[01]\.(self_attn|cross_attn)\."
                               r"[qkvo]\.weight|blocks\.0\.ffn\.[02]\.weight"
                               r"|control_adapter\.conv\.weight", k)
                   and v.ndim == 2}
        lora_path = os.path.join(wan, ckpt.EXPERT_LORAS[high])
        os.makedirs(os.path.dirname(lora_path), exist_ok=True)
        save_file(_lora_files(targets, rng, peft=not high), lora_path)
        paths[name] = str(root / f"model_{name}.pth")
        torch.save(fusion, paths[name])
    torch.save(modules["vae"].state_dict(), wan / ckpt.VAE_FILE)
    torch.save(modules["t5"].state_dict(), wan / ckpt.T5_FILE)
    cfg = {"fusion": fusion_config_from(J_CFG),
           "t5": encoder_config_from(T5Config, J_T5),
           "vae": encoder_config_from(VAEConfig, J_VAE)}
    with open(wan / ckpt.CONFIGS_FILE, "w") as fh:
        json.dump({k: dataclasses.asdict(v) for k, v in cfg.items()}, fh)
    moge = root / "moge.pt"
    torch.save({"model": modules["moge"].state_dict()}, moge)
    return str(wan), paths["high"], paths["low"], str(moge)


@pytest.fixture(scope="module")
def layout(env):
    wan, high, low, moge = _write_wan22_layout(
        env["root"], env["modules"], np.random.default_rng(7))
    trees = {name: load_expert(wan, ckpt.EXPERT_SHARDS[is_high],
                               os.path.join(wan, ckpt.EXPERT_LORAS[is_high]),
                               path, J_CFG, jnp.float32)
             for name, is_high, path in (("high", True, high),
                                         ("low", False, low))}
    return {"wan": wan, "high": high, "low": low, "moge": moge,
            "trees": trees}


def test_wan22_loader_matches_jax(layout):
    """Each expert the port loads equals, tensor for tensor, JAX's
    ``load_expert`` on the same files (the LoRA merged, the IRG blocks and
    the head overlaid, q/k permuted); the low expert trades places with
    the high one through the host."""
    pipe, den = ckpt.load_wan22(layout["wan"], layout["high"], layout["low"],
                                device="cpu", dtype=torch.float32)
    assert pipe.fusion is None and pipe.clip is None
    for high, name in ((True, "high"), (False, "low")):
        model = den.experts[high]
        want = fusion_state_dict(layout["trees"][name], model)
        got = model.state_dict()
        assert set(got) == set(want), name
        bad = [k for k in got if not torch.equal(got[k], want[k])]
        assert not bad, (name, bad[:5])
    # the LoRA moved block 0, which no fusion file overrides
    base = ckpt.read_shards(ckpt.dit_shards(layout["wan"],
                                            ckpt.EXPERT_SHARDS[True]))
    assert not torch.equal(
        den.experts[True].dit.blocks[0].ffn[0].weight,
        base["blocks.0.ffn.0.weight"])
    before = {h: [t.clone() for t in m.parameters()]
              for h, m in den.experts.items()}
    w22.swap_residency(den.experts[True], den.experts[False])
    for h, m in den.experts.items():
        assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                     before[h]))


def _jax_clip22(env, layout, monkeypatch, end=True):
    """The JAX stages as its Wan2.2 sampler runs them on the same files,
    MoGe installed as the default and the torch-generator noise drawn."""
    t = env["trees"]
    jpipe = JPipe(cfg=J_CFG, params={"t5": t["t5"], "vae": t["vae"]},
                  t5_cfg=J_T5, vae_cfg=J_VAE, tokenizer_path=env["tok"])
    monkeypatch.setitem(jinfer._DEFAULT, "params", t["moge"])
    monkeypatch.setitem(jinfer._DEFAULT, "cfg", J_MOGE)
    with open(env["cams"]) as fh:
        cams = j_cameras(json.load(fh), image_size=(H, W))
    from PIL import Image

    def pm1(x):
        return (np.asarray(Image.fromarray((x * 255).astype(np.uint8))
                           .resize((W, H))) / 255.0 * 2 - 1).astype(
            np.float32)
    ctrl = jw22.control_camera_latents_from_plucker(JSampler.prepare_camera(
        None, cams, env["image"], H, W, True))
    shared, posi, nega = run_condition(
        jpipe, prompt=PROMPT, negative_prompt=NEG,
        input_image=pm1(env["image"]),
        end_image=pm1(env["end"]) if end else None, height=H, width=W,
        num_frames=FRAMES, seed=SEED)

    def torch_noise(key, shape, dtype=jnp.float32):
        g = torch.Generator("cpu").manual_seed(SEED)
        return jnp.asarray(torch.randn(shape, generator=g).numpy())
    monkeypatch.setattr(jax.random, "normal", torch_noise)
    den = jw22.DualModelDenoiser(cfg=J_CFG,
                                 params_high=layout["trees"]["high"],
                                 params_low=layout["trees"]["low"])
    lat, pred = den.denoise(posi["context"], nega["context"], shared["y"],
                            H, W, num_frames=FRAMES,
                            num_inference_steps=STEPS, seed=SEED,
                            control_camera_latents=ctrl)
    monkeypatch.undo()
    return jpipe.decode_video(lat), {k: np.asarray(v, np.float32)
                                     for k, v in pred.items()}


def _cli_argv(env, layout, out_dir, *extra):
    return ["--wan_ckpt_path", layout["wan"], "--model_ckpt_high",
            layout["high"], "--model_ckpt_low", layout["low"],
            "--image_path", env["image_path"], "--end_image_path",
            env["end_path"], "--camera_json_path", env["cams"],
            "--prompt", PROMPT, "--neg_prompt", NEG, "--output_dir",
            str(out_dir), "--sample_steps", str(STEPS), "--height", str(H),
            "--width", str(W), "--seed", str(SEED), "--tokenizer_path",
            env["tok"], "--conf_threshold", "0.0", "--stride", "2", *extra]


def test_cli_wan22_end_to_end_on_cpu(env, layout, tmp_path, monkeypatch):
    """``python -m fantasy_world_tpu_torch.cli.infer_wan22 --device cpu
    --moge_ckpt ...`` in a fresh interpreter (which never imports JAX) on
    the files: the video (its .npy where imageio cannot write an MP4) and
    the PLY; the frames and the prediction against the JAX stages."""
    out = tmp_path / "out"
    code = (
        "import sys, numpy as np\n"
        "from fantasy_world_tpu_torch.cli.infer_wan22 import main\n"
        "r = main(sys.argv[1:])\n"
        f"np.savez({str(out / 'result.npz')!r}, video=r['frames'], "
        "**r['prediction'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'fantasy_world_tpu')]\n"
        "assert not bad, bad\n")
    env_vars = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code, *_cli_argv(
            env, layout, out, "--device", "cpu", "--moge_ckpt",
            layout["moge"])],
        cwd=REPO, env=env_vars, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "outputs written" in res.stdout
    assert "MoGe unavailable" not in res.stdout
    assert "[lora] merged" in res.stdout
    names = os.listdir(out)
    assert any(n.startswith("video.mp4") for n in names), names
    assert (out / "recon_confthresh0.0.ply").is_file()
    r = np.load(out / "result.npz")
    video = r["video"]
    pred = {k: r[k] for k in r.files if k != "video"}
    wv, wp = _jax_clip22(env, layout, monkeypatch)
    assert video.shape == wv.shape == (FRAMES, H, W, 3)
    assert np.abs(video.astype(int) - wv.astype(int)).max() <= 1
    assert set(pred) == set(wp) == {"pose_enc", "depth", "depth_conf",
                                    "world_points", "world_points_conf"}
    for k in wp:
        assert _rel_max(pred[k], wp[k]) <= RTOL, k


def test_cli_wan22_serving_flags(env, layout, tmp_path, monkeypatch,
                                 capsys):
    """The CLI in process with --quant, TeaCache, segments and a partial-
    state file: the clip equals the sampler's unsegmented TeaCache run on
    the same files (the denoise against JAX's: test_torch_tea_cache.py), a
    progress line follows each segment, and the file is gone."""
    from fantasy_world_tpu_torch.cli import infer_wan22
    from test_torch_tea_cache import THRESH
    r = infer_wan22.main(_cli_argv(
        env, layout, tmp_path / "out", "--device", "cpu", "--moge_ckpt",
        layout["moge"], "--quant", "int8", "--tea_cache_l1_thresh",
        str(THRESH), "--segment_size", "1", "--gen_ckpt_path",
        str(tmp_path / "partial.npz")))
    out = capsys.readouterr().out
    assert [f"[denoise] step {i}/{STEPS}" for i in range(1, STEPS + 1)] == \
        re.findall(r"\[denoise\] step \d/\d", out)
    assert not (tmp_path / "partial.npz").exists()
    from fantasy_world_tpu_torch.hostops.camera import (
        cameras_json_to_camera_list)
    from fantasy_world_tpu_torch.sampler import Wan22Sampler, read_image
    sampler = Wan22Sampler.from_checkpoint(
        layout["wan"], layout["high"], layout["low"], device="cpu",
        dtype=torch.float32, tokenizer_path=env["tok"],
        moge_ckpt=layout["moge"])
    with open(env["cams"]) as fh:
        cams = cameras_json_to_camera_list(json.load(fh), image_size=(H, W))
    video, pred = sampler.generate_video(
        PROMPT, NEG, image=read_image(env["image_path"]),
        end_image=read_image(env["end_path"]), camera_params=cams,
        seed=SEED, height=H, width=W, sample_steps=STEPS,
        tea_cache_l1_thresh=THRESH)
    assert np.array_equal(r["frames"], video)
    assert all(np.array_equal(r["prediction"][k], v)
               for k, v in pred.items())


def _cli_exit(argv, monkeypatch, cuda=False):
    from fantasy_world_tpu_torch.cli import infer_wan22
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    with pytest.raises(SystemExit) as exc:
        infer_wan22.main(argv)
    return str(exc.value)


@pytest.mark.parametrize("extra,flag", [
    ((), "--device cpu"),
    (("--device", "cpu", "--moge_ckpt", "nowhere.pt"), "--moge_ckpt"),
    (("--device", "cpu", "--mesh_model", "2"), "--mesh_model"),
    (("--device", "cpu", "--ulysses", "true"), "--ulysses"),
    (("--device", "cpu", "--mesh_seq", "2"), "--mesh_seq")])
def test_cli_wan22_exits(env, layout, tmp_path, monkeypatch, extra, flag):
    """Not-ported options and a missing MoGe checkpoint exit naming the
    flag; without a card and without --device cpu it exits too."""
    msg = _cli_exit(_cli_argv(env, layout, tmp_path, *extra), monkeypatch,
                    cuda=flag != "--device cpu")
    assert flag in msg
    assert not os.path.exists(tmp_path / "video.mp4")


def test_cli_wan22_names_missing_files(env, layout, tmp_path, monkeypatch):
    argv = _cli_argv(env, layout, tmp_path, "--device", "cpu")
    argv[1] = str(tmp_path)                    # no checkpoint files there
    msg = _cli_exit(argv, monkeypatch, cuda=True)
    assert "nothing is downloaded" in msg
    for name in (*ckpt.EXPERT_SHARDS.values(), *ckpt.EXPERT_LORAS.values(),
                 ckpt.VAE_FILE, ckpt.T5_FILE):
        assert name in msg
