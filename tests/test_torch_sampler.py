"""The port's whole clip against the JAX package, in f32 on the CPU: the
sampler (prompt, image, camera, denoise, decode) against the JAX pipeline's
stages on the same weights; per-row seeds; the loader of the reference
checkpoint layout against JAX's ``load_fusion_params`` on the same files
(a pose encoder of widths other than 128 among them); the safetensors
reader; and the inference CLI end to end on ``--device cpu`` in a fresh
interpreter that never imports JAX, with its exits."""
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
import jax.numpy as jnp

from fantasy_world_tpu.cli.infer_wan21 import load_fusion_params
from fantasy_world_tpu.convert.camera import convert_pose_encoder
from fantasy_world_tpu.hostops.camera import (
    cameras_json_to_camera_list as j_cameras)
from fantasy_world_tpu.hostops.export import (
    get_pointclouds as j_pointclouds,
    save_colored_pointcloud_ply as j_save_ply)
from fantasy_world_tpu.models.fusion import bicross as jbi
from fantasy_world_tpu.models.fusion.model import FusionConfig as JFusionCfg
from fantasy_world_tpu.models.fusion.model import init_fusion
from fantasy_world_tpu.models.vggt.aggregator import AggregatorConfig
from fantasy_world_tpu.models.vggt.model import VGGTConfig
from fantasy_world_tpu.models.wan import camera as jcam
from fantasy_world_tpu.models.wan import clip as jclip
from fantasy_world_tpu.models.wan import t5 as jt5
from fantasy_world_tpu.models.wan import vae as jvae
from fantasy_world_tpu.models.wan.dit import WanDiTConfig
from fantasy_world_tpu.pipelines.wan_video import FantasyWorldPipeline as JPipe
from fantasy_world_tpu.sampler import FantasyWorldSampler as JSampler

from fantasy_world_tpu_torch.convert import checkpoint as ckpt
from fantasy_world_tpu_torch.convert.from_jax import (
    clip_state_dict, encoder_config_from, fusion_config_from,
    fusion_state_dict, pose_config_from, pose_encoder_state_dict,
    t5_state_dict, vae_state_dict)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.hostops.camera import cameras_json_to_camera_list
from fantasy_world_tpu_torch.models.fusion.model import FusionModel
from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
from fantasy_world_tpu_torch.models.wan.clip import (CLIPVision,
                                                     CLIPVisionConfig)
from fantasy_world_tpu_torch.models.wan.t5 import T5Config, T5Encoder
from fantasy_world_tpu_torch.models.wan.vae import VAEConfig, WanVAE
from fantasy_world_tpu_torch.pipelines.wan_video import FantasyWorldPipeline
from fantasy_world_tpu_torch.sampler import FantasyWorldSampler
from test_cli_e2e import _tiny_camera_json, _write_tiny_tokenizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on both sides through umT5, CLIP, the VAE encode, 2 denoise steps
# with the heads and the decode: summation order, relative to the largest
# magnitude of each prediction
RTOL = 1e-3
H, W, FRAMES, STEPS, SEED = 64, 96, 5, 2, 3
PROMPT = "a scenic mountain valley with a river"
NEG = "a river"
# every head dim differs: DiT 4x16, VGGT 4x8, bicross 4x12, camera trunk
# 4x16; the first two DiT blocks carry camera adapters
J_CFG = JFusionCfg(
    dit=WanDiTConfig(dim=64, ffn_dim=128, num_heads=4, num_layers=3,
                     text_dim=32, clip_feature_dim=64, plucker_dim=48,
                     camera_adapter_end=2),
    vggt=VGGTConfig(embed_dim=32, wan_dim=64, dpt_layer_idx=(1, 1, 0, 0),
                    dpt_features=16, dpt_out_channels=(8, 16, 32, 32),
                    camera_num_heads=4,
                    aggregator=AggregatorConfig(embed_dim=32, depth=2,
                                                num_heads=4)),
    bicross=jbi.BicrossConfig(m1_dim=64, m2_dim=32, hidden=48, num_heads=4),
    start_index=1)
J_T5 = jt5.T5Config(vocab=64, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
                    num_layers=2)
J_CLIP = jclip.CLIPVisionConfig(dim=64, num_heads=4, num_layers=2)
J_VAE = jvae.VAEConfig(dim=16, z_dim=16)
J_POSE = jcam.CameraPoseEncoderConfig(in_channels=6, dim=64, context_dim=48)
POSE_HIDDEN = (96, 64, 80)


def _wake(params, rng):
    """Random values for the zero-initialised gates, and RMS scales near 1
    in the VAE, so that every branch contributes."""
    f = params["fusion"]
    for b in f["bicross"]:
        for k in ("gamma_m1", "gamma_m2"):
            b[k] = rng.standard_normal(b[k].shape).astype(np.float32) * 0.5
    for blk in f["dit"]["blocks"]:
        if "camera" in blk:
            fc2 = blk["camera"]["v_group2"]["fc2"]
            fc2["kernel"] = rng.standard_normal(
                fc2["kernel"].shape).astype(np.float32) * 0.05
    ch = f["vggt"]["camera_head"]["camera_time_upsample"]
    ch["kernel"] = rng.standard_normal(ch["kernel"].shape).astype(
        np.float32) * 0.05

    def gammas(tree):
        if isinstance(tree, dict):
            return {k: (1 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32) if k == "gamma" else gammas(v)
                for k, v in tree.items()}
        return [gammas(v) for v in tree] if isinstance(tree, list) else tree
    params["vae"] = gammas(params["vae"])
    return params


def _port_modules(trees):
    """The port's modules holding the JAX trees (f32, CPU)."""
    def make(module, sd_fn, tree):
        module.load_state_dict(sd_fn(tree, module), strict=True)
        return module

    def cpu(ctor):
        return build(ctor, device="cpu", dtype=torch.float32)
    f = trees["fusion"]
    return {
        "fusion": make(cpu(lambda: FusionModel(fusion_config_from(J_CFG))),
                       fusion_state_dict, f),
        "pose": make(cpu(lambda: CameraPoseEncoder(pose_config_from(
            J_POSE, f["camera_pose_encoder"]))), pose_encoder_state_dict,
            f["camera_pose_encoder"]),
        "t5": make(cpu(lambda: T5Encoder(encoder_config_from(T5Config,
                                                             J_T5))),
                   t5_state_dict, trees["t5"]),
        "clip": make(cpu(lambda: CLIPVision(encoder_config_from(
            CLIPVisionConfig, J_CLIP))), clip_state_dict, trees["clip"]),
        "vae": make(cpu(lambda: WanVAE(encoder_config_from(VAEConfig,
                                                           J_VAE))),
                    vae_state_dict, trees["vae"])}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_env(tmp_path_factory.mktemp("clip"))


def make_env(root):
    """The JAX trees, the port's modules holding them, a tokenizer, a
    camera path and an image under ``root``."""
    rng = np.random.default_rng(0)
    # the pose encoder has no JAX init: the JAX converter reads the port's
    # random state dict, at widths other than the default 128
    src_cfg = dataclasses.replace(pose_config_from(J_POSE),
                                  hidden=POSE_HIDDEN)
    pose_src = build(lambda: CameraPoseEncoder(src_cfg), device="cpu",
                     dtype=torch.float32,
                     generator=torch.Generator().manual_seed(1))
    fusion = init_fusion(0, J_CFG, jnp.float32)
    fusion["camera_pose_encoder"] = convert_pose_encoder(
        {"pe." + k: v.numpy() for k, v in pose_src.state_dict().items()},
        "pe.")
    trees = _wake({"fusion": fusion,
                   "t5": jt5.init_t5(2, J_T5, jnp.float32),
                   "clip": jclip.init_clip_vision(1, J_CLIP, jnp.float32),
                   "vae": jvae.init_wan_vae(3, J_VAE, jnp.float32)}, rng)
    from PIL import Image
    image = rng.integers(0, 255, (H, W, 3), np.uint8)
    Image.fromarray(image).save(root / "input.png")
    return {"root": root, "trees": trees, "modules": _port_modules(trees),
            "tok": _write_tiny_tokenizer(str(root / "tok")),
            "cams": _tiny_camera_json(str(root / "cameras.json"), n=FRAMES),
            "image": image / 255.0, "image_path": str(root / "input.png")}


def _torch_sampler(env, modules):
    return FantasyWorldSampler(FantasyWorldPipeline(
        modules["fusion"], modules["pose"], t5=modules["t5"],
        clip=modules["clip"], vae=modules["vae"], tokenizer_path=env["tok"]))


def _jax_clip(env, trees, prompt=PROMPT, neg=NEG, using_scale=True):
    """The JAX pipeline's stages as its sampler runs them, with the
    torch-seeded noise."""
    jpipe = JPipe(cfg=J_CFG, params=trees, t5_cfg=J_T5, clip_cfg=J_CLIP,
                  vae_cfg=J_VAE, pose_cfg=J_POSE, tokenizer_path=env["tok"])
    with open(env["cams"]) as fh:
        cams = j_cameras(json.load(fh), image_size=(H, W))
    from PIL import Image
    img = np.asarray(Image.fromarray((env["image"] * 255).astype(np.uint8))
                     .resize((W, H))) / 255.0
    img = (img * 2 - 1).astype(np.float32)
    plucker = JSampler.prepare_camera(None, cams, env["image"], H, W,
                                      using_scale)
    emb = jpipe.encode_image(img, FRAMES, H, W)
    lat, pred = jpipe.denoise(
        jpipe.encode_prompt(prompt), jpipe.encode_prompt(neg),
        emb["clip_feature"], emb["y"], H, W, num_frames=FRAMES,
        num_inference_steps=STEPS, seed=SEED,
        plucker_fea=jpipe.encode_plucker(plucker), torch_compat_noise=True)
    return jpipe.decode_video(lat), {k: np.asarray(v, np.float32)
                                     for k, v in pred.items()}


def _assert_clip_close(got, want):
    (gv, gp), (wv, wp) = got, want
    assert gv.shape == wv.shape == (FRAMES, H, W, 3) and gv.dtype == np.uint8
    assert np.abs(gv.astype(int) - wv.astype(int)).max() <= 1
    assert set(gp) == set(wp) == {"pose_enc", "depth", "depth_conf",
                                  "world_points", "world_points_conf"}
    for k in wp:
        a, b = wp[k].astype(np.float64), gp[k].astype(np.float64)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)
        assert err <= RTOL, (k, err)


def test_whole_clip_matches_jax(env):
    sampler = _torch_sampler(env, env["modules"])
    with open(env["cams"]) as fh:
        cams = cameras_json_to_camera_list(json.load(fh), image_size=(H, W))
    stages = []
    got = sampler.generate_video(PROMPT, NEG, image=env["image"],
                                 camera_params=cams, using_scale=True,
                                 seed=SEED, height=H, width=W,
                                 num_frames=FRAMES, sample_steps=STEPS,
                                 stage_callback=stages.append)
    assert stages == ["camera", "clip", "vae_encode", "t5_pos", "t5_neg",
                      "vae_decode"]
    _assert_clip_close(got, _jax_clip(env, env["trees"]))


def test_encode_image_matches_jax(env):
    """CLIP's tokens and y = [first-frame mask | VAE latent of the masked
    video] of one image."""
    jpipe = JPipe(cfg=J_CFG, params={k: env["trees"][k] for k in
                                     ("clip", "vae")},
                  clip_cfg=J_CLIP, vae_cfg=J_VAE)
    img = (env["image"] * 2 - 1).astype(np.float32)
    want = jpipe.encode_image(img, FRAMES, H, W)
    m = env["modules"]
    got = FantasyWorldPipeline(clip=m["clip"], vae=m["vae"]).encode_image(
        img, FRAMES, H, W)
    mask = np.zeros((4, 2, H // 8, W // 8), np.float32)
    mask[:, 0] = 1
    np.testing.assert_array_equal(got["y"][0, :4].numpy(), mask)
    for k in ("clip_feature", "y"):
        a = np.asarray(want[k], np.float64)
        b = got[k].numpy().astype(np.float64)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), k


def test_per_row_seeds(env):
    """Row i of a batched sweep is the single-clip run with seed i: the
    noise exactly, the clip to f32 summation order."""
    rows = FantasyWorldPipeline.generate_noise((2, 16, 2, 8, 12), [5, 9])
    for i, s in enumerate((5, 9)):
        assert torch.equal(rows[i:i + 1], FantasyWorldPipeline.generate_noise(
            (1, 16, 2, 8, 12), s))
    with pytest.raises(ValueError, match="seeds"):
        FantasyWorldPipeline.generate_noise((2, 4), [1, 2, 3])
    sampler = _torch_sampler(env, env["modules"])
    with open(env["cams"]) as fh:
        cams = cameras_json_to_camera_list(json.load(fh), image_size=(H, W))
    kw = dict(height=H, width=W, num_frames=FRAMES, sample_steps=1,
              using_scale=False)
    both = sampler.generate_videos(
        [PROMPT, "a valley"], images=[env["image"], env["image"][::-1]],
        camera_params=[cams, cams], neg_prompt=NEG, seeds=[5, 9], **kw)
    for (video, pred), prompt, image, seed in zip(
            both, [PROMPT, "a valley"], [env["image"], env["image"][::-1]],
            (5, 9)):
        one = sampler.generate_video(prompt, NEG, image=image,
                                     camera_params=cams, seed=seed, **kw)
        assert np.abs(video.astype(int) - one[0].astype(int)).max() <= 1
        for k, v in one[1].items():
            err = np.abs(pred[k] - v).max() / max(np.abs(v).max(), 1e-12)
            assert err <= 1e-4, (seed, k, err)


# ---------------------------------------------------------------------------
# the reference layout on disk
# ---------------------------------------------------------------------------

def _write_reference_layout(root, modules, rng):
    """The port's state dicts as the reference files: base DiT shards (the
    IRG blocks and the head holding stale values that the fusion file
    overrides), the fusion .pth (pipe.dit adapters and head, the IRG
    blocks, vggt, the pose encoder), and the VAE, CLIP and umT5 .pth."""
    from safetensors.torch import save_file
    si = J_CFG.start_index
    wan = root / "wan"
    wan.mkdir()

    def stale(t):
        return torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
            np.float32))
    base, fusion = {}, {}
    for k, v in modules["fusion"].state_dict().items():
        m = re.match(r"dit\.blocks\.(\d+)\.(.*)", k)
        irg = re.match(r"(vggt\.aggregator\.global_blocks|bicross)\.(\d+)\."
                       r"(.*)", k)
        if m and int(m.group(1)) >= si:
            fusion[f"IRGBlock.{int(m.group(1)) - si}.x_dit.{m.group(2)}"] = v
            if ".processor." not in k:
                base[k[4:]] = stale(v)
        elif k.startswith("dit.") and ".processor." in k:
            fusion["pipe." + k] = v
        elif k.startswith("dit."):
            base[k[4:]] = v
        elif irg:
            part = "x_agg" if irg.group(1).startswith("vggt") else \
                "bicross_attention"
            fusion[f"IRGBlock.{irg.group(2)}.{part}.{irg.group(3)}"] = v
        else:
            fusion[k] = v
    fusion["pipe.dit.head.head.weight"] = base["head.head.weight"]
    base["head.head.weight"] = stale(base["head.head.weight"])
    for k, v in modules["pose"].state_dict().items():
        fusion["camera_condition.pose_encoder." + k] = v
    names = sorted(base)
    half = len(names) // 2
    for i, part in enumerate((names[:half], names[half:])):
        save_file({k: base[k].contiguous() for k in part},
                  str(wan / f"diffusion_pytorch_model-0000{i + 1}-of-00002"
                             ".safetensors"))
    torch.save(fusion, root / "model.pth")
    torch.save(modules["vae"].state_dict(), wan / ckpt.VAE_FILE)
    clip = {"model.visual." + k: v
            for k, v in modules["clip"].state_dict().items()}
    clip["model.textual.head.weight"] = torch.zeros(3)
    torch.save(clip, wan / ckpt.CLIP_FILE)
    torch.save(modules["t5"].state_dict(), wan / ckpt.T5_FILE)
    cfg = {"fusion": fusion_config_from(J_CFG),
           "t5": encoder_config_from(T5Config, J_T5),
           "clip": encoder_config_from(CLIPVisionConfig, J_CLIP),
           "vae": encoder_config_from(VAEConfig, J_VAE)}
    with open(wan / ckpt.CONFIGS_FILE, "w") as fh:
        json.dump({k: dataclasses.asdict(v) for k, v in cfg.items()}, fh)
    return str(wan), str(root / "model.pth")


@pytest.fixture(scope="module")
def layout(env):
    wan, model = _write_reference_layout(env["root"], env["modules"],
                                         np.random.default_rng(7))
    trees = load_fusion_params(wan, model, J_CFG, jnp.float32)
    return {"wan": wan, "model": model, "trees": trees,
            "pipe": ckpt.load_pipeline(wan, model, device="cpu",
                                       dtype=torch.float32)}


def test_loader_matches_jax(layout):
    """Every tensor the port's loader gives equals what JAX's
    ``load_fusion_params`` gives on the same files, carried across; the
    pose encoder has its checkpoint's widths and computes what the JAX
    one does."""
    pipe, trees = layout["pipe"], layout["trees"]
    f = trees["fusion"]
    for name, module, want in (
            ("fusion", pipe.fusion, fusion_state_dict(f, pipe.fusion)),
            ("pose", pipe.pose_encoder,
             pose_encoder_state_dict(f["camera_pose_encoder"],
                                     pipe.pose_encoder)),
            ("t5", pipe.t5, t5_state_dict(trees["t5"], pipe.t5)),
            ("clip", pipe.clip, clip_state_dict(trees["clip"], pipe.clip)),
            ("vae", pipe.vae, vae_state_dict(trees["vae"], pipe.vae))):
        got = module.state_dict()
        assert set(got) == set(want), name
        bad = [k for k in got if not torch.equal(got[k], want[k])]
        assert not bad, (name, bad[:5])
    assert pipe.pose_encoder.cfg.hidden == POSE_HIDDEN
    plucker = np.random.default_rng(4).standard_normal(
        (1, FRAMES, H, W, 6)).astype(np.float32)
    want = jcam.camera_pose_encoder_apply(f["camera_pose_encoder"], J_POSE,
                                          jnp.asarray(plucker))
    with torch.no_grad():
        got = pipe.pose_encoder(torch.from_numpy(plucker))
    want = np.asarray(want, np.float64)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_loader_refuses_duplicate_shard_keys(tmp_path):
    from safetensors.torch import save_file
    for i in range(2):
        save_file({"blocks.0.norm3.weight": torch.ones(4)},
                  str(tmp_path / f"diffusion_pytorch_model-{i}.safetensors"))
    with pytest.raises(ValueError, match="duplicate keys"):
        ckpt.read_shards(ckpt.dit_shards(str(tmp_path)))


def test_safetensors_reader_reads_what_safetensors_wrote(tmp_path):
    from safetensors.torch import save_file
    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn((3, 5), generator=g),
        "bf16": torch.randn((4, 2, 3), generator=g).bfloat16(),
        "f16": torch.randn((7,), generator=g).half(),
        "i64": torch.arange(6).reshape(2, 3),
        "u8": torch.arange(5, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 4))}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = ckpt.read_safetensors(path)
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k], t), k


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli_argv(env, layout, out_dir, *extra):
    return ["--wan_ckpt_path", layout["wan"], "--model_ckpt",
            layout["model"], "--image_path", env["image_path"],
            "--camera_json_path", env["cams"], "--prompt", PROMPT,
            "--neg_prompt", NEG, "--output_dir", str(out_dir),
            "--sample_steps", str(STEPS), "--frames", str(FRAMES),
            "--height", str(H), "--width", str(W), "--seed", str(SEED),
            "--tokenizer_path", env["tok"], "--conf_threshold", "0.0",
            "--stride", "2", *extra]


def test_cli_end_to_end_on_cpu(env, layout, tmp_path):
    """``python -m fantasy_world_tpu_torch.cli.infer_wan21 --device cpu`` in
    a fresh interpreter (which never imports JAX) on the files: the video
    (its .npy where imageio cannot write an MP4) and the PLY; the
    prediction and the frames against the JAX pipeline on the same files;
    the PLY byte for byte against JAX's writer on the same arrays."""
    out = tmp_path / "out"
    code = (
        "import sys, numpy as np\n"
        "from fantasy_world_tpu_torch.cli.infer_wan21 import main\n"
        "r = main(sys.argv[1:])\n"
        f"np.savez({str(out / 'result.npz')!r}, video=r['frames'], "
        "**r['prediction'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'fantasy_world_tpu')]\n"
        "assert not bad, bad\n"
        "print('ply', r['ply'])\n")
    env_vars = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code, *_cli_argv(env, layout, out,
                                                "--device", "cpu")],
        cwd=REPO, env=env_vars, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "outputs written" in res.stdout
    assert "[warn] MoGe unavailable" in res.stdout
    names = os.listdir(out)
    assert any(n.startswith("video.mp4") for n in names), names
    ply = out / "recon_confthresh0.0.ply"
    assert ply.is_file()
    r = np.load(out / "result.npz")
    video = r["video"]
    pred = {k: r[k] for k in r.files if k != "video"}
    _assert_clip_close((video, pred), _jax_clip(env, layout["trees"]))
    ref = tmp_path / "jax.ply"
    j_save_ply(j_pointclouds(pred, fix_first_frame=True),
               video.astype(np.float32), ref, stride=2,
               valid_mask=pred["depth_conf"][0] >= 0.0)
    assert ply.read_bytes() == ref.read_bytes()


def _cli_exit(argv, monkeypatch, cuda=False):
    from fantasy_world_tpu_torch.cli import infer_wan21
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    with pytest.raises(SystemExit) as exc:
        infer_wan21.main(argv)
    return str(exc.value)


def test_cli_needs_a_card_or_device_cpu(env, layout, tmp_path, monkeypatch):
    msg = _cli_exit(_cli_argv(env, layout, tmp_path), monkeypatch)
    assert "--device cpu" in msg
    assert not os.path.exists(tmp_path / "video.mp4")


def test_cli_serving_flags(env, layout, tmp_path, capsys):
    """The CLI in process with --quant, TeaCache, segments and a partial-
    state file: the clip equals the sampler's unsegmented TeaCache run on
    the same files (the denoise against JAX's: test_torch_tea_cache.py),
    a progress line follows each segment, and the file is gone."""
    from fantasy_world_tpu_torch.cli import infer_wan21
    from test_torch_tea_cache import THRESH
    argv = _cli_argv(env, layout, tmp_path / "out", "--device", "cpu",
                     "--quant", "int8", "--tea_cache_l1_thresh", str(THRESH),
                     "--segment_size", "1", "--gen_ckpt_path",
                     str(tmp_path / "partial.npz"))
    argv[argv.index("--sample_steps") + 1] = "4"
    r = infer_wan21.main(argv)
    out = capsys.readouterr().out
    # min_dim 1024 leaves every linear of the tiny model in f32, as in JAX
    assert "[quant] int8: 0 linears" in out
    assert [f"[denoise] step {i}/4" for i in range(1, 5)] == re.findall(
        r"\[denoise\] step \d/4", out)
    assert not (tmp_path / "partial.npz").exists()
    from fantasy_world_tpu_torch.pipelines.tea_cache import (
        compute_skip_schedule)
    from fantasy_world_tpu_torch.sampler import read_image
    from fantasy_world_tpu_torch.schedulers.flow_match import (
        FlowMatchScheduler)
    sampler = FantasyWorldSampler.from_checkpoint(
        layout["wan"], layout["model"], device="cpu", dtype=torch.float32,
        tokenizer_path=env["tok"])
    assert compute_skip_schedule(
        sampler.pipe.fusion.dit,
        FlowMatchScheduler().set_timesteps(4).timesteps, THRESH).any()
    with open(env["cams"]) as fh:
        cams = cameras_json_to_camera_list(json.load(fh), image_size=(H, W))
    video, pred = sampler.generate_video(
        PROMPT, NEG, image=read_image(env["image_path"]), camera_params=cams,
        seed=SEED, height=H, width=W, num_frames=FRAMES, sample_steps=4,
        tea_cache_l1_thresh=THRESH)
    assert np.array_equal(r["frames"], video)
    assert all(np.array_equal(r["prediction"][k], v)
               for k, v in pred.items())


@pytest.mark.parametrize("extra,flag", [
    (("--moge_ckpt", "moge.pt"), "--moge_ckpt"),
    (("--mesh_seq", "2"), "--mesh_seq"),
    (("--ulysses", "true"), "--ulysses"),
    (("--profile_dir", "p"), "--profile_dir")])
def test_cli_refuses_unported_options(env, layout, tmp_path, monkeypatch,
                                      extra, flag):
    msg = _cli_exit(_cli_argv(env, layout, tmp_path, "--device", "cpu",
                              *extra), monkeypatch, cuda=True)
    assert msg.startswith(flag)
    if flag == "--moge_ckpt":
        assert "no MoGe checkpoint at moge.pt" in msg


def test_cli_names_missing_checkpoint_files(env, layout, tmp_path,
                                            monkeypatch):
    argv = _cli_argv(env, layout, tmp_path, "--device", "cpu",
                     "--auto_download", "true")
    argv[1] = str(tmp_path)                    # no checkpoint files there
    msg = _cli_exit(argv, monkeypatch, cuda=True)
    assert "nothing is downloaded" in msg
    for name in (ckpt.DIT_SHARDS, ckpt.VAE_FILE, ckpt.CLIP_FILE,
                 ckpt.T5_FILE):
        assert name in msg
