"""The seeded inputs the card check's phases share: the reduced
configurations, the woken zero-initialised gates, the random conditioning,
the example image and camera path, the tokenizer and the reference layouts
written to disk, the full-width encoders and the cut configurations of the
mesh phases, and the output checks of a denoise.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .common import REPO


def small_configs():
    """Reduced widths whose heads still take every kernel route: DiT 2x128
    (self over 2304 tokens -> generic, cross -> onekv), VGGT 2x64 (d64),
    bicross 2x96 (generic), camera trunk 2x128 (onekv)."""
    from fantasy_world_tpu_torch.models.fusion.bicross import BicrossConfig
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    from fantasy_world_tpu_torch.models.vggt.aggregator import (
        AggregatorConfig)
    from fantasy_world_tpu_torch.models.vggt.model import VGGTConfig
    from fantasy_world_tpu_torch.models.wan.camera import (
        CameraPoseEncoderConfig)
    from fantasy_world_tpu_torch.models.wan.dit import WanDiTConfig
    fusion = FusionConfig(
        dit=WanDiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=3,
                         text_dim=64, clip_feature_dim=64, plucker_dim=64,
                         camera_adapter_end=3),
        vggt=VGGTConfig(embed_dim=128, wan_dim=256, dpt_layer_idx=(1, 1, 0, 0),
                        dpt_features=32, dpt_out_channels=(16, 32, 64, 64),
                        camera_num_heads=2,
                        aggregator=AggregatorConfig(embed_dim=128, depth=2,
                                                    num_heads=2)),
        bicross=BicrossConfig(m1_dim=256, m2_dim=128, hidden=192, num_heads=2),
        start_index=1)
    return fusion, CameraPoseEncoderConfig(dim=256, context_dim=64)


def wake_zero_inits(fusion, generator) -> None:
    """Give the zero-initialised gates (bicross gammas, camera-adapter
    output, camera-head time upsample) random values so every branch
    contributes."""
    import torch
    with torch.no_grad():
        for b in fusion.bicross:
            for gamma in (b.gamma_m1, b.gamma_m2):
                gamma.normal_(0.0, 0.5, generator=generator)
        for blk in fusion.dit.blocks:
            wake_pose_adapter(blk.cross_attn.processor, generator)
        up = fusion.vggt.camera_head.camera_time_upsample.expand_channels
        up.weight.normal_(0.0, 0.05, generator=generator)


def wake_pose_adapter(proc, generator, std=0.05) -> None:
    """Random values for a DiT block's zero-initialised pose adapter: the
    'adaln' output layer, or the latent methods' k/v projections."""
    import torch
    from fantasy_world_tpu_torch.models.wan.dit import LatentPoseAdapter
    if proc is None:
        return
    with torch.no_grad():
        if isinstance(proc, LatentPoseAdapter):
            for lin in (proc.k_proj, proc.v_proj):
                lin.weight.normal_(0.0, std, generator=generator)
        else:
            proc.v_proj.group2[2].weight.normal_(0.0, std,
                                                 generator=generator)


def conditioning(dit_cfg, height, width, num_frames, generator, text_len,
                 prompt_lens=(24, 8)):
    """Random encoder outputs, f32 on the host, in the shapes the encoders
    give: umT5 context zeroed past each prompt's length (positive,
    negative), CLIP tokens, y = [first-frame mask | latent]; and the
    Plucker video of the example camera path (numpy)."""
    import torch
    from fantasy_world_tpu_torch.hostops.camera import (load_camera_json,
                                                        plucker_from_cameras)
    f, lh, lw = (num_frames - 1) // 4 + 1, height // 8, width // 8

    def randn(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    ctx = []
    for n in prompt_lens:
        c = randn(1, text_len, dit_cfg.text_dim)
        c[:, n:] = 0
        ctx.append(c)
    clip = randn(1, 257, dit_cfg.clip_feature_dim)
    mask = torch.zeros((1, 4, f, lh, lw))
    mask[:, :, 0] = 1
    y = torch.cat([mask, randn(1, dit_cfg.in_dim - 4 - dit_cfg.out_dim, f,
                               lh, lw)], dim=1)
    cams = load_camera_json(os.path.join(REPO, "examples", "cameras",
                                         "camera_data.json"),
                            (height, width), num_frames)
    return ctx[0], ctx[1], clip, y, plucker_from_cameras(cams,
                                                         (height, width))


def expected_shapes(cfg, height, width, num_frames):
    f = (num_frames - 1) // 4 + 1
    T = 1 + 4 * (f - 1)
    return {"latents": (1, cfg.dit.out_dim, f, height // 8, width // 8),
            "pose_enc": (1, T, 9), "depth": (1, T, height, width, 1),
            "depth_conf": (1, T, height, width),
            "world_points": (1, T, height, width, 3),
            "world_points_conf": (1, T, height, width)}


def check_outputs(cfg, latents, prediction, height, width, num_frames):
    import torch
    want = expected_shapes(cfg, height, width, num_frames)
    got = dict(prediction, latents=latents)
    for key, shape in want.items():
        if key not in got or tuple(got[key].shape) != shape:
            seen = None if key not in got else tuple(got[key].shape)
            raise AssertionError(f"{key}: shape {seen} != {shape}")
        if not bool(torch.isfinite(got[key]).all()):
            raise AssertionError(f"{key} has non-finite values")
    return got


# the reduced slice: geometry (256x384, 21 frames: 6 latent frames of 16 x
# 24 tokens), denoise steps and its noise seed
SMALL_GEOMETRY = (256, 384, 21)
SMALL_STEPS, SMALL_SEED = 2, 3


def small_slice_setup():
    """The reduced slice's models on the CPU in f32 (from seed 5, the zero
    gates woken) and its conditioning: (fusion config, pose config, fusion,
    pose encoder, conditioning)."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
    fcfg, pcfg = small_configs()
    g = torch.Generator("cpu").manual_seed(5)
    cpu_f = build(lambda: FusionModel(fcfg), device="cpu",
                  dtype=torch.float32, generator=g)
    wake_zero_inits(cpu_f, g)
    cpu_p = build(lambda: CameraPoseEncoder(pcfg), device="cpu",
                  dtype=torch.float32, generator=g)
    cond = conditioning(fcfg.dit, *SMALL_GEOMETRY,
                        torch.Generator("cpu").manual_seed(6), 16)
    return fcfg, pcfg, cpu_f, cpu_p, cond


PROMPT = "a scenic mountain valley with a river at dawn"
NEG_PROMPT = "blurred details, static, overexposed"
EXAMPLE_IMAGE = os.path.join(REPO, "examples", "images", "input_image.png")


def small_clip_configs():
    """Reduced umT5, CLIP and VAE beside ``small_configs()``: umT5 4 x 16
    over the DiT's 64-wide context; CLIP 3 blocks of 2 heads of 80 (onekv,
    D padded to 128), whose 160-wide tokens the DiT takes; the VAE at width
    16. Returns the (fusion, pose, t5, clip, vae) configs."""
    import dataclasses
    from fantasy_world_tpu_torch.models.wan.clip import CLIPVisionConfig
    from fantasy_world_tpu_torch.models.wan.t5 import T5Config
    from fantasy_world_tpu_torch.models.wan.vae import VAEConfig
    fusion, pose = small_configs()
    t5 = T5Config(vocab=512, dim=fusion.dit.text_dim, dim_attn=64,
                  dim_ffn=128, num_heads=4, num_layers=2)
    clip = CLIPVisionConfig(dim=160, num_heads=2, num_layers=3)
    fusion = dataclasses.replace(fusion, dit=dataclasses.replace(
        fusion.dit, clip_feature_dim=clip.dim))
    return fusion, pose, t5, clip, VAEConfig(dim=16, z_dim=fusion.dit.out_dim)


def install_tokenizer(pipe, vocab: int, workdir: str) -> str:
    """A WordLevel tokenizer over the prompts' words, written to
    ``workdir`` in the HF layout, for the pipeline's own ``tokenize`` to
    load (AutoTokenizer from a local path). Returns its name for the phase
    line."""
    write_tokenizer(vocab, workdir)
    pipe.tokenizer_path = workdir
    return "transformers-wordlevel"


def write_tokenizer(vocab: int, workdir: str) -> None:
    """The files of ``install_tokenizer``'s tokenizer, in ``workdir``."""
    words = sorted(set(f"{PROMPT} {NEG_PROMPT}".lower().replace(
        ",", " ").split()))
    ids = {"[PAD]": 0, "[UNK]": 1, **{w: 2 + i for i, w in
                                       enumerate(words)}}
    if len(ids) > vocab:
        raise ValueError(f"{len(ids)} words for a vocabulary of {vocab}")
    special = {"single_word": False, "lstrip": False, "rstrip": False,
               "normalized": False, "special": True}
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "tokenizer.json"), "w") as fh:
        json.dump({"version": "1.0", "truncation": None, "padding": None,
                   "added_tokens": [{"id": 0, "content": "[PAD]", **special},
                                    {"id": 1, "content": "[UNK]", **special}],
                   "normalizer": {"type": "Lowercase"},
                   "pre_tokenizer": {"type": "Whitespace"},
                   "post_processor": None, "decoder": None,
                   "model": {"type": "WordLevel", "vocab": ids,
                             "unk_token": "[UNK]"}}, fh)
    with open(os.path.join(workdir, "tokenizer_config.json"), "w") as fh:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "pad_token": "[PAD]", "unk_token": "[UNK]",
                   "model_max_length": 512}, fh)


def clip_inputs(height, width, num_frames):
    """The clip's image, ``examples/images/input_image.png`` as (H, W, 3) in
    [0, 1] (read with Pillow), and the example camera path."""
    from fantasy_world_tpu_torch.hostops.camera import load_camera_json
    from fantasy_world_tpu_torch.sampler import read_image
    cams = load_camera_json(os.path.join(REPO, "examples", "cameras",
                                         "camera_data.json"),
                            (height, width), num_frames)
    return read_image(EXAMPLE_IMAGE), cams


def saved_as(path: str) -> str:
    return "mp4" if path.endswith(".mp4") else "npy"


def small_wan22_configs():
    """Reduced widths of the Wan2.2 path: the DiT, VGGT and bicross of
    ``small_configs()`` with the Wan2.2 options (no CLIP branch, the
    control adapter on 24 Plucker channels, no per-layer camera adapters),
    the umT5 and VAE of ``small_clip_configs()``, and a MoGe whose DINOv2
    has 2 heads of 64 (d64) in 4 blocks, over narrow conv stacks. Returns
    the (fusion, t5, vae, moge) configs."""
    import dataclasses
    from fantasy_world_tpu_torch.models.moge.model import (DINOv2Config,
                                                           MoGeConfig)
    fusion, _, t5, _, vae = small_clip_configs()
    fusion = dataclasses.replace(fusion, dit=dataclasses.replace(
        fusion.dit, has_image_input=False, add_control_adapter=True,
        in_dim_control_adapter=24, camera_adapter_end=0))
    moge = MoGeConfig(encoder=DINOv2Config(dim=128, depth=4, num_heads=2),
                      intermediate_layers=(0, 1, 2, 3), dim_proj_out=64,
                      dim_res_blocks=(64, 32, 16, 16, 8),
                      scale_head_dims=(128, 64, 64, 1))
    return fusion, t5, vae, moge


def train_batches(dit_cfg, height, width, num_frames, n, seed,
                  text_len=16):
    """``n`` seeded flow-matching batches (numpy, f32) at a latent
    geometry: clean latents, noise, a schedule sigma and timestep, umT5 and
    CLIP conditioning, y and Plucker features of the DiT's widths."""
    from fantasy_world_tpu_torch.schedulers.flow_match import (
        FlowMatchScheduler)
    f, lh, lw = (num_frames - 1) // 4 + 1, height // 8, width // 8
    tokens = f * (lh // 2) * (lw // 2)
    sched = FlowMatchScheduler().set_timesteps(1000)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        idx = int(rng.integers(0, len(sched.sigmas)))
        b = {"clean_latents": rng.standard_normal((1, 16, f, lh, lw)),
             "noise": rng.standard_normal((1, 16, f, lh, lw)),
             "sigma": float(sched.sigmas[idx]),
             "timestep": np.full((1,), float(sched.timesteps[idx])),
             "context": rng.standard_normal((1, text_len,
                                             dit_cfg.text_dim)) * 0.1,
             "clip_feature": rng.standard_normal(
                 (1, 257, dit_cfg.clip_feature_dim)) * 0.1,
             "y": rng.standard_normal((1, dit_cfg.in_dim - 16, f, lh, lw)),
             "plucker_fea": rng.standard_normal(
                 (1, tokens, dit_cfg.plucker_dim)) * 0.1}
        out.append({k: v if isinstance(v, float) else
                    np.asarray(v, np.float32) for k, v in b.items()})
    return out


# the registry entry (``convert/registry.py``) each full-width DiT must
# detect as
REGISTRY_ENTRY = {"wan21": "6bfcfb3b342cb286ce886889d519a77e",   # 14B I2V
                  "wan22": "47dbeab5e560db3180adf51dc0232fb1",   # Control-
                  "ti2v": "1f5ab7703c6fc803fdded85ff040c316"}    # Camera


def detected(sd, fusion_cfg=None):
    """(registry hash, detected name) of a DiT's reference-layout census:
    ``sd`` a standalone DiT's state dict, or with ``fusion_cfg`` a fusion
    model's, whose base DiT (``reference_state_dicts``) is taken. Only the
    shapes are read: the tensors are replaced by meta ones first."""
    import torch
    from fantasy_world_tpu_torch.convert import checkpoint as ckpt
    from fantasy_world_tpu_torch.convert import registry
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in sd.items()}
    if fusion_cfg is not None:
        meta, _ = ckpt.reference_state_dicts(meta, fusion_cfg)
    h = registry.hash_state_dict_keys(meta)
    try:
        return h, registry.detect(meta)[0]
    except KeyError:
        return h, None


def check_detected(what, sd, entry, fusion_cfg=None):
    h, name = detected(sd, fusion_cfg)
    if h != REGISTRY_ENTRY[entry] or name != "wan_video_dit":
        raise AssertionError(f"{what}: census hash {h} ({name}), want the "
                             f"{entry} entry {REGISTRY_ENTRY[entry]}")
    return h


def write_pan_clip(clip_dir, height, width, frames, prompt=PROMPT):
    """A clip directory as ``cli.train --data_root`` reads it:
    ``frames/{i}.png`` (``data/video.py:save_frames``), ``frames`` frames of
    (height, width) panning left to right across the example image (scaled
    by 1.25 with PIL, a window sliding over the extra quarter),
    ``prompt.txt``, and ``poses.txt``: the first ``frames`` cameras of the
    example camera path as RealEstate10K rows (a URL line, then ts,
    fx / W, fy / H, 0.5, 0.5, 0, 0 and the 3x4 w2c). Returns the
    directory."""
    from PIL import Image
    from fantasy_world_tpu_torch.data.video import save_frames
    img = Image.open(EXAMPLE_IMAGE).convert("RGB")
    big = np.asarray(img.resize((round(width * 1.25), round(height * 1.25)),
                                Image.BICUBIC))
    top, span = (big.shape[0] - height) // 2, big.shape[1] - width
    xs = [round(i * span / max(1, frames - 1)) for i in range(frames)]
    save_frames([big[top:top + height, x:x + width] for x in xs],
                os.path.join(clip_dir, "frames"))
    with open(os.path.join(clip_dir, "prompt.txt"), "w") as fh:
        fh.write(prompt + "\n")
    with open(os.path.join(REPO, "examples", "cameras",
                           "camera_data.json")) as fh:
        data = json.load(fh)
    focal = float(data.get("focal_length", 500))
    with open(os.path.join(clip_dir, "poses.txt"), "w") as fh:
        fh.write("https://www.youtube.com/watch?v=example\n")
        for i, c2w in enumerate(data["cameras_interp"][:frames]):
            w2c = np.linalg.inv(np.asarray(c2w, np.float64).reshape(4, 4))
            row = [i, focal / width, focal / height, 0.5, 0.5, 0.0, 0.0]
            fh.write(" ".join(repr(float(v)) for v in
                              row + w2c[:3].flatten().tolist()) + "\n")
    return clip_dir


def write_reference_layout(root, seed=21):
    """``small_clip_configs``' modules from a seed, on the host in f32, as
    the reference checkpoint layout that ``convert/checkpoint.py:
    load_pipeline`` reads (``reference_state_dicts``): the base DiT in a
    safetensors shard, the fusion ``.pth`` (the IRG blocks, ``vggt.*``,
    the pose encoder), the VAE, CLIP and umT5 ``.pth`` and a
    ``configs.json`` of the reduced configs. Returns (wan_ckpt_path,
    model_ckpt)."""
    import dataclasses
    import torch
    from fantasy_world_tpu_torch.convert import checkpoint as ckpt
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
    from fantasy_world_tpu_torch.models.wan.clip import CLIPVision
    from fantasy_world_tpu_torch.models.wan.t5 import T5Encoder
    from fantasy_world_tpu_torch.models.wan.vae import WanVAE
    fcfg, pcfg, t5c, clipc, vaec = small_clip_configs()
    g = torch.Generator("cpu").manual_seed(seed)

    def make(ctor, cfg):
        return build(lambda: ctor(cfg), device="cpu", dtype=torch.float32,
                     generator=g).state_dict()
    wan = os.path.join(root, "wan")
    os.makedirs(wan, exist_ok=True)
    base, fusion = ckpt.reference_state_dicts(make(FusionModel, fcfg), fcfg)
    for k, v in make(CameraPoseEncoder, pcfg).items():
        fusion[ckpt.POSE_PREFIX + k] = v
    ckpt.write_safetensors(os.path.join(
        wan, "diffusion_pytorch_model-00001-of-00001.safetensors"), base)
    model = os.path.join(root, "model.pth")
    torch.save(fusion, model)
    for ctor, cfg, name in ((WanVAE, vaec, ckpt.VAE_FILE),
                            (CLIPVision, clipc, ckpt.CLIP_FILE),
                            (T5Encoder, t5c, ckpt.T5_FILE)):
        torch.save(make(ctor, cfg), os.path.join(wan, name))
    with open(os.path.join(wan, ckpt.CONFIGS_FILE), "w") as fh:
        json.dump({k: dataclasses.asdict(c) for k, c in
                   (("fusion", fcfg), ("t5", t5c), ("clip", clipc),
                    ("vae", vaec))}, fh)
    return wan, model


def write_wan22_layout(root, seed=23):
    """``small_wan22_configs``' experts from a seed, on the host in f32, as
    the Wan2.2 layout that ``convert/checkpoint.py:load_wan22`` reads: each
    expert's base DiT in ``{high,low}_noise_model/`` shards, a rank-2
    Reward-LoRA (kohya names) over its block 0's linears, its fusion
    ``.pth``; the VAE and umT5 ``.pth``; a ``configs.json``. Returns
    (wan_ckpt_path, model_ckpt_high, model_ckpt_low)."""
    import dataclasses
    import torch
    from fantasy_world_tpu_torch.convert import checkpoint as ckpt
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.t5 import T5Encoder
    from fantasy_world_tpu_torch.models.wan.vae import WanVAE
    fcfg, t5c, vaec, _ = small_wan22_configs()
    g = torch.Generator("cpu").manual_seed(seed)

    def make(ctor, cfg):
        return build(lambda: ctor(cfg), device="cpu", dtype=torch.float32,
                     generator=g).state_dict()
    wan = os.path.join(root, "wan22")
    paths = []
    for high in (True, False):
        base, fusion = ckpt.reference_state_dicts(make(FusionModel, fcfg),
                                                  fcfg)
        shards = os.path.join(wan, ckpt.EXPERT_SHARDS[high])
        os.makedirs(os.path.dirname(shards), exist_ok=True)
        ckpt.write_safetensors(shards.replace(
            "*", "-00001-of-00001"), base)
        lora = {}
        for layer in ("self_attn.q", "cross_attn.o", "ffn.0"):
            w = base[f"blocks.0.{layer}.weight"]
            name = "lora_unet_blocks_0_" + layer.replace(".", "_")
            lora[name + ".lora_up.weight"] = torch.randn(
                w.shape[0], 2, generator=g) * 0.1
            lora[name + ".lora_down.weight"] = torch.randn(
                2, w.shape[1], generator=g) * 0.1
            lora[name + ".alpha"] = torch.tensor(4.0)
        lora_path = os.path.join(wan, ckpt.EXPERT_LORAS[high])
        os.makedirs(os.path.dirname(lora_path), exist_ok=True)
        ckpt.write_safetensors(lora_path, lora)
        paths.append(os.path.join(root, "model_high.pth" if high
                                  else "model_low.pth"))
        torch.save(fusion, paths[-1])
    torch.save(make(WanVAE, vaec), os.path.join(wan, ckpt.VAE_FILE))
    torch.save(make(T5Encoder, t5c), os.path.join(wan, ckpt.T5_FILE))
    with open(os.path.join(wan, ckpt.CONFIGS_FILE), "w") as fh:
        json.dump({k: dataclasses.asdict(c) for k, c in
                   (("fusion", fcfg), ("t5", t5c), ("vae", vaec))}, fh)
    return wan, paths[0], paths[1]


def small_track_configs():
    """The track head at reduced widths: the tracker keeps TrackConfig()'s
    8 heads of 48 (d64, zero-padded to 64) in 2 blocks over 4 pyramid
    levels of a 32-wide latent and 16 virtual tracks; the feature-only DPT
    reads 256-wide aggregated tokens. Returns (TrackConfig,
    DPTHeadConfig)."""
    from fantasy_world_tpu_torch.models.vggt.heads import DPTHeadConfig
    from fantasy_world_tpu_torch.models.vggt.track import TrackConfig
    tc = TrackConfig(latent_dim=32, hidden_size=384, corr_levels=4,
                     corr_radius=3, depth=2, num_virtual_tracks=16)
    dpt = DPTHeadConfig(dim_in=256, output_dim=0, features=tc.latent_dim,
                        out_channels=(16, 32, 64, 64),
                        intermediate_layer_idx=(1, 1, 0, 0), pos_embed=False,
                        down_ratio=2, feature_only=True)
    return tc, dpt


def track_inputs(dpt, frames, ph, pw, points, generator, device="cpu",
                 dtype=None):
    """Random aggregated tokens of ``frames`` latent frames on a (ph, pw)
    patch grid behind 5 camera/register tokens (one tensor per layer the
    DPT reads; the other layers of the list repeat the first), and
    ``points`` query points (1, N, 2) in full-resolution pixels."""
    import torch
    idx = dpt.intermediate_layer_idx
    taps = {i: torch.randn((1, frames, 5 + ph * pw, dpt.dim_in),
                           generator=generator, device=device, dtype=dtype)
            for i in sorted(set(idx))}
    toks = [taps.get(i, taps[idx[0]]) for i in range(max(idx) + 1)]
    size = torch.tensor([pw * dpt.patch_size - 1.0,
                         ph * dpt.patch_size - 1.0], device=device)
    q = torch.rand((1, points, 2), generator=generator, device=device) * size
    return toks, q


POSE_METHODS = ("latent_split", "latent_overall")


def pose_encodings(height, width, frames):
    """(1, frames, 9) pose encodings of the example camera path."""
    import torch
    from fantasy_world_tpu_torch.hostops.camera import (
        camera_matrices, extri_intri_to_pose_encoding, load_camera_json)
    extr, intr = camera_matrices(load_camera_json(
        os.path.join(REPO, "examples", "cameras", "camera_data.json"),
        (height, width), frames))
    return torch.from_numpy(extri_intri_to_pose_encoding(
        extr[:, :3, :], intr, (height, width)))[None]


# small_options: the reduced fusion model at 256x384, 21 frames (6 latent
# frames of 16 x 24 tokens, 16 x 24 + 5 geometry tokens a frame)
SMALL_OPTION_GEOMETRY = (256, 384, 21)
# temporal bicross at reduced widths: 6 geometry frames over 4 video frames
# (windows of 2 frames, two of them padded), T, S, R, M
SMALL_TEMPORAL = (4, 16 * 24, 6, 16 * 24 + 5)
# full_mesh's denoises at (1, 1, 2) and (1, 2, 1): full width, 4 PCB + 4
# IRG blocks (a Ulysses mesh replicates the weights on each rank, two of
# them on one card; the tensor split's fault would show in any block)
MESH_DEPTH = (8, 4)


def mesh_fusion_config(depth=None, base=None):
    """FusionConfig() (or ``base``) at full width; ``depth`` (layers, start
    index) cuts the DiT and the VGGT stack to that many blocks, the DPT
    taps scaled onto the cut stack."""
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    cfg = base or FusionConfig()
    if depth is None:
        return cfg
    import dataclasses
    layers, si = depth
    n_irg = layers - si
    # the DPT taps scaled onto the cut stack (23, 17, 11, 7 of 24 -> 3, 2,
    # 1, 1 of 4)
    last = len(range(cfg.num_irg)) - 1
    taps = tuple(round(i * (n_irg - 1) / last)
                 for i in cfg.vggt.dpt_layer_idx)
    vggt = dataclasses.replace(
        cfg.vggt, dpt_layer_idx=taps,
        aggregator=dataclasses.replace(cfg.vggt.aggregator, depth=n_irg))
    return dataclasses.replace(
        cfg, dit=dataclasses.replace(cfg.dit, num_layers=layers),
        vggt=vggt, start_index=si)


MESH_GEOMETRY = (336, 592, 81)
MESH_STEPS = 2


def stack_batches(batches):
    """Numpy batches of one sample (``train_batches``) as one batch, a
    sigma per sample, (B, 1, 1, 1, 1)."""
    out = {k: np.concatenate([b[k] for b in batches])
           for k in batches[0] if k != "sigma"}
    out["sigma"] = np.asarray([b["sigma"] for b in batches],
                              np.float32).reshape(-1, 1, 1, 1, 1)
    return out


PIPE_STAGES = PIPE_MICROBATCHES = 2
# small_mesh_serving at 128x192: 9 frames (3 latent frames of 8 x 12
# tokens, split 2 | 1 over 2 seq ranks) for all but the windows, which
# take 17 frames (5 latent frames) in windows of 3 every 2 -- (0, 3) and
# (2, 5), each split 2 | 1
SMALL_SERVING_GEOMETRY = (128, 192, 9)
SMALL_WINDOW_GEOMETRY = (128, 192, 17)
SMALL_WINDOW = (3, 2)
# full_mesh_serving: 4 PCB + 4 IRG blocks of the full width (the whole run
# must stay within the script's time limit; two ranks on one card run a
# step ~2.2x one process's, full_mesh)
MESH_SERVING_DEPTH = (8, 4)


def full_serving_configs():
    """full_mesh_serving's (Wan2.1 fusion config, pose encoder config,
    Wan2.2 expert config, Wan2.1 geometry, Wan2.2 geometry): the full
    widths cut to ``MESH_SERVING_DEPTH``."""
    from fantasy_world_tpu_torch.convert.checkpoint import wan22_fusion_config
    from fantasy_world_tpu_torch.models.wan.camera import (
        CameraPoseEncoderConfig)
    return (mesh_fusion_config(MESH_SERVING_DEPTH), CameraPoseEncoderConfig(),
            mesh_fusion_config(MESH_SERVING_DEPTH, wan22_fusion_config()),
            MESH_GEOMETRY, (480, 832, 81))


SERVE_PROMPTS = (PROMPT, "a river at dawn")
FULL_SERVING_CAMERAS = os.path.join(REPO, "examples", "cameras",
                                    "camera_data.json")


def full_encoders(device, g, clip=True):
    """umT5-XXL, CLIP ViT-H/14 (unless ``clip`` is False) and the Wan VAE
    ({"t5", "clip", "vae"}), and MoGe-2, built on ``device`` in bf16 from
    the generator ``g``."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.moge.model import MoGe, MoGeConfig
    from fantasy_world_tpu_torch.models.wan.clip import (CLIPVision,
                                                         CLIPVisionConfig)
    from fantasy_world_tpu_torch.models.wan.t5 import T5Config, T5Encoder
    from fantasy_world_tpu_torch.models.wan.vae import VAEConfig, WanVAE
    kw = dict(device=device, dtype=torch.bfloat16, generator=g)
    enc = {"t5": build(lambda: T5Encoder(T5Config()), **kw)}
    if clip:
        enc["clip"] = build(lambda: CLIPVision(CLIPVisionConfig()), **kw)
    enc["vae"] = build(lambda: WanVAE(VAEConfig()), **kw)
    return enc, build(lambda: MoGe(MoGeConfig()), **kw)


# the reduced serving runs quantize every linear at least this wide (the
# production default of 1024 would leave the reduced widths in bf16)
SMALL_QUANT_MIN_DIM = 128


def tea_threshold(dit, steps, device=None):
    """A TeaCache threshold whose plan over ``steps`` skips the second step
    and computes the third: 1.5x the 480P polynomial at the second step's
    drift (the random weights' drift is far from the real model's, so no
    fixed threshold would); returns (threshold, plan)."""
    from fantasy_world_tpu_torch.pipelines import tea_cache as tc
    from fantasy_world_tpu_torch.schedulers.flow_match import (
        FlowMatchScheduler)
    ts = FlowMatchScheduler().set_timesteps(steps).timesteps
    drift = tc.modulation_drift_schedule(tc.time_modulations(dit, ts,
                                                             device))
    poly = np.poly1d(tc.TEACACHE_COEFFICIENTS[tc.DEFAULT_MODEL_ID])
    thresh = 1.5 * float(poly(drift[1]))
    return thresh, tc.plan_skips(drift, thresh)


class Cut(Exception):
    """Raised from a progress callback to cut a run after a segment."""


def cut_after_first(done, total):
    raise Cut


def small_ti2v_configs():
    """Reduced TI2V-5B widths: the DiT 2 x 2 heads of 128 (self over 2304
    tokens at 512x768x21 -> generic, cross -> onekv), umT5 as in
    ``small_clip_configs``, the 38-block VAE at width 16 (z = 48). Returns
    the (dit, t5, vae) configs."""
    import dataclasses
    from fantasy_world_tpu_torch.models.wan.dit import TI2V_5B
    from fantasy_world_tpu_torch.models.wan.vae38 import VAE38Config
    _, _, t5, _, _ = small_clip_configs()
    dit = dataclasses.replace(TI2V_5B, dim=256, ffn_dim=512, num_heads=2,
                              num_layers=2, text_dim=t5.dim)
    return dit, t5, VAE38Config(dim=16, dec_dim=16)


def run_ti2v(pipe, image, height, width, frames, steps, seed, mark=None,
             tiled=False, before_denoise=None):
    """The TI2V-5B clip through the port's entry points: ``run_condition``
    (the 38-block VAE's latent of the image fused into latent frame 0),
    ``denoise_ti2v`` on the conditioning's noise, then ``decode_video``
    (``tiled``: over the reference grid). ``mark(name)`` after each unit,
    step and the decode; ``before_denoise(noise, positive context,
    first-frame latent)`` between the conditioning and the denoise.
    Returns (latents, first-frame latent, uint8 video)."""
    from fantasy_world_tpu_torch.pipelines.ti2v import denoise_ti2v
    from fantasy_world_tpu_torch.pipelines.units import run_condition
    stage = mark or (lambda name: None)
    shared, posi, nega = run_condition(
        pipe, PROMPT, NEG_PROMPT, input_image=image, height=height,
        width=width, num_frames=frames, seed=seed, stage_callback=stage)
    if before_denoise is not None:
        before_denoise(shared["noise"], posi["context"],
                       shared["first_frame_latents"])
    latents = denoise_ti2v(
        pipe.dit, posi["context"], nega["context"], height, width,
        num_frames=frames, num_inference_steps=steps, seed=seed,
        first_frame_latents=shared["first_frame_latents"],
        noise=shared["noise"],
        progress_callback=lambda i, n: stage(f"denoise_step{i}"))
    video = pipe.decode_video(latents, tiled=tiled)
    stage("vae_decode")
    return latents, shared["first_frame_latents"], video
