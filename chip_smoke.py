#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA device

Phases, each printing one line (any failure raises and exits non-zero):
  1. build the hand-written attention kernels from ``csrc/`` (nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on seeded bf16 inputs at
     the main-path shapes: max abs error (bound 1.5e-2) and CUDA-event
     times of both;
  3. a reduced-width slice (every kernel route taken) on the card in bf16
     against the same weights on the CPU in f32 through the plain versions;
  4. the full-width, full-depth Wan2.1-I2V-14B-480P fusion denoise
     (``FusionConfig()``, 336x592, 81 frames, 3 steps, geometry heads on the
     last) from random weights: shapes, finiteness, launch counts, seconds
     per step and peak memory.
Then one JSON line with the kernels' numbers, and the device JSON line last.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "fantasy_world_tpu_torch/csrc/flash_attention.cu"
REPLACES = {"generic": "fantasy_world_tpu/ops/flash_attention.py:85",
            "onekv": "fantasy_world_tpu/ops/flash_attention.py:163",
            "d64": "fantasy_world_tpu/ops/flash_attention.py:199"}
# bf16 P before P.V bounds kernel-vs-plain differences on unit-variance
# inputs
KERNEL_TOL = 1.5e-2
# reduced slice, card bf16 vs CPU f32: bf16 rounding through 3 DiT blocks,
# 2 VGGT block pairs and the heads over 2 steps; relative L2 error
SLICE_TOL = 5e-2

# name, (B, Lq, H, D), Lk, kernel -- the main path's attentions with the
# CFG pair as batch 2
SHAPES = [
    ("dit_self", (2, 16317, 40, 128), 16317, "generic"),
    ("dit_cross_text", (2, 16317, 40, 128), 512, "onekv"),
    ("dit_cross_clip", (2, 16317, 40, 128), 257, "onekv"),
    ("bicross_video_to_geometry", (2, 16317, 12, 96), 16422, "generic"),
    ("bicross_geometry_to_video", (2, 16422, 12, 96), 16317, "generic"),
    ("vggt_frame", (42, 782, 16, 64), 782, "d64"),
    ("vggt_global", (2, 16422, 16, 64), 16422, "d64"),
    ("camera_trunk", (2, 81, 16, 128), 81, "onekv"),
]
# the shape whose time stands for each kernel in the JSON line
HEADLINE = {"generic": "dit_self", "onekv": "dit_cross_text",
            "d64": "vggt_global"}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_build():
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    fa.build_kernels()
    regs = [line.split("Used")[1].split(",")[0].strip()
            for line in fa.build_log().splitlines() if "Used" in line]
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        ptxas_registers="|".join(regs) or "cached")


def phase_kernels(device):
    import torch
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=device).manual_seed(0)
    per_kernel = {k: {"max_abs_err": 0.0} for k in fa.ROUTES}
    for name, (B, Lq, H, D), Lk, kernel in SHAPES:
        if fa.route(H, D, Lk) != kernel:
            raise AssertionError(f"{name} routes to {fa.route(H, D, Lk)}")
        q = torch.randn((B, Lq, H, D), generator=g, device=device).bfloat16()
        k = torch.randn((B, Lk, H, D), generator=g, device=device).bfloat16()
        v = torch.randn((B, Lk, H, D), generator=g, device=device).bfloat16()
        scale = D ** -0.5
        out = fa.flash_attention(q, k, v)
        ref = fa.attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ms = time_ms(lambda: fa.flash_attention(q, k, v), 5)
        plain_ms = time_ms(lambda: fa.attention_plain(q, k, v, scale), 3)
        flop = 4 * B * H * Lq * Lk * D
        say("kernel", shape=name, kernel=kernel, max_abs_err=f"{err:.3e}",
            ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}",
            tflops=f"{flop / ms / 1e9:.1f}")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{name}: max abs error {err} > {KERNEL_TOL}")
        pk = per_kernel[kernel]
        pk["max_abs_err"] = max(pk["max_abs_err"], err)
        if name == HEADLINE[kernel]:
            pk["ms"], pk["plain_ms"] = ms, plain_ms
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return per_kernel


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

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
            proc = blk.cross_attn.processor
            if proc is not None:
                proc.v_proj.group2[2].weight.normal_(0.0, 0.05,
                                                     generator=generator)
        up = fusion.vggt.camera_head.camera_time_upsample.expand_channels
        up.weight.normal_(0.0, 0.05, generator=generator)


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
            raise AssertionError(f"{key}: shape "
                                 f"{None if key not in got else tuple(got[key].shape)}"
                                 f" != {shape}")
        if not bool(torch.isfinite(got[key]).all()):
            raise AssertionError(f"{key} has non-finite values")
    return got


def expected_launches(cfg, steps):
    """Kernel launches of a denoise: per step DiT self (generic), bicross
    both ways (generic), DiT cross text + CLIP (onekv), VGGT frame + global
    (d64); the camera-head trunk (onekv) on the last step."""
    n_irg = len(cfg.xattn_set())
    trunk = 4 * cfg.vggt.camera_head.trunk_depth
    return {"generic": steps * (cfg.dit.num_layers + 2 * n_irg),
            "onekv": steps * 2 * cfg.dit.num_layers + trunk,
            "d64": steps * 2 * cfg.num_irg}


def phase_small_slice(device):
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    fcfg, pcfg = small_configs()
    height, width, frames, steps = 256, 384, 21, 2
    g = torch.Generator("cpu").manual_seed(5)
    cpu_f = build(lambda: FusionModel(fcfg), device="cpu",
                  dtype=torch.float32, generator=g)
    wake_zero_inits(cpu_f, g)
    cpu_p = build(lambda: CameraPoseEncoder(pcfg), device="cpu",
                  dtype=torch.float32, generator=g)
    cond = conditioning(fcfg.dit, height, width, frames,
                        torch.Generator("cpu").manual_seed(6), 16)
    outs = {}
    before = dict(fa.LAUNCHES)
    for dev, dtype in (("cpu", torch.float32), (device, torch.bfloat16)):
        fus, pose = cpu_f, cpu_p
        if dev != "cpu":
            fus = build(lambda: FusionModel(fcfg), device=dev, dtype=dtype)
            fus.load_state_dict(cpu_f.state_dict())
            pose = build(lambda: CameraPoseEncoder(pcfg), device=dev,
                         dtype=dtype)
            pose.load_state_dict(cpu_p.state_dict())
        pipe = FantasyWorldPipeline(fus, pose)
        lat, pred = pipe.denoise(*cond[:4], height, width,
                                 num_frames=frames, num_inference_steps=steps,
                                 seed=3,
                                 plucker_fea=pipe.encode_plucker(cond[4]))
        outs[dev] = {k: v.float().cpu() for k, v in
                     check_outputs(fcfg, lat, pred, height, width,
                                   frames).items()}
    idle = [k for k in fa.ROUTES if fa.LAUNCHES[k] == before[k]]
    if idle:
        raise AssertionError(f"the reduced slice launched no {idle} kernel")
    errs = {}
    for key, ref in outs["cpu"].items():
        diff = outs[device][key] - ref
        errs[key] = (diff.norm() / ref.norm().clamp_min(1e-12)).item()
    say("small_slice", device_vs_cpu_rel_l2=json.dumps(
        {k: float(f"{v:.3e}") for k, v in errs.items()}).replace(" ", ""))
    bad = {k: v for k, v in errs.items() if not v <= SLICE_TOL}
    if bad:
        raise AssertionError(f"reduced slice disagrees with the CPU path "
                             f"beyond {SLICE_TOL}: {bad}")


def phase_full_slice(device, steps=3, seed=1024):
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import (FusionConfig,
                                                             FusionModel)
    from fantasy_world_tpu_torch.models.wan.camera import (
        CameraPoseEncoder, CameraPoseEncoderConfig)
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    cfg = FusionConfig()
    height, width, frames = 336, 592, 81
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed)
    fusion = build(lambda: FusionModel(cfg), device=device,
                   dtype=torch.bfloat16, generator=g)
    pose = build(lambda: CameraPoseEncoder(CameraPoseEncoderConfig()),
                 device=device, dtype=torch.bfloat16, generator=g)
    pipe = FantasyWorldPipeline(fusion, pose)
    cond = conditioning(cfg.dit, height, width, frames,
                        torch.Generator("cpu").manual_seed(seed), 512)
    plucker_fea = pipe.encode_plucker(cond[4])
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in fusion.parameters())
    say("full_build", seconds=f"{time.perf_counter() - t0:.2f}",
        fusion_params=n_params,
        weights_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}")

    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    events[0].record()
    lat, pred = pipe.denoise(*cond[:4], height, width, num_frames=frames,
                             num_inference_steps=steps, seed=seed,
                             plucker_fea=plucker_fea,
                             progress_callback=lambda i, n: events[i].record())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    step_s = [events[i].elapsed_time(events[i + 1]) / 1e3
              for i in range(steps)]
    got = check_outputs(cfg, lat, pred, height, width, frames)
    want = expected_launches(cfg, steps)
    say("full_slice", steps=steps, step_seconds="|".join(
        f"{s:.3f}" for s in step_s), wall_seconds=f"{wall:.2f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        launches=json.dumps(launches).replace(" ", ""),
        shapes=json.dumps({k: list(v.shape) for k, v in got.items()}
                          ).replace(" ", ""))
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    # fails here, before any output, when the port is not beside the script
    import fantasy_world_tpu_torch.pipelines.wan_video  # noqa: F401
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    say("device", name=torch.cuda.get_device_name(0).replace(" ", "_"),
        torch=torch.__version__, cuda=torch.version.cuda)

    phase_build()
    per_kernel = phase_kernels(device)
    phase_small_slice(device)
    launches = phase_full_slice(device)

    kernels = [{"name": f"fa_fwd_{k}", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": per_kernel[k]["max_abs_err"],
                "ms": per_kernel[k]["ms"],
                "plain_ms": per_kernel[k]["plain_ms"]}
               for k in ("generic", "onekv", "d64")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
