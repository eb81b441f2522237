#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA device

Phases, each printing one line per check (any failure raises and exits
non-zero):
  1. build the hand-written attention kernels from ``csrc/`` (nvcc, sm_90a,
     one process per source, all at once);
  2. each forward kernel against its plain PyTorch version on seeded bf16
     inputs at the denoise shapes, those of the CFG pair and those of the
     serve batch (``SERVE_CLIPS`` clips): max abs error (bound: two bf16 ulps of
     the largest output, at most 1.5e-2) and CUDA-event times of both,
     beside the yardsticks: the bound (the larger of FLOP at the bf16 peak
     and bytes at the HBM rate), the share of it reached,
     ``scaled_dot_product_attention``'s time on the same inputs per pinned
     backend (flash, cuDNN), the shape's layers per denoise step, and at
     the onekv shapes the online-softmax kernel's time (``online_ms``);
  3. the stats forward, dq and dk/dv against their plain versions at the
     training shapes (batch 1): max abs errors of o, m2, l, dq, dk, dv (dq,
     dk, dv bound by two bf16 ulps of the largest gradient, ``grad_tol``),
     times of each kernel and its plain version, the same yardsticks (the
     library's backward computes dq, dk and dv in one call);
  4. a reduced-width denoise (every kernel route taken) on the card in bf16
     against the same weights on the CPU in f32 through the plain versions;
     then the reduced clip the same way: ``FantasyWorldSampler.
     generate_video`` and ``export`` with reduced umT5, CLIP (2 heads of 80,
     onekv) and VAE (latents, prediction and float decode within SLICE_TOL,
     exact launch counts with CLIP's);
  5. reduced-width training on the card in bf16 against the CPU in f32:
     two LoRA steps (losses, factor gradients; every stats-forward and
     backward kernel at D 64, 96 and 128 launched) and one full
     fine-tuning step (loss, gradients);
  6. the trainer's entry point, ``cli.train --synthetic --lora_rank 4`` at
     its demo config: 2 steps saved, then resumed to step 3 (finite
     losses, both checkpoints, the stats and backward kernels launched);
     then ``train_cli_data``: ``cli.train --data_root --lora_rank 4`` on a
     reduced-width reference-layout checkpoint written from a seed and a
     21-frame 256x384 clip of PNGs with RealEstate10K poses, 2 steps saved
     and a resume to 3 (finite losses, both checkpoints, exact launches:
     CLIP's and the training step's, per step);
  7. the full-width, full-depth Wan2.1-I2V-14B-480P fusion denoise
     (``FusionConfig()``, 336x592, 81 frames, 3 steps, geometry heads on the
     last) from random weights: shapes, finiteness, launch counts (in all,
     and of the second step, which must match the configuration's layers),
     seconds per step and peak memory;
  8. the whole clip on that model: umT5-XXL, CLIP ViT-H, the Wan VAE and
     MoGe-2 (DINOv2-L, its scene-scale normalization of the camera path) at
     full width, ``generate_video`` at 336x592, 81 frames, 2 steps, and
     ``export``: each stage's seconds and peak memory, the launches (CLIP's
     31 onekv and MoGe's 24 d64 among them), the output shapes, finiteness;
     CLIP is freed after, umT5 and the VAE kept for step 10; before that,
     ``full_data_train`` on the same pipeline: an 81-frame 336x592 clip
     (PNGs panning across the example image, ``poses.txt`` from the
     example camera path) read by the trainer's ``read_clip``, its batch
     built by ``build_train_batch`` (each encoder's seconds and peak GB),
     then two LoRA rank-16 steps on it (finite losses, a moved factor, an
     unchanged base, exact launches, seconds and peak GB);
  9. two full-width LoRA training steps (rank 16, per-block recompute,
     batch 1) on the same model: finite losses, moved factors, an unchanged
     base, exact launch counts, seconds per step and peak memory;
 10. the Wan2.2-Fun-A14B-Control-Camera clip at full width and depth
     (``Wan22Sampler.generate_video`` at 480x832, 81 frames, 2 steps: t =
     1000 on the high expert, t ~ 833 on the low one with the heads), the
     Wan2.1 model freed first, umT5 and the VAE shared, the low expert in
     pinned host memory until the swap: each stage's seconds and peak
     memory, the launches, the output shapes, finiteness.
Between steps 4 and 5, ``small_wan22``: the Wan2.2 sampler at reduced widths
(two experts, one swapped in through the host, MoGe, the end image), 3
steps with the boundary between the second and the third, on the card
against the CPU.

The Wan2.2 TI2V-5B path and the sliding window:
  * after the reduced denoise, ``small_windowed``: the Wan2.1 denoise in
    sliding temporal windows (two of 6 of 11 latent frames) at reduced
    widths, card against CPU within SLICE_TOL, exact launches;
  * after small_wan22, ``small_ti2v``: ``run_condition`` (the 38-block
    VAE's latent of the image in latent frame 0), ``denoise_ti2v`` and
    ``decode_video`` at reduced widths, card against CPU within
    SLICE_TOL, frame 0 equal to the clean latent after the loop;
  * after step 9, ``full_windowed``: one step of the full-depth model in
    two windows of 11 of the 21 latent frames: seconds, peak GB, exact
    launches;
  * after step 10, ``full_ti2v``: TI2V-5B at full width and depth from a
    seed (30 blocks of 3072, the 38-block VAE) beside the umT5-XXL of the
    clips: the example image at 704x1280, 2 steps at 121 frames, the tiled
    decode; each stage's seconds and peak GB, a 50-step clip reckoned from
    them, exactly 30 generic and 30 onekv launches a step.
  The kernels are also held to their plain versions at TI2V-5B's shapes
  (27,280 rows of 24 heads; over themselves and over 512 text keys).

The serving path (``core/quant.py``, ``pipelines/tea_cache.py``, the
segmented and resumable denoise, ``serving/server.py``, ``cli/serve.py``):
  * after step 3, ``qlinear``: int8 and fp8 at the DiT's linears of the
    full step (32,634 rows, 5120 -> 5120 and 13,824, 13,824 -> 5120)
    against the same arithmetic reckoned in f32, within two bf16 ulps of
    the largest output; the times of int8 qlinear, its activation quant,
    ``torch._int_mm`` and rescale, fp8 qlinear and bf16 ``F.linear``,
    beside their bounds;
  * after small_wan22, ``small_serve``: int8, fp8, and TeaCache cut after
    a segment and resumed, on the reduced Wan2.1 model, and the reduced
    Wan2.2 experts quantized to int8 (the low one pinned and swapped in)
    with TeaCache's dual plan, cut at the boundary and resumed; card
    against CPU within SLICE_TOL, the card's plans equal to the CPU's;
  * after step 8, ``full_serve``: a ``GenerationServer`` on 127.0.0.1:0 over
    the full clip's sampler, two same-key jobs batched as B = 2 (2 steps)
    and a TeaCache job (4 steps, a plan that skips), posted over HTTP and
    polled to done: each batch's seconds and peak GB, the progress seen,
    the outputs' shapes, exact launches;
  * after step 10, ``full_quant``: the Wan2.2 expert left on the card, one
    step in bf16, then quantized to int8 in place and the step again, once
    under the profiler: seconds, peak and resident GB, the drift against
    bf16, the device time of the quantization glue.
Then one JSON line with the kernels' numbers, and the device JSON line last.
Imports nothing of JAX.

    python3 chip_smoke.py --profile DIR

also runs the 3-step denoise again with its second step and its last step
(the one with the heads) under ``torch.profiler`` (started and stopped
from the pipeline's progress callback), a third full-width training step
under it, and the Wan2.2 clip again with its two steps under it (the high
expert's, and the low one's with the heads), and writes for each its
device-time breakdown by kernel family and by attention kernel, its idle
share against the same unprofiled step and a gzipped Chrome trace into DIR
(``denoise_step_breakdown.json``, ``denoise_heads_step_breakdown.json``,
``train_step_breakdown.json``, ``wan22_denoise_step_breakdown.json``,
``wan22_denoise_heads_step_breakdown.json``).
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SM90_SOURCE = "fantasy_world_tpu_torch/csrc/flash_attention_sm90.cu"
SOURCES = {"generic": SM90_SOURCE,
           "onekv": "fantasy_world_tpu_torch/csrc/flash_attention_onekv.cu",
           "d64": SM90_SOURCE}
BWD_SOURCE = "fantasy_world_tpu_torch/csrc/flash_attention_bwd.cu"
JAX_FA = "fantasy_world_tpu/ops/flash_attention.py"
REPLACES = {"generic": f"{JAX_FA}:85", "onekv": f"{JAX_FA}:163",
            "d64": f"{JAX_FA}:199", "bwd_dq": f"{JAX_FA}:470",
            "bwd_dkv": f"{JAX_FA}:507"}
# o, kernel against plain version: the same bf16 rounding points (q, P, o),
# so they differ by f32 summation order and one-ulp flips of the bf16
# output, at most 2^-7 of the largest |o|. The bound is two such ulps,
# OUT_RTOL * max |reference|, and never more than KERNEL_TOL. An absolute
# bound alone would be blind at many keys: on unit-variance inputs |o| is
# about sqrt(e / Lk), 0.013 at 16k keys, below KERNEL_TOL, so a dropped key
# tile or a wrong P.V panel would pass it.
KERNEL_TOL = 1.5e-2
OUT_RTOL = 2 ** -6
# m2 and l: f32 on both sides from the same bf16 logits, summation order
# only; relative to max(1, |m2|) and to l (>= 1)
STATS_RTOL = 1e-4
# dq, dk, dv: the same bf16 rounding points for ds and p, so f32 summation
# order, rare one-ulp flips of a bf16 ds or p, and one-ulp flips of the bf16
# result, at most 2^-7 of the largest |gradient|. The bound (grad_tol) is
# two such ulps, OUT_RTOL * max |reference|, and never looser than
# BWD_RTOL * max(1, max |reference|). That alone would be blind at the long
# shapes: at 16k queries and keys every gradient is ~0.1-0.2 at most, so 8
# lost query rows of one tile, 8 lost keys, a skipped tail tile or a do
# panel read from the wrong tile (1.0-1.9e-2) would pass it. Nor is it
# ever tighter than GRAD_ATOL: where a gradient vanishes analytically (one
# key: the softmax passes no gradient to its logits, so dq = dk = 0) both
# sides hold only f32 cancellation noise, up to 4e-6 at 255 queries (the
# plain version in f32 against f64).
BWD_RTOL = 1e-2
GRAD_ATOL = 1e-4
# reduced slice, card bf16 vs CPU f32: bf16 rounding through 3 DiT blocks,
# 2 VGGT block pairs and the heads over 2 steps; relative L2 error
SLICE_TOL = 5e-2
# reduced training, card bf16 vs CPU f32: the loss and the gradients
# (relative L2 over all of them) carry the forward's bf16 rounding plus the
# backward's, through 3 DiT blocks, 2 VGGT block pairs and bicross
TRAIN_TOL = 5e-2

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
    # CLIP's self-attention, once per image: 16 heads of 80 (onekv pads D
    # to 128)
    ("clip_self", (1, 257, 16, 80), 257, "onekv"),
    # Wan2.2 at 480x832, 81 frames: 21 x 30 x 52 video tokens; 30 x 52 + 5
    # geometry tokens a frame; text keys only (no CLIP branch)
    ("wan22_dit_self", (2, 32760, 40, 128), 32760, "generic"),
    ("wan22_dit_cross_text", (2, 32760, 40, 128), 512, "onekv"),
    ("wan22_bicross_video_to_geometry", (2, 32760, 12, 96), 32865,
     "generic"),
    ("wan22_bicross_geometry_to_video", (2, 32865, 12, 96), 32760,
     "generic"),
    ("wan22_vggt_frame", (42, 1565, 16, 64), 1565, "d64"),
    ("wan22_vggt_global", (2, 32865, 16, 64), 32865, "d64"),
    # MoGe's DINOv2-L, once per clip: the example 592x336 image at 3600
    # tokens is a 45 x 79 patch grid plus the class token
    ("moge_dinov2", (1, 3556, 16, 64), 3556, "d64"),
    # Wan2.2 TI2V-5B at 704x1280, 121 frames: 31 x 22 x 40 tokens, 24
    # heads of 128 (a ragged last 128-row tile), umT5's 512 keys
    ("ti2v_dit_self", (2, 27280, 24, 128), 27280, "generic"),
    ("ti2v_dit_cross_text", (2, 27280, 24, 128), 512, "onekv"),
]
# full_serve's batch: SERVE_CLIPS clips denoised as one CFG batch, so each
# Wan2.1 denoise attention above runs on SERVE_CLIPS times its rows (CLIP
# and MoGe still run once per clip, at batch 1)
SERVE_CLIPS = 2
SHAPES += [("serve_" + name, (B * SERVE_CLIPS, Lq, H, D), Lk, kernel)
           for name, (B, Lq, H, D), Lk, kernel in SHAPES
           if name in ("dit_self", "dit_cross_text", "dit_cross_clip",
                       "bicross_video_to_geometry",
                       "bicross_geometry_to_video", "vggt_frame",
                       "vggt_global", "camera_trunk")]
# the shape whose time stands for each kernel in the JSON line
HEADLINE = {"generic": "dit_self", "onekv": "dit_cross_text",
            "d64": "vggt_global", "bwd_dq": "dit_self",
            "bwd_dkv": "dit_self"}
# the training step's attentions, batch 1 (no CFG pair)
TRAIN_SHAPES = [
    ("dit_self", (1, 16317, 40, 128), 16317, "generic"),
    ("dit_cross_text", (1, 16317, 40, 128), 512, "onekv"),
    ("dit_cross_clip", (1, 16317, 40, 128), 257, "onekv"),
    ("bicross_video_to_geometry", (1, 16317, 12, 96), 16422, "generic"),
    ("bicross_geometry_to_video", (1, 16422, 12, 96), 16317, "generic"),
    ("vggt_frame", (21, 782, 16, 64), 782, "d64"),
    ("vggt_global", (1, 16422, 16, 64), 16422, "d64"),
]


def out_tol(ref) -> float:
    """The bound on max |o - ref| of a forward kernel (see OUT_RTOL)."""
    return min(KERNEL_TOL, OUT_RTOL * ref.float().abs().max().item())


def grad_tol(ref) -> float:
    """The bound on max |g - ref| of a backward kernel's gradient (see
    BWD_RTOL)."""
    largest = ref.float().abs().max().item()
    return max(GRAD_ATOL, min(BWD_RTOL * max(1.0, largest),
                              OUT_RTOL * largest))


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


# published dense peaks of one H100 SXM: bf16 tensor cores, HBM3
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# FLOP per B*H*Lq*Lk*D of each kernel: the forward's two products; dq's
# three (S, dP, dS.K); dk/dv's four (S, dP, dS^T.Q, P^T.dO)
FLOP_UNITS = {"fwd": 4, "stats": 4, "dq": 6, "dkv": 8}


def attention_bound(kind, B, Lq, Lk, H, D):
    """The least time the card could take for one attention kernel call:
    the larger of its FLOP at the bf16 peak and its bytes (each input read
    once, each output written once) at the HBM rate. bf16 tensors: q, k, v,
    o, do, dq, dk, dv; f32 (B, Lq, H) rows: m2, l, lse2, delta.
    Returns {"flop", "bytes", "bound_ms", "bound_by"}."""
    q, kv, row = 2 * B * Lq * H * D, 2 * B * Lk * H * D, 4 * B * Lq * H
    nbytes = {"fwd": 2 * q + 2 * kv,              # q k v -> o
              "stats": 2 * q + 2 * kv + 2 * row,  # q k v -> o m2 l
              "dq": 4 * q + 2 * kv + 2 * row,     # q k v o do lse2 -> dq delta
              "dkv": 2 * q + 4 * kv + 2 * row,   # q k v do lse2 delta -> dk dv
              }[kind]
    flop = FLOP_UNITS[kind] * B * H * Lq * Lk * D
    t_flop, t_bytes = flop / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"flop": flop, "bytes": nbytes, "bound_ms": max(t_flop, t_bytes),
            "bound_by": "operations" if t_flop >= t_bytes else "bytes"}


def layers_per_step(cfg):
    """The configuration's count of each attention shape in ``SHAPES`` per
    denoise step (without the last step's heads, and CLIP and MoGe, which
    run once per image): what each shape adds to its route's launches,
    which ``phase_full_slice`` measures. A Wan2.2 configuration (the
    control adapter) counts the ``wan22_`` shapes, a Wan2.1 one the
    others but the ``serve_`` ones, which only ``phase_full_serve`` runs."""
    n_dit, n_x, n_irg = cfg.dit.num_layers, len(cfg.xattn_set()), cfg.num_irg
    counts = {"dit_self": n_dit, "dit_cross_text": n_dit,
              "bicross_video_to_geometry": n_x,
              "bicross_geometry_to_video": n_x, "vggt_frame": n_irg,
              "vggt_global": n_irg}
    if cfg.dit.has_image_input:
        counts["dit_cross_clip"] = n_dit
    prefix = "wan22_" if cfg.dit.add_control_adapter else ""
    out = {name: 0 for name, *_ in SHAPES}
    out.update({prefix + name: n for name, n in counts.items()})
    return out


def time_sdpa(q, k, v, reps, do=None):
    """The yardstick: one ``scaled_dot_product_attention`` call on the
    (B, H, L, D) views of q, k, v, per pinned backend -- the forward, or
    with ``do`` the backward alone (dq, dk and dv of a forward taken
    once). {backend: ms, or None where the backend refuses the shape}.
    The port never calls SDPA."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    pinned = {"flash": SDPBackend.FLASH_ATTENTION,
              "cudnn": SDPBackend.CUDNN_ATTENTION}
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = {}
    for name, backend in pinned.items():
        try:
            with sdpa_kernel([backend]):
                if do is None:
                    out[name] = time_ms(
                        lambda: F.scaled_dot_product_attention(qt, kt, vt),
                        reps)
                    continue
                leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
                o = F.scaled_dot_product_attention(*leaves)
                dot = do.transpose(1, 2)
                out[name] = time_ms(lambda: torch.autograd.grad(
                    o, leaves, dot, retain_graph=True), reps)
                del o, leaves
        except RuntimeError as e:         # the backend lacks this shape
            say("sdpa", backend=name, refused=str(e).splitlines()[0][:80])
            out[name] = None
    return out


def yardsticks(kind, shape, ms, library):
    """TFLOP/s, bound_ms, bound_by, share and the library's time of one
    kernel call at ``shape`` = (B, Lq, Lk, H, D) that took ``ms``;
    ``library`` = {backend: ms or None}, and library_ms is its fastest."""
    b = attention_bound(kind, *shape)
    ran = [t for t in library.values() if t is not None]
    return {"tflops": b["flop"] / ms / 1e9, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "share": b["bound_ms"] / ms,
            "library_ms": min(ran) if ran else None,
            "library_ms_by_backend": library}


def _fmt(x, spec=".3f"):
    return "null" if x is None else format(x, spec)


def ptxas_summary(log: str) -> str:
    """'kernel<D>:registers:spill bytes' for each kernel in nvcc's -Xptxas -v
    output."""
    kernels, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '\w*?(fa_\w+?)ILi(\d+)E",
                          line)
        if found:
            name = f"{found.group(1)}<{found.group(2)}>"
            kernels[name] = ["?", 0]
        elif name and "bytes spill" in line:
            kernels[name][1] = sum(int(n) for n in
                                   re.findall(r"(\d+) bytes spill", line))
        elif name and "Used" in line:
            kernels[name][0] = line.split("Used")[1].split("reg")[0].strip()
    return "|".join(f"{n}:{r}:{s}" for n, (r, s) in kernels.items())


def phase_build():
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    fa.build_kernels()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        kernel_registers_spills=ptxas_summary(fa.build_log()) or "cached")


def phase_kernels(device):
    import torch
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.convert.checkpoint import wan22_fusion_config
    g = torch.Generator(device=device).manual_seed(0)
    from fantasy_world_tpu_torch.models.wan.dit import TI2V_5B
    layers = {k: v + layers_per_step(wan22_fusion_config())[k]
              for k, v in layers_per_step(FusionConfig()).items()}
    layers.update(ti2v_dit_self=TI2V_5B.num_layers,
                  ti2v_dit_cross_text=TI2V_5B.num_layers)
    per_kernel = {k: {"max_abs_err": 0.0, "by_shape": []} for k in fa.ROUTES}
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
        err, tol = _max_err(out, ref), out_tol(ref)
        ms = time_ms(lambda: fa.flash_attention(q, k, v), 5)
        plain_ms = time_ms(lambda: fa.attention_plain(q, k, v, scale), 3)
        y = yardsticks("fwd", (B, Lq, Lk, H, D), ms, time_sdpa(q, k, v, 5))
        # beside onekv, the online-softmax kernel on the same inputs: a
        # yardstick the main path never takes (it routes by Lk)
        if kernel == "onekv":
            dg = fa.kernel_dim(H, D, fa.ONEKV_MAX_LK + 1)
            qg, kg, vg = (torch.nn.functional.pad(t, (0, dg - D))
                          for t in (q, k, v))
            y["online_ms"] = time_ms(
                lambda: fa.launch("generic", qg, kg, vg, scale), 5)
            del qg, kg, vg
        say("kernel", shape=name, kernel=kernel, max_abs_err=f"{err:.3e}",
            bound=f"{tol:.3e}", ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}",
            online_ms=_fmt(y.get("online_ms")), tflops=f"{y['tflops']:.1f}",
            bound_ms=f"{y['bound_ms']:.4f}", bound_by=y["bound_by"],
            share=f"{y['share']:.4f}",
            library_ms="|".join(f"{b}:{_fmt(t)}" for b, t in
                                y["library_ms_by_backend"].items()),
            layers_per_step=layers[name])
        if not err <= tol:
            raise AssertionError(f"{name}: max abs error {err} > {tol}")
        pk = per_kernel[kernel]
        pk["max_abs_err"] = max(pk["max_abs_err"], err)
        pk["by_shape"].append({"shape": name, "ms": ms, "plain_ms": plain_ms,
                               "max_abs_err": err, "err_bound": tol,
                               "layers_per_step": layers[name], **y})
        if name == HEADLINE[kernel]:
            pk.update(ms=ms, plain_ms=plain_ms, **y)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return per_kernel


def _max_err(got, ref):
    return (got.float() - ref.float()).abs().max().item()


def phase_train_kernels(device, per_kernel):
    """Stats forward, dq and dk/dv against their plain versions at the
    training shapes; adds the stats and backward numbers to per_kernel."""
    import torch
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=device).manual_seed(1)
    for k in ("bwd_dq", "bwd_dkv"):
        per_kernel[k] = {"max_abs_err": 0.0, "by_shape": []}
    for name, (B, Lq, H, D), Lk, kernel in TRAIN_SHAPES:
        if fa.route(H, D, Lk) != kernel:
            raise AssertionError(f"{name} routes to {fa.route(H, D, Lk)}")
        q = torch.randn((B, Lq, H, D), generator=g, device=device).bfloat16()
        k = torch.randn((B, Lk, H, D), generator=g, device=device).bfloat16()
        v = torch.randn((B, Lk, H, D), generator=g, device=device).bfloat16()
        do = torch.randn((B, Lq, H, D), generator=g, device=device
                         ).bfloat16()
        scale = D ** -0.5
        o, m2, l = fa.flash_attention_stats(q, k, v)
        ro, rm2, rl = fa.attention_plain_stats(q, k, v, scale)
        lse2 = m2 + torch.log2(l)
        dq, delta = fa.launch_bwd_dq(q, k, v, o, lse2, do, scale)
        dk, dv = fa.launch_bwd_dkv(q, k, v, lse2, do, delta, scale)
        ref = fa.attention_backward_plain(q, k, v, o, lse2, do, scale)
        torch.cuda.synchronize()
        errs = {"o": _max_err(o, ro), "m2": _max_err(m2, rm2),
                "l": _max_err(l, rl)}
        o_tol = out_tol(ro)
        rel = {"m2": ((m2 - rm2).abs() / rm2.abs().clamp_min(1)).max().item(),
               "l": ((l - rl).abs() / rl).max().item()}
        g_tol = {}
        for gname, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            errs[gname] = _max_err(got, want)
            g_tol[gname] = grad_tol(want)
        del ref, ro, rm2, rl
        ms = {"stats": time_ms(lambda: fa.flash_attention_stats(q, k, v), 5),
              "dq": time_ms(lambda: fa.launch_bwd_dq(q, k, v, o, lse2, do,
                                                      scale), 5),
              "dkv": time_ms(lambda: fa.launch_bwd_dkv(q, k, v, lse2, do,
                                                        delta, scale), 5)}
        # the plain backward computes dq, dk and dv in one pass: it stands
        # beside the sum of the two kernels
        plain = {
            "stats": time_ms(lambda: fa.attention_plain_stats(q, k, v, scale),
                             3),
            "bwd": time_ms(lambda: fa.attention_backward_plain(
                q, k, v, o, lse2, do, scale), 3)}
        ms["bwd"] = ms["dq"] + ms["dkv"]
        # the library's forward stands beside the stats forward, its
        # backward (dq, dk and dv in one call) beside each backward kernel
        lib_fwd = time_sdpa(q, k, v, 5)
        lib_bwd = time_sdpa(q, k, v, 3, do=do)
        dims = (B, Lq, Lk, H, D)
        ys = {"stats": yardsticks("stats", dims, ms["stats"], lib_fwd),
              "dq": yardsticks("dq", dims, ms["dq"], lib_bwd),
              "dkv": yardsticks("dkv", dims, ms["dkv"], lib_bwd)}
        say("train_kernel", shape=name, kernel=kernel, D=D,
            max_abs_err="|".join(f"{n}:{e:.3e}" for n, e in errs.items()),
            o_bound=f"{o_tol:.3e}",
            grad_bound="|".join(f"{n}:{t:.3e}" for n, t in g_tol.items()),
            **{f"{n}_ms": f"{ms[n]:.3f}" for n in ms},
            **{f"{n}_plain_ms": f"{plain[n]:.3f}" for n in plain},
            tflops="|".join(f"{n}:{y['tflops']:.1f}" for n, y in ys.items()),
            bound_ms="|".join(f"{n}:{y['bound_ms']:.4f}"
                              for n, y in ys.items()),
            share="|".join(f"{n}:{y['share']:.4f}" for n, y in ys.items()),
            library_fwd_ms="|".join(f"{b}:{_fmt(t)}"
                                    for b, t in lib_fwd.items()),
            library_bwd_ms="|".join(f"{b}:{_fmt(t)}"
                                    for b, t in lib_bwd.items()))
        bad = [] if errs["o"] <= o_tol else ["o"]
        bad += [n for n in ("m2", "l") if not rel[n] <= STATS_RTOL]
        bad += [n for n in ("dq", "dk", "dv") if not errs[n] <= g_tol[n]]
        if bad:
            raise AssertionError(f"{name}: {bad} beyond their bounds: "
                                 f"abs {errs} (o bound {o_tol}, gradient "
                                 f"bounds {g_tol}), relative {rel}")
        fwd = per_kernel[kernel]
        fwd["max_abs_err"] = max(fwd["max_abs_err"], errs["o"])
        fwd.setdefault("stats_by_shape", []).append(
            {"shape": name, "ms": ms["stats"], "plain_ms": plain["stats"],
             "max_abs_err": errs["o"], "err_bound": o_tol, **ys["stats"]})
        fwd["stats_max_abs_err"] = max(fwd.get("stats_max_abs_err", 0.0),
                                       errs["o"])
        if name == HEADLINE[kernel]:
            fwd["stats_ms"] = ms["stats"]
            fwd["stats_plain_ms"] = plain["stats"]
            fwd["stats_yardsticks"] = ys["stats"]
        for kname, part, grads in (("bwd_dq", "dq", ("dq",)),
                                   ("bwd_dkv", "dkv", ("dk", "dv"))):
            pk = per_kernel[kname]
            pk["max_abs_err"] = max([pk["max_abs_err"]]
                                    + [errs[n] for n in grads])
            pk["by_shape"].append({"shape": name, "D": D, "ms": ms[part],
                                   "plain_ms": plain["bwd"],
                                   "max_abs_err": {n: errs[n] for n in grads},
                                   "err_bound": {n: g_tol[n] for n in grads},
                                   **ys[part]})
            if name == HEADLINE[kname]:
                pk.update(ms=ms[part], plain_ms=plain["bwd"],
                          backward_ms=ms["bwd"], **ys[part])
        del q, k, v, do, o, m2, l, lse2, dq, delta, dk, dv
        torch.cuda.empty_cache()


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


def expected_launches(cfg, steps, clip=None, moge=None, skipped=0):
    """Kernel launches of a denoise: per step DiT self (generic), bicross
    both ways (generic), DiT cross text, and CLIP where the model takes it
    (onekv), VGGT frame + global (d64); the camera-head trunk (onekv) on the
    last step; none on the ``skipped`` steps (TeaCache replaces their block
    stack). With ``clip`` and ``moge``, the encoders' launches of one clip
    (``encoder_launches``)."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    n_irg = len(cfg.xattn_set())
    trunk = 4 * cfg.vggt.camera_head.trunk_depth
    cross = 2 if cfg.dit.has_image_input else 1
    run = steps - skipped
    out = {k: 0 for k in fa.LAUNCHES}
    out.update(generic=run * (cfg.dit.num_layers + 2 * n_irg),
               onekv=run * cross * cfg.dit.num_layers + trunk,
               d64=run * 2 * cfg.num_irg)
    for k, v in encoder_launches(clip, moge).items():
        out[k] += v
    return out


def encoder_launches(clip=None, moge=None):
    """The kernel launches of one clip's encoders: with ``clip`` (a
    CLIPVisionConfig), the image encoder's self-attention, one launch per
    block it runs (all but the last) on its route; with ``moge`` (a
    MoGeConfig and its token count), DINOv2's, one per block."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    out = {}
    if clip is not None:
        route = fa.route(clip.num_heads, clip.dim // clip.num_heads,
                         clip.num_patches + 1)
        out[route] = out.get(route, 0) + clip.num_layers - 1
    if moge is not None:
        mcfg, tokens = moge
        enc = mcfg.encoder
        route = fa.route(enc.num_heads, enc.dim // enc.num_heads, tokens)
        out[route] = out.get(route, 0) + enc.depth
    return out


def moge_tokens(cfg, image_hw, resolution_level=9):
    """DINOv2's sequence length for an (H, W) image at the resolution level
    ``moge_infer`` uses: the patch grid of its token budget plus the class
    token."""
    h, w = image_hw
    lo, hi = cfg.num_tokens_range
    n = int(lo + (resolution_level / 9) * (hi - lo))
    return int((n / (w / h)) ** 0.5) * int((n * (w / h)) ** 0.5) + 1


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


# ---------------------------------------------------------------------------
# the clip around the denoise: prompt, image, camera, decode, export
# ---------------------------------------------------------------------------

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


def phase_small_clip(device):
    """``FantasyWorldSampler.generate_video`` and ``export`` at reduced
    widths, on the card in bf16 (kernels) and on the CPU in f32 (plain
    versions) from the same weights: the latents, the prediction and the
    float decode within SLICE_TOL, exact launch counts with CLIP's."""
    import shutil
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
    from fantasy_world_tpu_torch.models.wan.clip import CLIPVision
    from fantasy_world_tpu_torch.models.wan.t5 import T5Encoder
    from fantasy_world_tpu_torch.models.wan.vae import WanVAE
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    from fantasy_world_tpu_torch.sampler import FantasyWorldSampler
    t_phase = time.perf_counter()
    fcfg, pcfg, t5c, clipc, vaec = small_clip_configs()
    ctors = {"fusion": (FusionModel, fcfg), "pose": (CameraPoseEncoder, pcfg),
             "t5": (T5Encoder, t5c), "clip": (CLIPVision, clipc),
             "vae": (WanVAE, vaec)}
    height, width, frames, steps = 256, 384, 21, 2
    g = torch.Generator("cpu").manual_seed(11)
    weights = {n: build(lambda: c(cfg), device="cpu", dtype=torch.float32,
                        generator=g) for n, (c, cfg) in ctors.items()}
    wake_zero_inits(weights["fusion"], g)
    image, cams = clip_inputs(height, width, frames)
    out_root = os.path.join(REPO, "build", "clip_export")
    outs = {}
    for dev, dtype in (("cpu", torch.float32), (device, torch.bfloat16)):
        mods = weights
        if dev != "cpu":
            mods = {}
            for n, (c, cfg) in ctors.items():
                mods[n] = build(lambda: c(cfg), device=dev, dtype=dtype)
                mods[n].load_state_dict(weights[n].state_dict())
        pipe = FantasyWorldPipeline(mods["fusion"], mods["pose"],
                                    t5=mods["t5"], clip=mods["clip"],
                                    vae=mods["vae"])
        tok = install_tokenizer(pipe, t5c.vocab,
                                os.path.join(out_root, "tokenizer"))
        decode, seen = pipe.decode_video, {}

        def record(latents, **kw):
            seen["latents"] = latents
            return decode(latents, **kw)
        pipe.decode_video = record
        fa.reset_launch_counts()
        video, pred = FantasyWorldSampler(pipe).generate_video(
            PROMPT, NEG_PROMPT, image=image, camera_params=cams,
            using_scale=True, seed=3, height=height, width=width,
            num_frames=frames, sample_steps=steps)
        launches = dict(fa.LAUNCHES)
        with torch.no_grad():
            dec = pipe.vae.decode(seen["latents"])
        paths = FantasyWorldSampler.export(
            video, pred, os.path.join(out_root, str(dev)), stride=8)
        got = check_outputs(fcfg, seen["latents"],
                            {k: torch.from_numpy(v) for k, v in pred.items()},
                            height, width, frames)
        outs[str(dev)] = {"t": {k: v.float().cpu() for k, v in got.items()},
                          "decode": dec.float().cpu(), "video": video,
                          "launches": launches, "paths": paths}
        del mods, pipe, dec
    shutil.rmtree(out_root, ignore_errors=True)
    cpu, card = outs["cpu"], outs[str(device)]
    errs = {k: _rel_l2([card["t"][k]], [cpu["t"][k]]) for k in cpu["t"]}
    errs["decode"] = _rel_l2([card["decode"]], [cpu["decode"]])
    want = expected_launches(fcfg, steps, clip=clipc)
    say("small_clip", seconds=f"{time.perf_counter() - t_phase:.2f}",
        tokenizer=tok, image="example_png",
        video_file=saved_as(card["paths"]["video"]),
        ply=os.path.basename(card["paths"]["ply"]),
        video_shape="x".join(map(str, card["video"].shape)),
        video_max_level_diff=int(np.abs(card["video"].astype(int)
                                        - cpu["video"].astype(int)).max()),
        device_vs_cpu_rel_l2=json.dumps({k: float(f"{v:.3e}") for k, v in
                                         errs.items()}).replace(" ", ""),
        launches=json.dumps({k: v for k, v in card["launches"].items()
                             if v}).replace(" ", ""))
    if any(cpu["launches"].values()):
        raise AssertionError(f"the CPU run launched {cpu['launches']}")
    if card["launches"] != want:
        raise AssertionError(f"small clip launches {card['launches']} != "
                             f"{want}")
    if card["video"].shape != (frames, height, width, 3):
        raise AssertionError(f"video shape {card['video'].shape}")
    bad = {k: v for k, v in errs.items() if not v <= SLICE_TOL}
    if bad:
        raise AssertionError(f"the reduced clip disagrees with the CPU path "
                             f"beyond {SLICE_TOL}: {bad}")


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


def phase_small_wan22(device):
    """``Wan22Sampler.generate_video`` at reduced widths with MoGe and an
    end image, 3 steps (t ~ 1000 and 909 on the high expert, t ~ 715 on
    the low one with the heads), on the card in bf16 -- the low expert in
    pinned host memory until the swap -- and on the CPU in f32 from the
    same weights: the latents, the prediction and the float decode within
    SLICE_TOL, exact launch counts with MoGe's."""
    import shutil
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.moge.model import MoGe
    from fantasy_world_tpu_torch.models.wan.t5 import T5Encoder
    from fantasy_world_tpu_torch.models.wan.vae import (WanVAE,
                                                        vae_decode_tiled)
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    from fantasy_world_tpu_torch.pipelines.wan_video_22 import (
        DualModelDenoiser, pin_to_host)
    from fantasy_world_tpu_torch.sampler import Wan22Sampler
    t_phase = time.perf_counter()
    fcfg, t5c, vaec, mcfg = small_wan22_configs()
    ctors = {"high": (FusionModel, fcfg), "low": (FusionModel, fcfg),
             "t5": (T5Encoder, t5c), "vae": (WanVAE, vaec),
             "moge": (MoGe, mcfg)}
    height, width, frames, steps = 256, 384, 21, 3
    g = torch.Generator("cpu").manual_seed(13)
    weights = {n: build(lambda: c(cfg), device="cpu", dtype=torch.float32,
                        generator=g) for n, (c, cfg) in ctors.items()}
    for n in ("high", "low"):
        wake_zero_inits(weights[n], g)
    image, cams = clip_inputs(height, width, frames)
    end = np.ascontiguousarray(image[::-1])
    out_root = os.path.join(REPO, "build", "wan22_export")
    outs = {}
    for dev, dtype in (("cpu", torch.float32), (device, torch.bfloat16)):
        mods = weights
        if dev != "cpu":
            mods = {}
            for n, (c, cfg) in ctors.items():
                mods[n] = build(lambda: c(cfg), device=dev, dtype=dtype)
                mods[n].load_state_dict(weights[n].state_dict())
            pin_to_host(mods["low"])
        pipe = FantasyWorldPipeline(t5=mods["t5"], vae=mods["vae"])
        install_tokenizer(pipe, t5c.vocab, os.path.join(out_root, "tok"))
        decode, seen, stages = pipe.decode_video, {}, []

        def record(latents, **kw):
            seen["latents"] = latents
            return decode(latents, **kw)
        pipe.decode_video = record
        fa.reset_launch_counts()
        sampler = Wan22Sampler(pipe, DualModelDenoiser(mods["high"],
                                                       mods["low"]),
                               mods["moge"])
        video, pred = sampler.generate_video(
            PROMPT, NEG_PROMPT, image=image, end_image=end,
            camera_params=cams, seed=3, height=height, width=width,
            num_frames=frames, sample_steps=steps,
            stage_callback=stages.append)
        launches = dict(fa.LAUNCHES)
        with torch.no_grad():
            dec = vae_decode_tiled(pipe.vae, seen["latents"])
        paths = Wan22Sampler.export(video, pred,
                                    os.path.join(out_root, str(dev)),
                                    stride=8)
        got = check_outputs(fcfg, seen["latents"],
                            {k: torch.from_numpy(v) for k, v in pred.items()},
                            height, width, frames)
        outs[str(dev)] = {"t": {k: v.float().cpu() for k, v in got.items()},
                          "decode": dec.float().cpu(), "video": video,
                          "launches": launches, "paths": paths,
                          "stages": stages}
        del mods, pipe, sampler, dec
    shutil.rmtree(out_root, ignore_errors=True)
    cpu, card = outs["cpu"], outs[str(device)]
    errs = {k: _rel_l2([card["t"][k]], [cpu["t"][k]]) for k in cpu["t"]}
    errs["decode"] = _rel_l2([card["decode"]], [cpu["decode"]])
    want = expected_launches(fcfg, steps, moge=(mcfg, moge_tokens(
        mcfg, image.shape[:2])))
    say("small_wan22", seconds=f"{time.perf_counter() - t_phase:.2f}",
        tokenizer="transformers-wordlevel", image="example_png",
        end_image="example_png_flipped", stages="|".join(card["stages"]),
        video_file=saved_as(card["paths"]["video"]),
        video_shape="x".join(map(str, card["video"].shape)),
        video_max_level_diff=int(np.abs(card["video"].astype(int)
                                        - cpu["video"].astype(int)).max()),
        device_vs_cpu_rel_l2=json.dumps({k: float(f"{v:.3e}") for k, v in
                                         errs.items()}).replace(" ", ""),
        launches=json.dumps({k: v for k, v in card["launches"].items()
                             if v}).replace(" ", ""))
    if any(cpu["launches"].values()):
        raise AssertionError(f"the CPU run launched {cpu['launches']}")
    if card["launches"] != want:
        raise AssertionError(f"small wan22 launches {card['launches']} != "
                             f"{want}")
    if card["stages"].count("swap") != 1 or "swap" in cpu["stages"]:
        raise AssertionError(f"expert swaps: card {card['stages']}, cpu "
                             f"{cpu['stages']}")
    if card["video"].shape != (frames, height, width, 3):
        raise AssertionError(f"video shape {card['video'].shape}")
    bad = {k: v for k, v in errs.items() if not v <= SLICE_TOL}
    if bad:
        raise AssertionError(f"the reduced Wan2.2 clip disagrees with the "
                             f"CPU path beyond {SLICE_TOL}: {bad}")


def expected_train_launches(cfg, steps, remat=True):
    """Kernel launches of ``steps`` training steps (no heads): per forward
    pass the stats forward of every attention -- DiT self and both bicross
    directions (generic), DiT cross text + CLIP (onekv), VGGT frame + global
    (d64) -- twice under per-block recompute; per backward dq and dk/dv of
    every attention the loss reaches, counted at the head dim its kernel
    runs at. The geometry tokens after the last IRG block feed only the
    heads, which the loss does not run, so the last bicross's
    geometry-side attention gets no gradient and no backward."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    n_x = len(cfg.xattn_set())
    n_dit, n_irg = cfg.dit.num_layers, cfg.num_irg
    passes = steps * (2 if remat else 1)
    out = {k: 0 for k in fa.LAUNCHES}
    out.update(generic_stats=passes * (n_dit + 2 * n_x),
               onekv_stats=passes * 2 * n_dit, d64_stats=passes * 2 * n_irg)
    vggt = cfg.vggt.aggregator.block_cfg
    big = fa.ONEKV_MAX_LK + 1
    for D, n in ((fa.kernel_dim(cfg.dit.num_heads, cfg.dit.head_dim, big),
                  3 * n_dit),
                 (fa.kernel_dim(cfg.bicross.num_heads, cfg.bicross.head_dim,
                                big),
                  2 * n_x - ((n_irg - 1) in cfg.xattn_set())),
                 (fa.kernel_dim(vggt.num_heads, vggt.head_dim, big),
                  2 * n_irg)):
        for k in ("bwd_dq", "bwd_dkv"):
            out[f"{k}_{D}"] += steps * n
    return out


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


def _to(batch, device):
    import torch
    return {k: v if isinstance(v, float) else torch.as_tensor(v,
                                                              device=device)
            for k, v in batch.items()}


def _rel_l2(got, want):
    import torch
    g = torch.cat([t.flatten().double() for t in got])
    w = torch.cat([t.flatten().double() for t in want])
    return ((g - w).norm() / w.norm().clamp_min(1e-30)).item()


def phase_small_train(device):
    """Two LoRA steps and one full fine-tuning step of the reduced model,
    on the card in bf16 (kernels) and on the CPU in f32 (plain versions),
    from the same weights, factors and batches."""
    import torch
    from fantasy_world_tpu_torch.cli.train import _optimizer
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.training.lora import (init_lora, lora_state,
                                                       make_lora_train_step)
    from fantasy_world_tpu_torch.training.step import make_train_step
    fcfg, _ = small_configs()
    batches = train_batches(fcfg.dit, 256, 384, 21, 2, seed=9)
    g = torch.Generator("cpu").manual_seed(7)
    base = build(lambda: FusionModel(fcfg), device="cpu",
                 dtype=torch.float32, generator=g)
    wake_zero_inits(base, g)
    init_lora(base, 4, generator=torch.Generator("cpu").manual_seed(8))
    with torch.no_grad():                 # nonzero up: both factors learn
        for n, t in lora_state(base).items():
            if n.endswith(".up"):
                t.normal_(0.0, 0.02, generator=g)
    sd = base.state_dict()

    def model_on(dev, dtype, lora):
        m = build(lambda: FusionModel(fcfg), device=dev, dtype=dtype)
        if lora:
            init_lora(m, 4, generator=torch.Generator(dev).manual_seed(8))
        m.load_state_dict({k: v for k, v in sd.items()
                           if lora or ".lora." not in k})
        return m

    opt_args = argparse.Namespace(lr=1e-3, warmup=1, weight_decay=1e-4)
    runs = {}
    for dev, dtype in (("cpu", torch.float32), (device, torch.bfloat16)):
        before = dict(fa.LAUNCHES)
        m = model_on(dev, dtype, lora=True)
        state = lora_state(m)
        names = sorted(state)
        opt, sched = _optimizer(opt_args, [state[n] for n in names])
        step = make_lora_train_step(m, opt, sched, remat=True)
        losses, grads = [], []
        for b in batches:
            losses.append(float(step(_to(b, dev))))
            grads.append([state[n].grad.float().cpu() for n in names])
        launches = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        del m, state, opt, sched, step
        # one full fine-tuning step from the same weights, no adapters
        full = model_on(dev, dtype, lora=False)
        params = [p for _, p in sorted(full.named_parameters())]
        opt = torch.optim.AdamW(params, lr=1e-4, eps=1e-8)
        full_loss = float(make_train_step(full, opt, remat=True)(
            _to(batches[0], dev)))
        runs[dev] = {"losses": losses, "grads": grads, "launches": launches,
                     "full_loss": full_loss,
                     "full_grads": [p.grad.float().cpu() for p in params]}
        del full, params, opt
        gc.collect()
    cpu, card = runs["cpu"], runs[device]
    if any(cpu["launches"].values()):
        raise AssertionError(f"the CPU run launched kernels: "
                             f"{cpu['launches']}")
    idle = [k for k, n in card["launches"].items()
            if n == 0 and (k.endswith("_stats") or k.startswith("bwd_"))]
    if idle:
        raise AssertionError(f"reduced training launched no {idle}")
    checks = {f"loss{i}": abs(a - b) / abs(b)
              for i, (a, b) in enumerate(zip(card["losses"], cpu["losses"]))}
    checks.update({f"lora_grads{i}": _rel_l2(a, b) for i, (a, b) in
                   enumerate(zip(card["grads"], cpu["grads"]))})
    checks["full_loss"] = (abs(card["full_loss"] - cpu["full_loss"])
                           / abs(cpu["full_loss"]))
    checks["full_grads"] = _rel_l2(card["full_grads"], cpu["full_grads"])
    say("small_train", losses_card="|".join(f"{x:.5f}" for x in
                                            card["losses"]),
        losses_cpu="|".join(f"{x:.5f}" for x in cpu["losses"]),
        full_loss=f"{card['full_loss']:.5f}|{cpu['full_loss']:.5f}",
        device_vs_cpu_rel=json.dumps({k: float(f"{v:.3e}") for k, v in
                                      checks.items()}).replace(" ", ""),
        launches=json.dumps({k: v for k, v in card["launches"].items()
                             if v}).replace(" ", ""))
    bad = {k: v for k, v in checks.items() if not v <= TRAIN_TOL}
    if bad:
        raise AssertionError(f"reduced training disagrees with the CPU "
                             f"beyond {TRAIN_TOL}: {bad}")


def phase_train_cli():
    """``python -m fantasy_world_tpu_torch.cli.train`` as a user calls it,
    on the card: LoRA rank 4 at the synthetic demo config (dim 128, 2
    blocks), 2 steps with a checkpoint, then a resume to step 3. The demo's
    attentions take the onekv route (DiT, one 128-wide head, 32 to 257
    keys) and the d64 route (VGGT and bicross heads of 8 and 24, padded to
    64)."""
    from fantasy_world_tpu_torch.cli.train import main as train_main
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    routes = ("onekv_stats", "d64_stats", "bwd_dq_64", "bwd_dq_128",
              "bwd_dkv_64", "bwd_dkv_128")
    with tempfile.TemporaryDirectory() as ckpt:
        def argv(steps):
            return ["--synthetic", "--steps", str(steps), "--lora_rank", "4",
                    "--warmup", "1", "--lr", "1e-3", "--log_every", "1",
                    "--checkpoint_dir", ckpt]
        runs = []
        for steps in (2, 3):
            fa.reset_launch_counts()
            loss = train_main(argv(steps))
            runs.append((loss, dict(fa.LAUNCHES)))
        saved = sorted(os.listdir(ckpt))
    say("train_cli", losses="|".join(f"{loss:.5f}" for loss, _ in runs),
        checkpoints="|".join(saved),
        launches="|".join(json.dumps({k: v for k, v in n.items() if v}
                                     ).replace(" ", "") for _, n in runs))
    for (loss, launches), steps in zip(runs, (2, 1)):
        if not (loss is not None and math.isfinite(loss)):
            raise AssertionError(f"train CLI: final loss {loss}")
        idle = [k for k in routes if launches[k] == 0]
        if idle:
            raise AssertionError(f"train CLI ({steps} steps) launched no "
                                 f"{idle}")
    if saved != ["step_00000002", "step_00000003"]:
        raise AssertionError(f"train CLI checkpoints {saved}")


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


def phase_train_cli_data():
    """``python -m fantasy_world_tpu_torch.cli.train --data_root`` as a user
    calls it, on the card at reduced width: ``small_clip_configs``' modules
    written from a seed in the reference layout, a stand-in tokenizer, one
    21-frame 256x384 clip (``write_pan_clip``); LoRA rank 4, 2 steps with a
    checkpoint, then a resume to step 3. Each step builds its batch (the VAE,
    umT5, CLIP on onekv, the pose encoder) and takes one LoRA step: the
    launches of each run are exactly ``steps`` x (CLIP's + one step's)."""
    import shutil
    from fantasy_world_tpu_torch.cli.train import main as train_main
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    fcfg, _, t5c, clipc, _ = small_clip_configs()
    root = os.path.join(REPO, "build", "train_cli_data")
    shutil.rmtree(root, ignore_errors=True)
    wan, model = write_reference_layout(root)
    tok = os.path.join(root, "tokenizer")
    write_tokenizer(t5c.vocab, tok)
    clips = os.path.join(root, "clips")
    write_pan_clip(os.path.join(clips, "pan"), 256, 384, 21)
    ckpt = os.path.join(root, "ckpt")
    write_s = time.perf_counter() - t0

    def argv(steps):
        return ["--data_root", clips, "--wan_ckpt_path", wan,
                "--model_ckpt", model, "--tokenizer_path", tok,
                "--lora_rank", "4", "--steps", str(steps), "--height", "256",
                "--width", "384", "--frames", "21", "--warmup", "1",
                "--lr", "1e-3", "--log_every", "1", "--checkpoint_dir", ckpt]
    runs = []
    for steps, ran in ((2, 2), (3, 1)):
        fa.reset_launch_counts()
        loss = train_main(argv(steps))
        launches = dict(fa.LAUNCHES)
        want = _add(expected_train_launches(fcfg, ran),
                    *[encoder_launches(clip=clipc)] * ran)
        runs.append((loss, launches, want))
    saved = sorted(os.listdir(ckpt))
    shutil.rmtree(root, ignore_errors=True)
    say("train_cli_data", seconds=f"{time.perf_counter() - t0:.2f}",
        write_layout_s=f"{write_s:.2f}", image="example_png_pan",
        tokenizer="transformers-wordlevel",
        losses="|".join(f"{loss:.5f}" for loss, _, _ in runs),
        checkpoints="|".join(saved),
        launches="|".join(json.dumps({k: v for k, v in n.items() if v}
                                     ).replace(" ", "") for _, n, _ in runs))
    for loss, launches, want in runs:
        if not (loss is not None and math.isfinite(loss)):
            raise AssertionError(f"train CLI on data: final loss {loss}")
        if launches != want:
            raise AssertionError(f"train CLI on data: launches {launches} "
                                 f"!= {want}")
    if saved != ["step_00000002", "step_00000003"]:
        raise AssertionError(f"train CLI on data: checkpoints {saved}")


def phase_full_slice(device, steps=3, seed=1024, profile_dir=None):
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

    def run(progress):
        return pipe.denoise(*cond[:4], height, width, num_frames=frames,
                            num_inference_steps=steps, seed=seed,
                            plucker_fea=plucker_fea,
                            progress_callback=progress)

    # the launch counts after each step: the second step (index 1, between
    # the first with its set-up and the last with the heads) gives the
    # launches per denoise step
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    counts = []

    def progress(i, n):
        events[i].record()
        counts.append(dict(fa.LAUNCHES))

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    events[0].record()
    counts.append(dict(fa.LAUNCHES))
    lat, pred = run(progress)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    step_s = [events[i].elapsed_time(events[i + 1]) / 1e3
              for i in range(steps)]
    per_step = {k: counts[2][k] - counts[1][k] for k in fa.LAUNCHES}
    layers = layers_per_step(cfg)
    configured = {k: sum(layers[name] for name, _, _, r in SHAPES if r == k)
                  for k in fa.ROUTES}
    got = check_outputs(cfg, lat, pred, height, width, frames)
    want = expected_launches(cfg, steps)
    say("full_slice", steps=steps, step_seconds="|".join(
        f"{s:.3f}" for s in step_s), wall_seconds=f"{wall:.2f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        launches=json.dumps(launches).replace(" ", ""),
        launches_per_step=json.dumps({k: v for k, v in per_step.items()
                                      if v}).replace(" ", ""),
        shapes=json.dumps({k: list(v.shape) for k, v in got.items()}
                          ).replace(" ", ""))
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if any(per_step[k] != configured[k] for k in fa.ROUTES):
        raise AssertionError(f"launches in one step {per_step} != the "
                             f"configuration's layers {configured}")
    del lat, pred, got
    if profile_dir:
        # the same steps of a second run, the profiler started and stopped
        # from the callback: the second step, and the last with the heads;
        # the unprofiled steps above are their yardsticks
        mid = ProfiledStep("denoise", step_s[1], profile_dir)
        heads = ProfiledStep("denoise_heads", step_s[2], profile_dir)
        marks = {1: (mid.begin,), 2: (mid.end, heads.begin), 3: (heads.end,)}

        def profiled(i, n):
            for mark in marks.get(i, ()):
                mark()
        run(profiled)
        mid.report()
        heads.report()
    return launches, per_step, pipe, cond, plucker_fea


def phase_full_clip(device, pipe, steps=2, seed=1024):
    """The whole clip at full width on the fusion model and pose encoder of
    ``phase_full_slice``: umT5-XXL, CLIP ViT-H, the Wan VAE and MoGe-2
    built on the card from a seed, then ``generate_video`` at 336x592, 81
    frames, ``steps`` steps (the heads on the last), and ``export``. Prints
    each stage's seconds (CUDA events) and peak GB, the launches, the
    output shapes and that every output is finite. Returns the launches,
    the clip's pipeline and MoGe, which the serve phase uses."""
    import shutil
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.moge.model import MoGe, MoGeConfig
    from fantasy_world_tpu_torch.models.wan.clip import (CLIPVision,
                                                         CLIPVisionConfig)
    from fantasy_world_tpu_torch.models.wan.t5 import T5Config, T5Encoder
    from fantasy_world_tpu_torch.models.wan.vae import VAEConfig, WanVAE
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    from fantasy_world_tpu_torch.sampler import FantasyWorldSampler
    cfg = pipe.cfg
    height, width, frames = 336, 592, 81
    t_phase = t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed + 2)
    enc = {"t5": build(lambda: T5Encoder(T5Config()), device=device,
                       dtype=torch.bfloat16, generator=g),
           "clip": build(lambda: CLIPVision(CLIPVisionConfig()),
                         device=device, dtype=torch.bfloat16, generator=g),
           "vae": build(lambda: WanVAE(VAEConfig()), device=device,
                        dtype=torch.bfloat16, generator=g)}
    moge = build(lambda: MoGe(MoGeConfig()), device=device,
                 dtype=torch.bfloat16, generator=g)
    torch.cuda.synchronize()
    say("full_clip_build", seconds=f"{time.perf_counter() - t0:.2f}",
        **{f"{n}_params": sum(p.numel() for p in m.parameters())
           for n, m in dict(enc, moge=moge).items()},
        weights_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}")
    cpipe = FantasyWorldPipeline(pipe.fusion, pipe.pose_encoder, **enc)
    out_dir = os.path.join(REPO, "build", "clip_export", "full")
    tok = install_tokenizer(cpipe, T5Config().vocab,
                            os.path.join(out_dir, "tokenizer"))
    t0 = time.perf_counter()
    cpipe.tokenize(PROMPT)            # the tokenizer loads on first use
    tokenizer_load_s = time.perf_counter() - t0
    image, cams = clip_inputs(height, width, frames)
    marks = []

    def mark(name, *_):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event, torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    mark("start")
    video, pred = FantasyWorldSampler(cpipe, moge=moge).generate_video(
        PROMPT, NEG_PROMPT, image=image, camera_params=cams,
        using_scale=True, seed=seed, height=height, width=width,
        num_frames=frames, sample_steps=steps, stage_callback=mark,
        progress_callback=lambda i, n: mark(f"denoise_step{i}"))
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    stage_s = {name: marks[i - 1][1].elapsed_time(ev) / 1e3
               for i, (name, ev, _) in enumerate(marks) if i}
    peak_gb = {name: peak / 1e9 for name, _, peak in marks[1:]}
    t0 = time.perf_counter()
    paths = FantasyWorldSampler.export(video, pred, out_dir)
    stage_s["export"] = time.perf_counter() - t0
    want_shapes = expected_shapes(cfg, height, width, frames)
    shapes = {"video": list(video.shape), **{k: list(v.shape)
                                             for k, v in pred.items()}}
    finite = all(np.isfinite(v).all() for v in pred.values())
    ply_bytes = os.path.getsize(paths["ply"])
    shutil.rmtree(os.path.dirname(out_dir), ignore_errors=True)
    mid = [stage_s[f"denoise_step{i}"] for i in range(1, steps)]
    fixed = sum(v for k, v in stage_s.items() if not k.startswith("denoise"))
    reckoned = fixed + 49 * float(np.mean(mid)) + stage_s[
        f"denoise_step{steps}"]
    want = expected_launches(cfg, steps, clip=CLIPVisionConfig(), moge=(
        MoGeConfig(), moge_tokens(MoGeConfig(), image.shape[:2])))
    say("full_clip", seconds=f"{time.perf_counter() - t_phase:.2f}",
        steps=steps, tokenizer=tok, image="example_png",
        tokenizer_load_s=f"{tokenizer_load_s:.2f}",
        video_file=saved_as(paths["video"]), ply_bytes=ply_bytes,
        stage_seconds=json.dumps({k: round(v, 3) for k, v in
                                  stage_s.items()}).replace(" ", ""),
        stage_peak_gb=json.dumps({k: round(v, 2) for k, v in
                                  peak_gb.items()}).replace(" ", ""),
        reckoned_50_step_clip_s=f"{reckoned:.1f}",
        launches=json.dumps({k: v for k, v in launches.items() if v}
                            ).replace(" ", ""),
        clip_onekv_launches=CLIPVisionConfig().num_layers - 1,
        moge_d64_launches=MoGeConfig().encoder.depth,
        moge_tokens=moge_tokens(MoGeConfig(), image.shape[:2]),
        shapes=json.dumps(shapes).replace(" ", ""), finite=finite)
    if video.shape != (frames, height, width, 3) or video.dtype != np.uint8:
        raise AssertionError(f"video {video.shape} {video.dtype}")
    for key, shape in want_shapes.items():
        if key != "latents" and tuple(pred[key].shape) != shape:
            raise AssertionError(f"{key}: shape {pred[key].shape} != {shape}")
    if not finite:
        raise AssertionError("the full clip's prediction is not finite")
    if launches != want:
        raise AssertionError(f"full clip launches {launches} != {want}")
    if "moge" not in stage_s:
        raise AssertionError("the full clip ran no MoGe stage")
    return launches, cpipe, moge


def host_available_gb() -> float:
    """MemAvailable of /proc/meminfo, in GB."""
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def phase_full_wan22(device, shared, quant_profile_dir, steps=2, seed=1024,
                     profile_dir=None):
    """The Wan2.2-Fun-A14B-Control-Camera clip at full width and depth:
    two experts of ``wan22_fusion_config()`` and MoGe-2 built from a seed,
    the low expert moved to pinned host memory, umT5 and the VAE of the
    Wan2.1 clip shared; ``Wan22Sampler.generate_video`` at 480x832, 81
    frames, ``steps`` steps (2: t = 1000 on the high expert, t ~ 833 on
    the low one, swapped in, with the heads), tiled VAE encode and decode,
    and ``export``. Prints each stage's seconds and peak GB, the launches,
    the output shapes and that every output is finite. With
    ``profile_dir``, the clip runs again with its two steps under the
    profiler, started and stopped from the sampler's callbacks. Then
    ``phase_full_quant`` on the expert left on the card (its profile into
    ``quant_profile_dir``)."""
    import shutil
    import torch
    from fantasy_world_tpu_torch.convert.checkpoint import wan22_fusion_config
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.moge.model import MoGe, MoGeConfig
    from fantasy_world_tpu_torch.models.wan.t5 import T5Config
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    from fantasy_world_tpu_torch.pipelines.wan_video_22 import (
        DualModelDenoiser, pin_to_host)
    from fantasy_world_tpu_torch.sampler import Wan22Sampler
    cfg = wan22_fusion_config()
    height, width, frames = 480, 832, 81
    t_phase = t0 = time.perf_counter()
    host_gb = host_available_gb()
    g = torch.Generator(device=device).manual_seed(seed + 3)

    def expert():
        m = build(lambda: FusionModel(cfg), device=device,
                  dtype=torch.bfloat16, generator=g)
        wake_zero_inits(m, g)
        return m
    low = expert()
    torch.cuda.synchronize()
    t_pin = time.perf_counter()
    pin_to_host(low)
    pin_s = time.perf_counter() - t_pin
    high = expert()
    moge = build(lambda: MoGe(MoGeConfig()), device=device,
                 dtype=torch.bfloat16, generator=g)
    torch.cuda.synchronize()
    say("full_wan22_build", seconds=f"{time.perf_counter() - t0:.2f}",
        host_available_gb_before=f"{host_gb:.1f}",
        host_available_gb_after=f"{host_available_gb():.1f}",
        expert_params=sum(p.numel() for p in high.parameters()),
        pin_low_expert_s=f"{pin_s:.2f}",
        weights_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}")
    pipe = FantasyWorldPipeline(t5=shared["t5"], vae=shared["vae"])
    out_dir = os.path.join(REPO, "build", "wan22_export", "full")
    install_tokenizer(pipe, T5Config().vocab, os.path.join(out_dir, "tok"))
    pipe.tokenize(PROMPT)             # the tokenizer loads on first use
    image, cams = clip_inputs(height, width, frames)
    den = DualModelDenoiser(high, low)
    marks = []

    def mark(name, *_):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event, torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    mark("start")
    video, pred = Wan22Sampler(pipe, den, moge).generate_video(
        PROMPT, NEG_PROMPT, image=image, camera_params=cams, seed=seed,
        height=height, width=width, num_frames=frames, sample_steps=steps,
        stage_callback=mark,
        progress_callback=lambda i, n: mark(f"denoise_step{i}"))
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    stage_s = {name: marks[i - 1][1].elapsed_time(ev) / 1e3
               for i, (name, ev, _) in enumerate(marks) if i}
    peak_gb = {name: peak / 1e9 for name, _, peak in marks[1:]}
    t0 = time.perf_counter()
    paths = Wan22Sampler.export(video, pred, out_dir, conf_threshold=1.5)
    stage_s["export"] = time.perf_counter() - t0
    shapes = {"video": list(video.shape), **{k: list(v.shape)
                                             for k, v in pred.items()}}
    finite = all(np.isfinite(v).all() for v in pred.values())
    ply_bytes = os.path.getsize(paths["ply"])
    shutil.rmtree(os.path.dirname(out_dir), ignore_errors=True)
    mid = [stage_s[f"denoise_step{i}"] for i in range(1, steps)]
    fixed = sum(v for k, v in stage_s.items() if not k.startswith("denoise"))
    reckoned = fixed + 49 * float(np.mean(mid)) + stage_s[
        f"denoise_step{steps}"]
    tokens = moge_tokens(MoGeConfig(), image.shape[:2])
    want = expected_launches(cfg, steps, moge=(MoGeConfig(), tokens))
    on_card = {h: str(den._device_of(m)) for h, m in den.experts.items()}
    say("full_wan22", seconds=f"{time.perf_counter() - t_phase:.2f}",
        steps=steps, tokenizer="transformers-wordlevel", image="example_png",
        video_file=saved_as(paths["video"]), ply_bytes=ply_bytes,
        stage_seconds=json.dumps({k: round(v, 3) for k, v in
                                  stage_s.items()}).replace(" ", ""),
        stage_peak_gb=json.dumps({k: round(v, 2) for k, v in
                                  peak_gb.items()}).replace(" ", ""),
        reckoned_50_step_clip_s=f"{reckoned:.1f}",
        expert_devices=f"high:{on_card[True]}|low:{on_card[False]}",
        launches=json.dumps({k: v for k, v in launches.items() if v}
                            ).replace(" ", ""),
        moge_tokens=tokens, shapes=json.dumps(shapes).replace(" ", ""),
        finite=finite)
    if video.shape != (frames, height, width, 3) or video.dtype != np.uint8:
        raise AssertionError(f"video {video.shape} {video.dtype}")
    for key, shape in expected_shapes(cfg, height, width, frames).items():
        if key != "latents" and tuple(pred[key].shape) != shape:
            raise AssertionError(f"{key}: shape {pred[key].shape} != {shape}")
    if not finite:
        raise AssertionError("the Wan2.2 clip's prediction is not finite")
    if launches != want:
        raise AssertionError(f"Wan2.2 clip launches {launches} != {want}")
    if list(stage_s).count("swap") != 1 or on_card[True] != "cpu" \
            or on_card[False] == "cpu":
        raise AssertionError(f"expert swap: stages {list(stage_s)}, "
                             f"devices {on_card}")
    if profile_dir:
        # each step from right after its expert's control tokens to its
        # progress callback; the unprofiled steps above are the yardsticks
        prof = {True: ProfiledStep("wan22_denoise", stage_s["denoise_step1"],
                                   profile_dir),
                False: ProfiledStep("wan22_denoise_heads",
                                    stage_s["denoise_step2"], profile_dir)}
        begin = {"control_adapter_high": prof[True].begin,
                 "control_adapter_low": prof[False].begin}
        Wan22Sampler(pipe, den, moge).generate_video(
            PROMPT, NEG_PROMPT, image=image, camera_params=cams, seed=seed,
            height=height, width=width, num_frames=frames, sample_steps=steps,
            stage_callback=lambda name: begin.get(name, lambda: None)(),
            progress_callback=lambda i, n: prof[i == 1].end())
        for p in prof.values():
            p.report()
    quant = phase_full_quant(device, den, quant_profile_dir)
    del den, high, low, moge, pipe, video, pred
    gc.collect()
    torch.cuda.empty_cache()
    return launches, quant


# ---------------------------------------------------------------------------
# the serving path: quantization, TeaCache, the segmented and resumable
# denoise, the job server
# ---------------------------------------------------------------------------

# the DiT's linears at the full Wan2.1 step: the CFG pair of 16,317 video
# tokens through q/k/v/o (5120 -> 5120), the FFN in (5120 -> 13824) and out
QLINEAR_ROWS = 2 * 16317
QLINEAR_SHAPES = (("dit_qkvo", 5120, 5120), ("dit_ffn_in", 5120, 13824),
                  ("dit_ffn_out", 13824, 5120))
# the dense int8 tensor-core peak of one H100 SXM
PEAK_INT8_OPS = 1979e12
# the reduced serving runs quantize every linear at least this wide (the
# production default of 1024 would leave the reduced widths in bf16)
SMALL_QUANT_MIN_DIM = 128


def qlinear_bound(rows, k, n, mode):
    """The least time of one quantized linear: its multiply-adds at the
    int8 (int8) or bf16 (fp8, dequantized; and bf16 itself) peak, against
    its bytes: bf16 x and y, the weight in its storage type."""
    flop = 2 * rows * k * n
    w_bytes = k * n * (2 if mode == "bf16" else 1)
    nbytes = 2 * rows * k + w_bytes + 2 * rows * n
    t_ops = flop / (PEAK_INT8_OPS if mode == "int8" else PEAK_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_qlinear(device):
    """int8 and fp8 ``qlinear`` at the production shapes against the same
    arithmetic reckoned in f32 (int8: the activations quantized as qlinear
    does, the integer product in f32; fp8: the dequantized weight), within
    two bf16 ulps of the largest output; the times of int8 qlinear, its
    three parts (activation quant, ``torch._int_mm``, rescale), fp8 qlinear
    and the bf16 ``F.linear``, beside their bounds."""
    import torch
    import torch.nn.functional as F
    from fantasy_world_tpu_torch.core import quant
    g = torch.Generator(device).manual_seed(21)
    out = {}
    for name, k, n in QLINEAR_SHAPES:
        x = torch.randn((QLINEAR_ROWS, k), generator=g, device=device,
                        dtype=torch.bfloat16)
        lin = torch.nn.Linear(k, n, device=device, dtype=torch.bfloat16)
        with torch.no_grad():
            lin.weight.uniform_(-k ** -0.5, k ** -0.5, generator=g)
            lin.bias.uniform_(-k ** -0.5, k ** -0.5, generator=g)
        q8 = quant.QuantLinear.from_linear(lin, "int8")
        f8 = quant.QuantLinear.from_linear(lin, "fp8")
        with torch.no_grad():
            got8 = quant.qlinear(x, q8)
            xq, sx = quant.quantize_activations(x)
            ref8 = ((xq.float() @ q8.weight.float().t()) * sx * q8.kscale
                    + lin.bias.float())
            del xq
            err8, tol8 = _max_err(got8, ref8), out_tol(ref8)
            del got8, ref8
            gotf = quant.qlinear(x, f8)
            wf = (f8.weight.float() * f8.kscale[:, None]).to(x.dtype)
            reff = F.linear(x.float(), wf.float(), lin.bias.float())
            errf, tolf = _max_err(gotf, reff), out_tol(reff)
            del gotf, reff, wf
            xq, sx = quant.quantize_activations(x)
            y32 = quant.int_mm(xq, q8.weight)
            ms = {"int8_ms": time_ms(lambda: quant.qlinear(x, q8), 5),
                  "act_quant_ms": time_ms(
                      lambda: quant.quantize_activations(x), 5),
                  "int_mm_ms": time_ms(lambda: quant.int_mm(xq, q8.weight),
                                       5),
                  "rescale_ms": time_ms(
                      lambda: quant.rescale(y32, sx, q8, x.dtype), 5),
                  "fp8_ms": time_ms(lambda: quant.qlinear(x, f8), 5),
                  "bf16_ms": time_ms(
                      lambda: F.linear(x, lin.weight, lin.bias), 5)}
            del xq, sx, y32
        bounds = {m: qlinear_bound(QLINEAR_ROWS, k, n, m)
                  for m in ("int8", "fp8", "bf16")}
        out[name] = dict(ms, int8_err=err8, int8_tol=tol8, fp8_err=errf,
                         fp8_tol=tolf)
        say("qlinear", shape=f"{QLINEAR_ROWS}x{k}->{n}",
            **{kk: f"{v:.3f}" for kk, v in ms.items()},
            **{f"{m}_bound_ms": f"{b:.3f}" for m, (b, _) in bounds.items()},
            int8_bound_by=bounds["int8"][1],
            glue_share=f"{(ms['act_quant_ms'] + ms['rescale_ms']) / ms['int8_ms']:.3f}",
            int8_max_abs_err=f"{err8:.3e}", int8_tol=f"{tol8:.3e}",
            fp8_max_abs_err=f"{errf:.3e}", fp8_tol=f"{tolf:.3e}")
        if not (err8 <= tol8 and errf <= tolf):
            raise AssertionError(f"qlinear {name}: int8 {err8} (bound "
                                 f"{tol8}), fp8 {errf} (bound {tolf})")
        del x, lin, q8, f8
        torch.cuda.empty_cache()
    return out


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


class _Cut(Exception):
    """Raised from a progress callback to cut a run after a segment."""


def _cut_after_first(done, total):
    raise _Cut


def phase_small_serve(device):
    """The serving options at reduced widths, on the card in bf16 against
    the CPU in f32 from the same weights, each within SLICE_TOL (relative
    L2 of the latents and the prediction): the Wan2.1 denoise with its
    model quantized to int8 and to fp8 (each quantized where it runs), and
    with TeaCache, cut after its first segment and resumed from the partial
    state (the CPU run unsegmented; the card's plan and the CPU's equal);
    the Wan2.2 dual-expert denoise with both experts quantized to int8 on
    the card and the low one then pinned in host memory (``place_expert``,
    in ``load_wan22``'s order), the dual plan, cut at the expert boundary and resumed there, the low expert
    swapped in. Each cut run runs segments of two steps and is cut after
    the first; the resumed run, in segments of one, reports its start."""
    import shutil
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines import tea_cache as tc
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    from fantasy_world_tpu_torch.core.quant import count_quantized
    from fantasy_world_tpu_torch.pipelines.wan_video_22 import (
        DualModelDenoiser, place_expert)
    from fantasy_world_tpu_torch.schedulers.flow_match import (
        FlowMatchScheduler)
    t_phase = time.perf_counter()
    fcfg, pcfg = small_configs()
    height, width, frames, steps = 128, 192, 9, 4
    ts = FlowMatchScheduler().set_timesteps(steps).timesteps
    g = torch.Generator("cpu").manual_seed(17)
    cpu_f = build(lambda: FusionModel(fcfg), device="cpu",
                  dtype=torch.float32, generator=g)
    wake_zero_inits(cpu_f, g)
    cpu_p = build(lambda: CameraPoseEncoder(pcfg), device="cpu",
                  dtype=torch.float32, generator=g)
    cond = conditioning(fcfg.dit, height, width, frames,
                        torch.Generator("cpu").manual_seed(18), 16)
    work = os.path.join(REPO, "build", "serve_small")
    os.makedirs(work, exist_ok=True)

    def pipe_on(dev, quant=None):
        dtype = torch.float32 if dev == "cpu" else torch.bfloat16
        fus = build(lambda: FusionModel(fcfg), device=dev, dtype=dtype)
        fus.load_state_dict(cpu_f.state_dict())
        pose = build(lambda: CameraPoseEncoder(pcfg), device=dev,
                     dtype=dtype)
        pose.load_state_dict(cpu_p.state_dict())
        pipe = FantasyWorldPipeline(fus, pose)
        n = pipe.quantize(quant, min_dim=SMALL_QUANT_MIN_DIM) if quant else 0
        return pipe, n

    def denoise(pipe, **kw):
        lat, pred = pipe.denoise(*cond[:4], height, width, num_frames=frames,
                                 num_inference_steps=steps, seed=3,
                                 plucker_fea=pipe.encode_plucker(cond[4]),
                                 **kw)
        return [lat.float().cpu()] + [pred[k].float().cpu()
                                      for k in sorted(pred)]

    errs, fields = {}, {}
    before = dict(fa.LAUNCHES)
    for mode in ("int8", "fp8"):
        (cpu, n_cpu), (card, n_card) = pipe_on("cpu", mode), pipe_on(
            device, mode)
        if n_cpu != n_card or n_card == 0:
            raise AssertionError(f"{mode}: {n_cpu} CPU and {n_card} card "
                                 f"layers quantized")
        errs[mode] = _rel_l2(denoise(card), denoise(cpu))
        fields[f"{mode}_layers"] = n_card
        del cpu, card
    # TeaCache, segmented, cut after the first segment and resumed
    (cpu, _), (card, _) = pipe_on("cpu"), pipe_on(device)
    thresh, plan_cpu = tea_threshold(cpu.fusion.dit, steps)
    plan_card = tc.compute_skip_schedule(card.fusion.dit, ts, thresh)
    path = os.path.join(work, "wan21_partial.npz")
    try:
        denoise(card, tea_cache_l1_thresh=thresh, segment_size=2,
                gen_ckpt_path=path, progress_callback=_cut_after_first)
        raise AssertionError("the cut run was not cut")
    except _Cut:
        pass
    calls = []
    got = denoise(card, tea_cache_l1_thresh=thresh, segment_size=1,
                  gen_ckpt_path=path,
                  progress_callback=lambda *a: calls.append(a))
    errs["tea_resumed"] = _rel_l2(got, denoise(cpu,
                                               tea_cache_l1_thresh=thresh))
    fields.update(tea_thresh=f"{thresh:.6g}",
                  plan_card="".join("s" if s else "c" for s in plan_card),
                  plan_cpu="".join("s" if s else "c" for s in plan_cpu),
                  resumed_progress="|".join(f"{a}/{b}" for a, b in calls))
    if list(plan_card) != list(plan_cpu) or not plan_card.any():
        raise AssertionError(f"TeaCache plans: card {plan_card}, cpu "
                             f"{plan_cpu}")
    # resumed at step 2: reported first, then each step
    if calls != [(i, steps) for i in range(2, steps + 1)] \
            or os.path.exists(path):
        raise AssertionError(f"resumed progress {calls}; partial state "
                             f"left: {os.path.exists(path)}")
    del cpu, card
    # at these sizes every attention takes onekv or d64
    ran = {k: fa.LAUNCHES[k] - before[k] for k in fa.ROUTES}
    if not ran["onekv"] or not ran["d64"]:
        raise AssertionError(f"the reduced serving runs launched {ran}")

    # Wan2.2: int8 experts, the low one pinned and swapped in; TeaCache's
    # dual plan; cut after the first segment and resumed
    wcfg = small_wan22_configs()[0]
    experts = {}
    for high in (True, False):
        experts[high] = build(lambda: FusionModel(wcfg), device="cpu",
                              dtype=torch.float32, generator=g)
        wake_zero_inits(experts[high], g)
    rng = torch.Generator("cpu").manual_seed(19)
    f = (frames - 1) // 4 + 1
    ctx = [torch.randn((1, 16, wcfg.dit.text_dim), generator=rng)
           for _ in range(2)]
    y = torch.randn((1, wcfg.dit.in_dim - wcfg.dit.out_dim, f, height // 8,
                     width // 8), generator=rng)
    ctrl = torch.randn((1, 24, f, height, width), generator=rng).numpy()
    dens = {}
    # the card's copies first: the CPU's quantize the float weights in place.
    # Each expert is built, loaded, quantized on the card and (the low one)
    # pinned in the order ``load_wan22`` takes
    for dev in (device, "cpu"):
        dtype = torch.float32 if dev == "cpu" else torch.bfloat16
        mods = {}
        for high, w in experts.items():
            on_card = high or dev == "cpu"
            model = w
            if dev != "cpu":
                model = build(lambda: FusionModel(wcfg),
                              device=dev if on_card else "cpu", dtype=dtype)
                model.load_state_dict(w.state_dict())
            mods[high] = place_expert(model, dev, on_host=not on_card,
                                      quant="int8",
                                      min_dim=SMALL_QUANT_MIN_DIM)
        counts = {count_quantized(m) for m in mods.values()}
        if len(counts) != 1:
            raise AssertionError(f"the experts quantized differently: "
                                 f"{counts}")
        fields[f"wan22_int8_layers_{'cpu' if dev == 'cpu' else 'card'}"] = \
            counts.pop()
        dens["cpu" if dev == "cpu" else "card"] = DualModelDenoiser(
            mods[True], mods[False])
    n_high = int((ts > dens["card"].timestep_boundary).sum())
    plan22_cpu = tc.compute_skip_schedule_dual(
        dens["cpu"].experts[True].dit, dens["cpu"].experts[False].dit, ts,
        n_high, thresh)
    plan22_card = tc.compute_skip_schedule_dual(
        dens["card"].experts[True].dit, dens["card"].experts[False].dit, ts,
        n_high, thresh, device=device)

    def denoise22(den, **kw):
        lat, pred = den.denoise(ctx[0], ctx[1], y, height, width,
                                num_frames=frames, num_inference_steps=steps,
                                seed=5, control_camera_latents=ctrl,
                                tea_cache_l1_thresh=thresh, **kw)
        return [lat.float().cpu()] + [pred[k].float().cpu()
                                      for k in sorted(pred)]
    path = os.path.join(work, "wan22_partial.npz")
    stages, calls = [], []
    try:
        denoise22(dens["card"], segment_size=2, gen_ckpt_path=path,
                  progress_callback=_cut_after_first)
        raise AssertionError("the cut Wan2.2 run was not cut")
    except _Cut:
        pass
    got = denoise22(dens["card"], segment_size=1, gen_ckpt_path=path,
                    progress_callback=lambda *a: calls.append(a),
                    stage_callback=stages.append)
    errs["wan22_int8_tea_resumed"] = _rel_l2(got, denoise22(dens["cpu"]))
    fields.update(
        wan22_plan_card="".join("s" if s else "c" for s in plan22_card),
        wan22_plan_cpu="".join("s" if s else "c" for s in plan22_cpu),
        wan22_stages="|".join(stages),
        wan22_resumed_progress="|".join(f"{a}/{b}" for a, b in calls))
    shutil.rmtree(work, ignore_errors=True)
    say("small_serve", seconds=f"{time.perf_counter() - t_phase:.2f}",
        min_dim=SMALL_QUANT_MIN_DIM, **fields,
        device_vs_cpu_rel_l2=json.dumps({k: float(f"{v:.3e}") for k, v in
                                         errs.items()}).replace(" ", ""))
    if list(plan22_card) != list(plan22_cpu):
        raise AssertionError(f"Wan2.2 TeaCache plans: card {plan22_card}, "
                             f"cpu {plan22_cpu}")
    # resumed at the boundary (step 2): the low expert swapped in
    if stages != ["swap", "control_adapter_low"] \
            or calls != [(i, steps) for i in range(2, steps + 1)]:
        raise AssertionError(f"Wan2.2 resumed run: stages {stages}, "
                             f"progress {calls}")
    bad = {k: v for k, v in errs.items() if not v <= SLICE_TOL}
    if bad:
        raise AssertionError(f"the reduced serving runs disagree with the "
                             f"CPU path beyond {SLICE_TOL}: {bad}")


def _add(*counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def phase_full_serve(device, cpipe, moge, seed=1024,
                     geometry=(336, 592, 81)):
    """An in-process ``GenerationServer`` on 127.0.0.1:0 over the full-width,
    full-depth Wan2.1 sampler of the clip (umT5-XXL, CLIP ViT-H, the VAE,
    MoGe-2), with the serve CLI's batch function in segments of one step:
    two same-key jobs (2 steps) batched as B = 2, then one TeaCache job (4
    steps, a plan that skips), posted over HTTP and polled to ``done``.
    Prints each batch's seconds, peak GB and launches, the plan, the
    progress seen; checks the exported outputs' shapes, that they are
    finite, and the exact launches. Frees CLIP and MoGe after; returns the
    launches and {"t5", "vae"}, which the Wan2.2 clip shares."""
    import shutil
    import urllib.request
    import torch
    from fantasy_world_tpu_torch.cli.serve import (make_batch_fn,
                                                   make_validate_fn)
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.sampler import (FantasyWorldSampler,
                                                 read_image)
    from fantasy_world_tpu_torch.serving.server import GenerationServer
    cfg = cpipe.cfg
    (height, width, frames), steps, tea_steps = geometry, 2, 4
    t_phase = time.perf_counter()
    out_root = os.path.join(REPO, "build", "serve_export")
    thresh, plan = tea_threshold(cpipe.fusion.dit, tea_steps)
    sampler = FantasyWorldSampler(cpipe, moge=moge)
    exported = {}
    export = sampler.export

    def recording_export(video, pred, out_dir, **kw):
        exported[os.path.basename(out_dir)] = (
            video.shape, video.dtype, {k: v.shape for k, v in pred.items()},
            bool(all(np.isfinite(v).all() for v in pred.values())))
        return export(video, pred, out_dir, **kw)
    sampler.export = recording_export
    args = argparse.Namespace(segment_size=1, output_root=out_root,
                              io_root=REPO)
    inner = make_batch_fn(sampler, args)
    batches = []

    def batch_fn(jobs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before, t0 = dict(fa.LAUNCHES), time.perf_counter()
        out = inner(jobs)
        torch.cuda.synchronize()
        batches.append({"jobs": len(jobs),
                        "steps": jobs[0].request["sample_steps"],
                        "seconds": time.perf_counter() - t0,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "launches": {k: fa.LAUNCHES[k] - before[k]
                                     for k in fa.LAUNCHES}})
        return out

    server = GenerationServer(batch_fn, host="127.0.0.1", port=0,
                              max_batch=SERVE_CLIPS, linger_s=1.0,
                              validate_fn=make_validate_fn(args))
    url = f"http://127.0.0.1:{server.port}"

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        with urllib.request.urlopen(urllib.request.Request(
                url + path, data=data), timeout=30) as r:
            return json.loads(r.read())

    job = {"image_path": EXAMPLE_IMAGE,
           "camera_json": os.path.join(REPO, "examples", "cameras",
                                       "camera_data.json"),
           "height": height, "width": width, "num_frames": frames,
           "neg_prompt": NEG_PROMPT}
    requests = [dict(job, prompt=PROMPT, seed=seed, sample_steps=steps),
                dict(job, prompt="a lighthouse on a cliff at dusk",
                     seed=seed + 1, sample_steps=steps),
                dict(job, prompt=PROMPT, seed=seed + 2,
                     sample_steps=tea_steps, tea_cache_l1_thresh=thresh)]
    gc.collect()
    torch.cuda.empty_cache()
    server.start()
    try:
        fa.reset_launch_counts()
        ids = [call("/v1/generate", r)["job_id"] for r in requests]
        seen = {i: [] for i in ids}
        status = {}
        deadline = time.time() + 600
        while time.time() < deadline:
            status = {i: call(f"/v1/jobs/{i}") for i in ids}
            for i, body in status.items():
                mark = body["status"] + (
                    "@{done}/{total}".format(**body["progress"])
                    if body.get("progress") else "")
                if not seen[i] or seen[i][-1] != mark:
                    seen[i].append(mark)
            if all(b["status"] in ("done", "error") for b in
                   status.values()):
                break
            time.sleep(0.2)
        launches = dict(fa.LAUNCHES)
    finally:
        server.shutdown()
    shutil.rmtree(out_root, ignore_errors=True)
    clip_cfg, mcfg = cpipe.clip.cfg, moge.cfg
    # MoGe sees the image as it is on disk
    moge = (mcfg, moge_tokens(mcfg, read_image(EXAMPLE_IMAGE).shape[:2]))
    want = _add(expected_launches(cfg, steps, clip=clip_cfg, moge=moge),
                encoder_launches(clip_cfg, moge),
                expected_launches(cfg, tea_steps, clip=clip_cfg, moge=moge,
                                  skipped=int(plan.sum())))
    say("full_serve", seconds=f"{time.perf_counter() - t_phase:.2f}",
        batches=len(batches),
        batch_jobs="|".join(str(b["jobs"]) for b in batches),
        batch_steps="|".join(str(b["steps"]) for b in batches),
        batch_seconds="|".join(f"{b['seconds']:.2f}" for b in batches),
        batch_peak_gb="|".join(f"{b['peak_gb']:.2f}" for b in batches),
        batch_launches="|".join(json.dumps({k: v for k, v in
                                            b["launches"].items() if v}
                                           ).replace(" ", "")
                                for b in batches),
        tea_thresh=f"{thresh:.6g}",
        tea_plan="".join("s" if s else "c" for s in plan),
        progress_seen=json.dumps(list(seen.values())).replace(" ", ""),
        statuses="|".join(b["status"] for b in status.values()),
        outputs=json.dumps({k: [list(v[0])] + [list(s) for s in
                                                 v[2].values()]
                            for k, v in exported.items()}).replace(" ", ""),
        launches=json.dumps({k: v for k, v in launches.items() if v}
                            ).replace(" ", ""))
    errors = [b.get("error") for b in status.values()
              if b["status"] != "done"]
    if errors or len(status) != 3:
        raise AssertionError(f"serve jobs not done: {errors}")
    if [b["jobs"] for b in batches] != [2, 1]:
        raise AssertionError(f"batches {[b['jobs'] for b in batches]}, "
                             f"want [2, 1]")
    if not plan.any():
        raise AssertionError(f"the TeaCache plan {plan} skips nothing")
    want_shapes = expected_shapes(cfg, height, width, frames)
    for job_id, (vshape, vdtype, shapes, finite) in exported.items():
        if vshape != (frames, height, width, 3) or vdtype != np.uint8 \
                or not finite:
            raise AssertionError(f"job {job_id}: video {vshape} {vdtype}, "
                                 f"finite {finite}")
        for key, shape in shapes.items():
            if tuple(shape) != want_shapes[key]:
                raise AssertionError(f"job {job_id}: {key} {shape}")
    tea_id = ids[2]
    if not any(m.startswith("running@") for m in seen[tea_id]):
        raise AssertionError(f"no progress seen on the TeaCache job: "
                             f"{seen[tea_id]}")
    if launches != want:
        raise AssertionError(f"serve launches {launches} != {want}")
    shared = {"t5": cpipe.t5, "vae": cpipe.vae}
    return launches, batches, shared


def phase_full_quant(device, den, profile_dir, geometry=(480, 832, 81)):
    """The Wan2.2 expert resident after the clip, one mid denoise step
    (t = 833, the CFG pair at 480x832, 81 frames, no heads) in bf16, then
    quantized to int8 in place and the same step twice: seconds, peak GB,
    the resident GB before and after, whether two int8 experts would fit
    the card together, the int8 step's relative L2 drift against bf16, and
    the second int8 step under the profiler: the device time of the
    activation quant, the int32 products and the rescale."""
    import torch
    from fantasy_world_tpu_torch.core.quant import quantize_model
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    cfg = den.cfg
    high = den._device_of(den.experts[True]).type == "cuda"
    expert = den.experts[high]
    height, width, frames = geometry
    f = (frames - 1) // 4 + 1
    g = torch.Generator(device).manual_seed(31)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.bfloat16)
    lat = randn(2, cfg.dit.out_dim, f, height // 8, width // 8)
    ctx = randn(2, 512, cfg.dit.text_dim)
    y = randn(2, cfg.dit.in_dim - cfg.dit.out_dim, f, height // 8, width // 8)
    t = torch.full((2,), 833.0, device=device)

    def nbytes(m):
        return sum(x.numel() * x.element_size()
                   for x in list(m.parameters()) + list(m.buffers()))

    def step():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.no_grad():
            noise, _ = expert.joint_forward(lat, t, ctx, None, y)
        end.record()
        end.synchronize()
        return (noise.float(), start.elapsed_time(end) / 1e3,
                torch.cuda.max_memory_allocated() / 1e9)

    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    ref, bf16_s, bf16_peak = step()
    resident_before = torch.cuda.memory_allocated() / 1e9
    expert_before = nbytes(expert) / 1e9
    t0 = time.perf_counter()
    n = quantize_model(expert, "int8")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    resident_after = torch.cuda.memory_allocated() / 1e9
    expert_after = nbytes(expert) / 1e9
    got, int8_s, int8_peak = step()
    drift = ((got - ref).norm() / ref.norm()).item()
    prof = ProfiledStep("wan22_int8_step", int8_s, profile_dir)
    prof.begin()
    _, int8_s2, _ = step()
    prof.end()
    launches = dict(fa.LAUNCHES)
    report = prof.report()
    total = torch.cuda.get_device_properties(device).total_memory / 1e9
    both = resident_after + expert_after + (int8_peak - resident_after)
    glue = sum(report["ranges"].get(k, 0.0) for k in
               ("qlinear_act_quant", "qlinear_rescale"))
    say("full_quant", expert="high" if high else "low", layers=n,
        quantize_s=f"{quant_s:.2f}", bf16_step_s=f"{bf16_s:.3f}",
        int8_step_s=f"{int8_s:.3f}", int8_step2_s=f"{int8_s2:.3f}",
        bf16_peak_gb=f"{bf16_peak:.2f}", int8_peak_gb=f"{int8_peak:.2f}",
        resident_gb_before=f"{resident_before:.2f}",
        resident_gb_after=f"{resident_after:.2f}",
        expert_gb_bf16=f"{expert_before:.2f}",
        expert_gb_int8=f"{expert_after:.2f}",
        both_int8_experts_peak_gb=f"{both:.2f}",
        card_gb=f"{total:.2f}", both_fit=both < total,
        drift_rel_l2=f"{drift:.4e}",
        qlinear_device_s=json.dumps({k: round(v, 3) for k, v in
                                     report["ranges"].items()}
                                    ).replace(" ", ""),
        quant_glue_share=f"{glue / report['device_busy_s']:.4f}",
        launches=json.dumps({k: v for k, v in launches.items() if v}
                            ).replace(" ", ""))
    # three steps without the heads
    want = expected_launches(cfg, 3)
    want["onekv"] -= 4 * cfg.vggt.camera_head.trunk_depth
    if n == 0 or not math.isfinite(drift) or not torch.isfinite(got).all():
        raise AssertionError(f"int8 step: {n} layers, drift {drift}")
    if not report["ranges"]:
        raise AssertionError("the profiler saw no qlinear range")
    if launches != want:
        raise AssertionError(f"quant step launches {launches} != {want}")
    return launches


# kernel families of a profiled step: the first family whose pattern is in
# a kernel's name takes it
FAMILIES = (("attention bwd dkv", ("fa_bwd_dkv",)),
            ("attention bwd dq", ("fa_bwd_dq",)),
            ("attention fwd wgmma (onekv)", ("fa_fwd_onekv",)),
            ("attention fwd wgmma (generic, d64)", ("fa_fwd_wgmma",)),
            ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas",
                                 "nvjet")),
            ("reduction", ("reduce",)),
            ("elementwise", ("elementwise", "vectorized", "unrolled",
                             "copy", "fill", "memcpy", "memset")))


def family(kernel_name: str) -> str:
    """The family of ``FAMILIES`` that a device kernel's name falls in."""
    name = kernel_name.lower()
    return next((f for f, pats in FAMILIES if any(p in name for p in pats)),
                "other")


class ProfiledStep:
    """One step under ``torch.profiler`` (CPU and CUDA): ``begin()`` and
    ``end()`` around it, each of which synchronises the device first, then
    ``report()``, which writes the device's busy time (the union of its
    kernel intervals) by kernel family and by attention kernel, the idle
    share against the unprofiled CUDA-event time of the same step and
    against the profiled wall time, and the device time under the
    ``qlinear_*`` ranges, as ``<tag>_step_breakdown.json``, with a gzipped
    Chrome trace, to ``out_dir``, and returns it."""

    def __init__(self, tag, unprofiled_s, out_dir):
        from torch.profiler import ProfilerActivity, profile
        self.tag, self.unprofiled_s, self.out_dir = tag, unprofiled_s, out_dir
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def begin(self):
        import torch
        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()

    def end(self):
        import torch
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.prof.stop()

    def report(self):
        from torch.autograd import DeviceType
        os.makedirs(self.out_dir, exist_ok=True)
        tag, unprofiled_s, wall = self.tag, self.unprofiled_s, self.wall
        spans, families = [], {name: [0.0, 0] for name, _ in FAMILIES}
        families["other"] = [0.0, 0]
        kernels, ranges = {}, {}
        for ev in self.prof.events():
            if ev.name.startswith("qlinear_"):
                # a range: on the host, the device time of the kernels
                # launched under it; its span on the device's timeline is
                # not a kernel, and counts nowhere
                if ev.device_type == DeviceType.CPU:
                    ranges[ev.name] = ranges.get(ev.name, 0.0) + \
                        ev.device_time_total / 1e6
                continue
            if ev.device_type != DeviceType.CUDA:
                continue
            start, end = ev.time_range.start, ev.time_range.end
            spans.append((start, end))
            fam = family(ev.name)
            families[fam][0] += (end - start) / 1e6
            families[fam][1] += 1
            kname = re.search(r"fa_(fwd|bwd)\w*(<[^>]*>)?", ev.name)
            if kname:
                kern = kernels.setdefault(kname.group(0), [0.0, 0])
                kern[0] += (end - start) / 1e6
                kern[1] += 1
        if not spans:
            raise AssertionError("the profiler recorded no device activity")
        busy, reach = 0.0, float("-inf")
        for start, end in sorted(spans):
            if end > reach:
                busy += (end - max(start, reach)) / 1e6
                reach = end
        out = {"unprofiled_step_s": unprofiled_s, "profiled_wall_s": wall,
               "device_busy_s": busy,
               "idle_share": 1 - busy / unprofiled_s,
               "idle_share_under_profiler": 1 - busy / wall,
               "families": {f: {"device_s": t, "launches": n}
                            for f, (t, n) in sorted(families.items(),
                                                    key=lambda x: -x[1][0])},
               "attention_kernels": {k: {"device_s": t, "launches": n}
                                     for k, (t, n) in sorted(
                                         kernels.items(),
                                         key=lambda x: -x[1][0])},
               "ranges": ranges}
        with open(os.path.join(self.out_dir, f"{tag}_step_breakdown.json"),
                  "w") as f:
            json.dump(out, f, indent=1)
        self.prof.export_chrome_trace(os.path.join(
            self.out_dir, f"{tag}_step_trace.json.gz"))
        say(f"profile_{tag}", unprofiled_step_s=f"{unprofiled_s:.3f}",
            profiled_wall_s=f"{wall:.3f}", device_busy_s=f"{busy:.3f}",
            idle_share=f"{out['idle_share']:.4f}",
            idle_share_under_profiler=(
                f"{out['idle_share_under_profiler']:.4f}"),
            families=json.dumps({f: round(v["device_s"], 3) for f, v in
                                 out["families"].items()}).replace(" ", ""),
            attention=json.dumps({k: round(v["device_s"], 3) for k, v in
                                  out["attention_kernels"].items()}
                                 ).replace(" ", ""))
        return out


def lora_steps(device, fusion, next_batch, steps, seed):
    """LoRA rank 16 with per-block recompute on ``fusion`` (lr 1e-4,
    warm-up 1), as the trainer's loop runs it: ``steps`` times, a batch
    from ``next_batch()`` (the last one still held, as the loop holds it),
    then one step on it. Each build and each step is timed with CUDA
    events; each step's peak memory is taken; the launches of the builds
    and of the steps are counted apart. Returns a dict for
    ``check_lora_run`` and the phase line."""
    import torch
    from fantasy_world_tpu_torch.cli.train import _optimizer
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.training.lora import (init_lora, lora_state,
                                                       make_lora_train_step)
    params = dict(fusion.named_parameters())
    # base tensors whose bytes must not change: every 1/8th of the list,
    # from the first DiT embedding to the last bicross
    names = sorted(params)
    frozen = {n: params[n].detach().clone()
              for n in names[::max(1, len(names) // 8)]}
    init_lora(fusion, 16, generator=torch.Generator(device).manual_seed(seed))
    state = lora_state(fusion)
    opt, sched = _optimizer(argparse.Namespace(lr=1e-4, warmup=1,
                                               weight_decay=1e-4),
                            list(state.values()))
    step = make_lora_train_step(fusion, opt, sched, remat=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    zero = {k: 0 for k in fa.LAUNCHES}
    run = {"losses": [], "build_s": [], "step_s": [], "step_gb": [],
           "build_launches": dict(zero), "launches": dict(zero),
           "lora_params": sum(t.numel() for t in state.values())}
    batch = None
    for _ in range(steps):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        before = dict(fa.LAUNCHES)
        events[0].record()
        batch = next_batch()
        events[1].record()
        torch.cuda.synchronize()
        built = dict(fa.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        run["losses"].append(float(step(batch)))
        events[2].record()
        torch.cuda.synchronize()
        run["step_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
        run["build_s"].append(events[0].elapsed_time(events[1]) / 1e3)
        run["step_s"].append(events[1].elapsed_time(events[2]) / 1e3)
        for k, v in fa.LAUNCHES.items():
            run["build_launches"][k] += built[k] - before[k]
            run["launches"][k] += v - built[k]
    run["moved"] = sum(int(t.count_nonzero()) for n, t in state.items()
                       if n.endswith(".up"))
    run["changed"] = [n for n, t in frozen.items()
                      if not torch.equal(params[n], t)]
    run["step"], run["batch"] = step, batch
    return run


def check_lora_run(run, want_launches, want_build_launches=None):
    """The checks of ``lora_steps``' run: finite losses, a moved ``up``
    factor, an unchanged base, exact launches of the steps and, when given,
    of the builds."""
    if not all(np.isfinite(run["losses"])):
        raise AssertionError(f"non-finite training loss {run['losses']}")
    if run["moved"] == 0:
        raise AssertionError("no up factor moved in the steps")
    if run["changed"]:
        raise AssertionError(f"LoRA training changed base tensors "
                             f"{run['changed']}")
    if run["launches"] != want_launches:
        raise AssertionError(f"training launch counts {run['launches']} != "
                             f"{want_launches}")
    if (want_build_launches is not None
            and run["build_launches"] != want_build_launches):
        raise AssertionError(f"batch build launches "
                             f"{run['build_launches']} != "
                             f"{want_build_launches}")


def _nonzero(counts):
    return json.dumps({k: v for k, v in counts.items() if v}).replace(" ", "")


def phase_full_train(device, pipe, cond, plucker_fea, steps=2, seed=1024,
                     latent_fhw=(21, 42, 74), profile_dir=None):
    """LoRA rank 16 with per-block recompute on the full-width model the
    denoise ran (``lora_steps``): ``steps`` steps at batch 1 on random
    latents and the denoise's conditioning; with ``profile_dir``, one more
    step under the profiler."""
    import torch
    from fantasy_world_tpu_torch.schedulers.flow_match import (
        FlowMatchScheduler)
    from fantasy_world_tpu_torch.training.step import sample_training_inputs
    cfg = pipe.cfg
    gen = torch.Generator(device).manual_seed(seed + 1)
    fm = FlowMatchScheduler().set_timesteps(1000)
    shape = (1, cfg.dit.out_dim, *latent_fhw)
    batches = []
    for _ in range(steps):
        clean = torch.randn(shape, generator=gen, device=device)
        noise, sigma, t = sample_training_inputs(gen, fm, shape)
        batches.append({"clean_latents": clean, "noise": noise,
                        "sigma": sigma,
                        "timestep": torch.full((1,), t, device=device),
                        "context": cond[0].to(device),
                        "clip_feature": cond[2].to(device),
                        "y": cond[3].to(device), "plucker_fea": plucker_fea})
    run = lora_steps(device, pipe.fusion, iter(batches).__next__, steps,
                     seed)
    say("full_train", steps=steps, rank=16, lora_params=run["lora_params"],
        losses="|".join(f"{x:.5f}" for x in run["losses"]),
        step_seconds="|".join(f"{x:.3f}" for x in run["step_s"]),
        peak_gb=f"{max(run['step_gb']):.2f}", up_nonzero=run["moved"],
        base_unchanged=not run["changed"],
        launches=_nonzero(run["launches"]))
    check_lora_run(run, expected_train_launches(cfg, steps))
    if profile_dir:
        prof = ProfiledStep("train", float(np.mean(run["step_s"])),
                            profile_dir)
        prof.begin()
        run["step"](run["batch"])
        prof.end()
        prof.report()
    return run["launches"]


def phase_full_data_train(device, cpipe, steps=2, seed=1024):
    """Fine-tuning on a clip at full width, as ``cli.train --data_root``
    runs it, on ``phase_full_clip``'s pipeline (umT5-XXL, CLIP ViT-H, the
    VAE and the pose encoder beside the 18.5B fusion model, MoGe still
    resident): an 81-frame 336x592 clip written as PNGs
    (``write_pan_clip``), then ``steps`` turns of the trainer's
    ``_data_batches`` (``read_clip``, ``build_train_batch``) and one LoRA
    rank-16 step (``lora_steps``), so every build after the first runs
    beside the adapters, their AdamW moments and the allocator state a
    step leaves. Prints each build's stage seconds and peak GB beside each
    step's; checks the first batch's shapes and finiteness, finite losses,
    a moved ``up`` factor, an unchanged base, and the launches: CLIP's in
    each build, the training steps' in the steps. The adapters are removed
    after. Returns the launches of both."""
    import shutil
    import torch
    from fantasy_world_tpu_torch.cli.train import _data_batches
    from fantasy_world_tpu_torch.models.wan.clip import CLIPVisionConfig
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.training.lora import target_layers
    fusion, cfg = cpipe.fusion, cpipe.cfg
    height, width, frames = 336, 592, 81
    t_phase = t0 = time.perf_counter()
    root = os.path.join(REPO, "build", "data_clips")
    shutil.rmtree(root, ignore_errors=True)
    write_pan_clip(os.path.join(root, "pan"), height, width, frames)
    write_s = time.perf_counter() - t0
    builds = []                       # per build: [(stage, event, peak)]

    def mark(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        builds[-1].append((name, event, torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()

    batches = _data_batches(cpipe, argparse.Namespace(
        data_root=root, height=height, width=width, frames=frames,
        seed=seed), stage_callback=mark)

    first = {}

    def next_batch():
        builds.append([])
        mark("start")
        b = next(batches)
        if not first:
            first.update({k: tuple(v.shape) for k, v in b.items()
                          if torch.is_tensor(v) and v.dim() > 1})
        return b

    gc.collect()
    torch.cuda.empty_cache()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    run = lora_steps(device, fusion, next_batch, steps, seed + 3)
    shutil.rmtree(root, ignore_errors=True)
    batch = run["batch"]
    f, lh, lw = (frames - 1) // 4 + 1, height // 8, width // 8
    want_shapes = {
        "clean_latents": (1, cfg.dit.out_dim, f, lh, lw),
        "noise": (1, cfg.dit.out_dim, f, lh, lw),
        "context": (1, cpipe.text_len, cfg.dit.text_dim),
        "clip_feature": (1, 257, cfg.dit.clip_feature_dim),
        "y": (1, cfg.dit.in_dim - cfg.dit.out_dim, f, lh, lw),
        "plucker_fea": (1, f * (lh // 2) * (lw // 2), cfg.dit.plucker_dim)}
    shapes = {k: first.get(k) for k in want_shapes}
    finite = all(bool(torch.isfinite(batch[k]).all()) for k in want_shapes)
    stage_s = [{name: b[i - 1][1].elapsed_time(ev) / 1e3
                for i, (name, ev, _) in enumerate(b) if i} for b in builds]
    stage_gb = [{name: peak / 1e9 for name, _, peak in b[1:]}
                for b in builds]
    want_build = _add({k: 0 for k in fa.LAUNCHES},
                      *[encoder_launches(clip=CLIPVisionConfig())] * steps)
    say("full_data_train", seconds=f"{time.perf_counter() - t_phase:.2f}",
        frames=frames, height=height, width=width, image="example_png_pan",
        tokenizer="transformers-wordlevel", write_clip_s=f"{write_s:.2f}",
        resident_gb=f"{resident_gb:.2f}",
        build_seconds="|".join(f"{x:.3f}" for x in run["build_s"]),
        build_stage_seconds="|".join(json.dumps(
            {k: round(v, 3) for k, v in d.items()}).replace(" ", "")
            for d in stage_s),
        build_peak_gb="|".join(f"{max(d.values()):.2f}" for d in stage_gb),
        build_stage_peak_gb="|".join(json.dumps(
            {k: round(v, 2) for k, v in d.items()}).replace(" ", "")
            for d in stage_gb),
        batch_shapes=json.dumps({k: list(v) for k, v in shapes.items()}
                                ).replace(" ", ""), batch_finite=finite,
        steps=steps, rank=16,
        losses="|".join(f"{x:.5f}" for x in run["losses"]),
        step_seconds="|".join(f"{x:.3f}" for x in run["step_s"]),
        step_peak_gb="|".join(f"{x:.2f}" for x in run["step_gb"]),
        up_nonzero=run["moved"], base_unchanged=not run["changed"],
        build_launches=_nonzero(run["build_launches"]),
        launches=_nonzero(run["launches"]))
    if shapes != want_shapes:
        raise AssertionError(f"batch shapes {shapes} != {want_shapes}")
    if not finite:
        raise AssertionError("the clip's batch is not finite")
    check_lora_run(run, expected_train_launches(cfg, steps), want_build)
    # the model leaves as it came: without adapters, whose factors and
    # gradients full_train would otherwise hold through its own steps
    launches = _add(run["build_launches"], run["launches"])
    del run, batch, batches
    for _, layer in target_layers(fusion):
        layer._modules.pop("lora", None)
    return launches


# ---------------------------------------------------------------------------
# the sliding-window denoise and the Wan2.2 TI2V-5B path
# ---------------------------------------------------------------------------

def expected_window_launches(cfg, plan, height, width, steps):
    """Kernel launches of a sliding-window denoise (no heads): per window
    of each step, every attention of the fusion forward on the route its
    window's key count takes -- DiT self over the window's video tokens,
    DiT cross (text, and CLIP where the model takes it), bicross both ways
    (geometry tokens: a frame's video tokens plus the aggregator's special
    tokens), VGGT frame and global (d64)."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    pt = cfg.dit.patch_size
    per_frame = (height // 8 // pt[1]) * (width // 8 // pt[2])
    extra = cfg.vggt.aggregator.patch_start_idx
    d, b = cfg.dit, cfg.bicross
    n_x = len(cfg.xattn_set())
    out = {k: 0 for k in fa.LAUNCHES}
    for t0, t1 in plan:
        video, geom = (t1 - t0) * per_frame, (t1 - t0) * (per_frame + extra)
        out[fa.route(d.num_heads, d.head_dim, video)] += d.num_layers
        # text keys (at most 512) and CLIP's 257
        cross = 2 if d.has_image_input else 1
        out[fa.route(d.num_heads, d.head_dim, 512)] += cross * d.num_layers
        for lk in (geom, video):
            out[fa.route(b.num_heads, b.head_dim, lk)] += n_x
        out["d64"] += 2 * cfg.num_irg
    return {k: v * steps for k, v in out.items()}


def phase_small_windowed(device):
    """The Wan2.1 sliding-window denoise at the reduced widths of
    ``small_configs``: 2 steps over 11 latent frames (256x384, 41 frames)
    in windows of 6 with stride 5 (two windows of 2304 video tokens, so
    every route is taken, blended over one frame), on the card in bf16
    against the CPU in f32 from the same weights; the latents within
    SLICE_TOL, no prediction, exact launches."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.temporal_tiler import window_plan
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    t_phase = time.perf_counter()
    fcfg, pcfg = small_configs()
    height, width, frames, steps, size, stride = 256, 384, 41, 2, 6, 5
    g = torch.Generator("cpu").manual_seed(15)
    cpu_f = build(lambda: FusionModel(fcfg), device="cpu",
                  dtype=torch.float32, generator=g)
    wake_zero_inits(cpu_f, g)
    cpu_p = build(lambda: CameraPoseEncoder(pcfg), device="cpu",
                  dtype=torch.float32, generator=g)
    cond = conditioning(fcfg.dit, height, width, frames,
                        torch.Generator("cpu").manual_seed(16), 16)
    outs, launches = {}, {}
    for dev, dtype in (("cpu", torch.float32), (device, torch.bfloat16)):
        fus, pose = cpu_f, cpu_p
        if dev != "cpu":
            fus = build(lambda: FusionModel(fcfg), device=dev, dtype=dtype)
            fus.load_state_dict(cpu_f.state_dict())
            pose = build(lambda: CameraPoseEncoder(pcfg), device=dev,
                         dtype=dtype)
            pose.load_state_dict(cpu_p.state_dict())
        pipe = FantasyWorldPipeline(fus, pose)
        fa.reset_launch_counts()
        lat, pred = pipe.denoise(*cond[:4], height, width, num_frames=frames,
                                 num_inference_steps=steps, seed=3,
                                 plucker_fea=pipe.encode_plucker(cond[4]),
                                 sliding_window_size=size,
                                 sliding_window_stride=stride)
        launches[str(dev)] = dict(fa.LAUNCHES)
        if pred is not None or not bool(torch.isfinite(lat).all()):
            raise AssertionError(f"windowed denoise on {dev}: prediction "
                                 f"{pred}, finite {torch.isfinite(lat).all()}")
        outs[str(dev)] = lat.float().cpu()
    f = (frames - 1) // 4 + 1
    plan = window_plan(f, size, stride)
    want = expected_window_launches(fcfg, plan, height, width, steps)
    err = _rel_l2([outs[str(device)]], [outs["cpu"]])
    card = launches[str(device)]
    say("small_windowed", seconds=f"{time.perf_counter() - t_phase:.2f}",
        windows="|".join(f"{a}-{b}" for a, b in plan),
        latents_shape="x".join(map(str, outs["cpu"].shape)),
        device_vs_cpu_rel_l2=f"{err:.3e}",
        launches=json.dumps({k: v for k, v in card.items() if v}
                            ).replace(" ", ""))
    if any(launches["cpu"].values()):
        raise AssertionError(f"the CPU run launched {launches['cpu']}")
    if card != want:
        raise AssertionError(f"windowed launches {card} != {want}")
    if not err <= SLICE_TOL:
        raise AssertionError(f"the windowed denoise disagrees with the CPU "
                             f"path: {err} > {SLICE_TOL}")


def phase_full_windowed(device, pipe, cond, plucker_fea, seed=1024):
    """One sliding-window step at full width on ``phase_full_slice``'s
    model: 336x592, 81 frames (21 latent frames) in windows of 11 with
    stride 10, two windows: seconds, peak GB, exact launches, finite
    latents of the right shape."""
    import torch
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.temporal_tiler import window_plan
    cfg = pipe.cfg
    height, width, frames, size, stride = 336, 592, 81, 11, 10
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    lat, pred = pipe.denoise(*cond[:4], height, width, num_frames=frames,
                             num_inference_steps=1, seed=seed,
                             plucker_fea=plucker_fea,
                             sliding_window_size=size,
                             sliding_window_stride=stride)
    end.record()
    end.synchronize()
    launches = dict(fa.LAUNCHES)
    f = (frames - 1) // 4 + 1
    plan = window_plan(f, size, stride)
    want = expected_window_launches(cfg, plan, height, width, 1)
    shape = (1, cfg.dit.out_dim, f, height // 8, width // 8)
    finite = bool(torch.isfinite(lat).all())
    say("full_windowed", windows="|".join(f"{a}-{b}" for a, b in plan),
        step_seconds=f"{start.elapsed_time(end) / 1e3:.3f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        latents_shape="x".join(map(str, lat.shape)), finite=finite,
        launches=json.dumps({k: v for k, v in launches.items() if v}
                            ).replace(" ", ""))
    if len(plan) != 2 or tuple(lat.shape) != shape or not finite \
            or pred is not None:
        raise AssertionError(f"windowed step: plan {plan}, shape "
                             f"{tuple(lat.shape)}, finite {finite}")
    if launches != want:
        raise AssertionError(f"windowed step launches {launches} != {want}")
    del lat
    gc.collect()
    torch.cuda.empty_cache()
    return launches


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


def ti2v_launches(cfg, steps):
    """A TI2V denoise's launches: per step, each block's self-attention
    (generic at these lengths) and text cross-attention (onekv)."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    out = {k: 0 for k in fa.LAUNCHES}
    out.update(generic=steps * cfg.num_layers, onekv=steps * cfg.num_layers)
    return out


def run_ti2v(pipe, image, height, width, frames, steps, seed, mark=None,
             tiled=False):
    """The TI2V-5B clip through the port's entry points: ``run_condition``
    (the 38-block VAE's latent of the image fused into latent frame 0),
    ``denoise_ti2v`` on the conditioning's noise, then ``decode_video``
    (``tiled``: over the reference grid). ``mark(name)`` after each unit,
    step and the decode. Returns (latents, first-frame latent, uint8
    video)."""
    from fantasy_world_tpu_torch.pipelines.ti2v import denoise_ti2v
    from fantasy_world_tpu_torch.pipelines.units import run_condition
    stage = mark or (lambda name: None)
    shared, posi, nega = run_condition(
        pipe, PROMPT, NEG_PROMPT, input_image=image, height=height,
        width=width, num_frames=frames, seed=seed, stage_callback=stage)
    latents = denoise_ti2v(
        pipe.dit, posi["context"], nega["context"], height, width,
        num_frames=frames, num_inference_steps=steps, seed=seed,
        first_frame_latents=shared["first_frame_latents"],
        noise=shared["noise"],
        progress_callback=lambda i, n: stage(f"denoise_step{i}"))
    video = pipe.decode_video(latents, tiled=tiled)
    stage("vae_decode")
    return latents, shared["first_frame_latents"], video


def phase_small_ti2v(device):
    """The TI2V-5B path at the widths of ``small_ti2v_configs``, 512x768,
    21 frames, 2 steps, on the card in bf16 against the CPU in f32 from the
    same weights: the first-frame latent, the latents, the float decode of
    each run's latents, the card's decode of the CPU's latents and both
    decodes of unit-normal latents within SLICE_TOL, frame 0 equal to the
    clean latent after the loop, exact launches."""
    import shutil
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.wan.dit import WanDiT
    from fantasy_world_tpu_torch.models.wan.t5 import T5Encoder
    from fantasy_world_tpu_torch.models.wan.vae38 import WanVAE38
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    from fantasy_world_tpu_torch.sampler import image_pm1
    t_phase = time.perf_counter()
    dcfg, t5c, vcfg = small_ti2v_configs()
    ctors = {"dit": (WanDiT, dcfg), "t5": (T5Encoder, t5c),
             "vae": (WanVAE38, vcfg)}
    height, width, frames, steps = 512, 768, 21, 2
    g = torch.Generator("cpu").manual_seed(17)
    weights = {n: build(lambda: c(cfg), device="cpu", dtype=torch.float32,
                        generator=g) for n, (c, cfg) in ctors.items()}
    image, _ = clip_inputs(height, width, frames)
    image = image_pm1(image, height, width)
    lat_shape = (1, 48, (frames - 1) // 4 + 1, height // 16, width // 16)
    # unit-normal latents: the VAE's own bf16 error, apart from the range
    # of the denoised latents
    rand_lat = torch.randn(lat_shape, generator=g)
    work = os.path.join(REPO, "build", "small_ti2v")
    outs = {}
    for dev, dtype in (("cpu", torch.float32), (device, torch.bfloat16)):
        mods = weights
        if dev != "cpu":
            mods = {}
            for n, (c, cfg) in ctors.items():
                mods[n] = build(lambda: c(cfg), device=dev, dtype=dtype)
                mods[n].load_state_dict(weights[n].state_dict())
        pipe = FantasyWorldPipeline(t5=mods["t5"], vae=mods["vae"],
                                    dit=mods["dit"])
        tok = install_tokenizer(pipe, t5c.vocab, os.path.join(work, "tok"))
        fa.reset_launch_counts()
        lat, first, video = run_ti2v(pipe, image, height, width, frames,
                                     steps, seed=3)
        launches = dict(fa.LAUNCHES)
        with torch.no_grad():
            dec = pipe.vae.decode(lat)
            # the VAE alone: the CPU run's latents decoded on the card too
            same = dec if not outs else pipe.vae.decode(
                outs["cpu"]["latents"].to(dev, dtype))
            rand = pipe.vae.decode(rand_lat.to(dev, dtype))
        outs[str(dev)] = {"latents": lat.float().cpu(),
                          "decode_random_latents": rand.float().cpu(),
                          "decode_same_latents": same.float().cpu(),
                          "first": first.float().cpu(),
                          "decode": dec.float().cpu(), "video": video,
                          "launches": launches,
                          "clamped": torch.equal(lat[:, :, :1],
                                                 first.to(lat.dtype))}
        del mods, pipe, dec, same, rand
    shutil.rmtree(work, ignore_errors=True)
    cpu, card = outs["cpu"], outs[str(device)]
    errs = {k: _rel_l2([card[k]], [cpu[k]])
            for k in ("first", "latents", "decode")}
    errs["decode_same_latents"] = _rel_l2([card["decode_same_latents"]],
                                          [cpu["decode"]])
    errs["decode_random_latents"] = _rel_l2(
        [card["decode_random_latents"]], [cpu["decode_random_latents"]])
    want = ti2v_launches(dcfg, steps)
    say("small_ti2v", seconds=f"{time.perf_counter() - t_phase:.2f}",
        tokenizer=tok, image="example_png",
        latents_shape="x".join(map(str, card["latents"].shape)),
        video_shape="x".join(map(str, card["video"].shape)),
        frame0_clamped=f"{card['clamped']}|{cpu['clamped']}",
        device_vs_cpu_rel_l2=json.dumps({k: float(f"{v:.3e}") for k, v in
                                         errs.items()}).replace(" ", ""),
        launches=json.dumps({k: v for k, v in card["launches"].items()
                             if v}).replace(" ", ""))
    if any(cpu["launches"].values()):
        raise AssertionError(f"the CPU run launched {cpu['launches']}")
    if card["launches"] != want:
        raise AssertionError(f"small TI2V launches {card['launches']} != "
                             f"{want}")
    if tuple(card["latents"].shape) != lat_shape \
            or card["video"].shape != (frames, height, width, 3):
        raise AssertionError(f"small TI2V shapes {card['latents'].shape} "
                             f"{card['video'].shape}")
    if not (card["clamped"] and cpu["clamped"]):
        raise AssertionError("frame 0 is not the clean first-frame latent")
    bad = {k: v for k, v in errs.items() if not v <= SLICE_TOL}
    if bad:
        raise AssertionError(f"the reduced TI2V path disagrees with the CPU "
                             f"path beyond {SLICE_TOL}: {bad}")


def phase_full_ti2v(device, t5, steps=2, seed=1024):
    """Wan2.2 TI2V-5B at full width and depth from a seed (the 30-block,
    3072-wide DiT, the 38-block VAE) with the umT5-XXL of the earlier
    clips: ``run_condition`` with the example image at 704x1280, ``steps``
    CFG-pair steps of ``denoise_ti2v`` at 704x1280, 121 frames, the tiled
    decode to 121 frames. Prints each stage's seconds and peak GB (CUDA
    events), a 50-step clip reckoned from them, the launches (exactly 30
    generic and 30 onekv a step), the shapes, finiteness and that frame 0
    is the clean first-frame latent."""
    import shutil
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.wan.dit import TI2V_5B, WanDiT
    from fantasy_world_tpu_torch.models.wan.t5 import T5Config
    from fantasy_world_tpu_torch.models.wan.vae38 import WanVAE38
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    from fantasy_world_tpu_torch.sampler import image_pm1
    height, width, frames = 704, 1280, 121
    t_phase = t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed + 5)
    dit = build(lambda: WanDiT(TI2V_5B), device=device, dtype=torch.bfloat16,
                generator=g)
    vae = build(lambda: WanVAE38(), device=device, dtype=torch.bfloat16,
                generator=g)
    pipe = FantasyWorldPipeline(t5=t5, vae=vae, dit=dit)
    work = os.path.join(REPO, "build", "full_ti2v")
    tok = install_tokenizer(pipe, T5Config().vocab, os.path.join(work, "tok"))
    pipe.tokenize(PROMPT)             # the tokenizer loads on first use
    image, _ = clip_inputs(height, width, frames)
    image = image_pm1(image, height, width)
    torch.cuda.synchronize()
    say("full_ti2v_build", seconds=f"{time.perf_counter() - t0:.2f}",
        dit_params=sum(p.numel() for p in dit.parameters()),
        vae_params=sum(p.numel() for p in vae.parameters()),
        resident_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}")
    marks = []

    def mark(name, *_):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event, torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    mark("start")
    lat, first, video = run_ti2v(pipe, image, height, width, frames, steps,
                                 seed, mark=mark, tiled=True)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    stage_s = {name: marks[i - 1][1].elapsed_time(ev) / 1e3
               for i, (name, ev, _) in enumerate(marks) if i}
    peak_gb = {name: peak / 1e9 for name, _, peak in marks[1:]}
    step_s = [stage_s[f"denoise_step{i}"] for i in range(1, steps + 1)]
    fixed = sum(v for k, v in stage_s.items() if not k.startswith("denoise"))
    reckoned = fixed + 50 * float(np.mean(step_s))
    lat_shape = (1, 48, (frames - 1) // 4 + 1, height // 16, width // 16)
    finite = bool(torch.isfinite(lat).all())
    clamped = torch.equal(lat[:, :, :1], first.to(lat.dtype))
    want = ti2v_launches(TI2V_5B, steps)
    shutil.rmtree(work, ignore_errors=True)
    say("full_ti2v", seconds=f"{time.perf_counter() - t_phase:.2f}",
        steps=steps, tokenizer=tok, image="example_png_704x1280",
        stage_seconds=json.dumps({k: round(v, 3) for k, v in
                                  stage_s.items()}).replace(" ", ""),
        stage_peak_gb=json.dumps({k: round(v, 2) for k, v in
                                  peak_gb.items()}).replace(" ", ""),
        reckoned_50_step_clip_s=f"{reckoned:.1f}",
        latents_shape="x".join(map(str, lat.shape)),
        video_shape="x".join(map(str, video.shape)), finite=finite,
        frame0_clamped=clamped,
        launches=json.dumps({k: v for k, v in launches.items() if v}
                            ).replace(" ", ""))
    if tuple(lat.shape) != lat_shape or not finite or not clamped:
        raise AssertionError(f"TI2V latents {tuple(lat.shape)}, finite "
                             f"{finite}, frame 0 clamped {clamped}")
    if video.shape != (frames, height, width, 3) or video.dtype != np.uint8:
        raise AssertionError(f"TI2V video {video.shape} {video.dtype}")
    if launches != want:
        raise AssertionError(f"TI2V launches {launches} != {want}")
    del dit, vae, pipe, lat, first, video
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="profile the second and the last step of one more "
                        "full-depth denoise, a third full-width training "
                        "step and both steps of one more Wan2.2 clip into "
                        "DIR")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    # fails here, before any output, when the port is not beside the script
    import fantasy_world_tpu_torch.pipelines.wan_video  # noqa: F401
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    t_start = time.perf_counter()
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
    phase_train_kernels(device, per_kernel)
    phase_qlinear(device)
    phase_small_slice(device)
    phase_small_windowed(device)
    phase_small_clip(device)
    phase_small_wan22(device)
    phase_small_ti2v(device)
    phase_small_serve(device)
    phase_small_train(device)
    phase_train_cli()
    phase_train_cli_data()
    gc.collect()
    torch.cuda.empty_cache()
    denoise, per_step, pipe, cond, plucker_fea = phase_full_slice(
        device, profile_dir=args.profile)
    clip_run, cpipe, moge = phase_full_clip(device, pipe)
    serve, _, shared = phase_full_serve(device, cpipe, moge)
    data_train = phase_full_data_train(device, cpipe)
    # CLIP and MoGe go; umT5 and the VAE stay for the Wan2.2 clip
    del cpipe, moge
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_full_train(device, pipe, cond, plucker_fea,
                             profile_dir=args.profile)
    windowed = phase_full_windowed(device, pipe, cond, plucker_fea)
    # the Wan2.1 model makes room for the experts
    del pipe, cond, plucker_fea
    gc.collect()
    torch.cuda.empty_cache()
    wan22, quant = phase_full_wan22(
        device, shared, args.profile or os.path.join(REPO, "build",
                                                     "profile"),
        profile_dir=args.profile)
    # the experts are gone; umT5 stays for TI2V-5B, the 2.1 VAE goes
    t5 = shared["t5"]
    del shared
    gc.collect()
    torch.cuda.empty_cache()
    ti2v = phase_full_ti2v(device, t5)
    del t5

    yard = ("tflops", "bound_ms", "bound_by", "share", "library_ms",
            "library_ms_by_backend", "by_shape")
    kernels = []
    for k in fa.ROUTES:
        pk = per_kernel[k]
        kernels.append({
            "name": f"fa_fwd_{k}", "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k],
            "launches": (denoise[k] + windowed[k] + clip_run[k] + serve[k]
                         + train[f"{k}_stats"] + data_train[k]
                         + data_train[f"{k}_stats"] + wan22[k] + quant[k]
                         + ti2v[k]),
            "denoise_launches": denoise[k],
            "windowed_step_launches": windowed[k],
            "clip_run_launches": clip_run[k],
            "serve_launches": serve[k],
            "data_train_launches": data_train[k] + data_train[f"{k}_stats"],
            "wan22_clip_launches": wan22[k],
            "wan22_int8_step_launches": quant[k],
            "ti2v_clip_launches": ti2v[k],
            "launches_per_denoise_step": per_step[k],
            "stats_launches": train[f"{k}_stats"] + data_train[f"{k}_stats"],
            "max_abs_err": pk["max_abs_err"], "ms": pk["ms"],
            "plain_ms": pk["plain_ms"], **{n: pk[n] for n in yard},
            "stats_ms": pk["stats_ms"],
            "stats_plain_ms": pk["stats_plain_ms"],
            "stats_by_shape": pk["stats_by_shape"]})
    # the stats output of the three forwards (with_stats), one row as in
    # the TPU kernel table: its launches on every route, its numbers at
    # onekv's headline shape (DiT cross against 512 text keys, batch 1)
    pk = per_kernel["onekv"]
    kernels.append({
        "name": "fa_fwd_stats", "route": "cuda", "source": SOURCES["onekv"],
        "sources": sorted(set(SOURCES.values())),
        "replaces": f"{JAX_FA}:102",
        "launches": sum(train[f"{k}_stats"] + data_train[f"{k}_stats"]
                        for k in fa.ROUTES),
        "launches_by_route": {k: train[f"{k}_stats"]
                              + data_train[f"{k}_stats"] for k in fa.ROUTES},
        "max_abs_err": max(per_kernel[k]["stats_max_abs_err"]
                           for k in fa.ROUTES),
        "ms": pk["stats_ms"], "plain_ms": pk["stats_plain_ms"],
        **{n: pk["stats_yardsticks"][n] for n in yard[:-1]}})
    for k in ("bwd_dq", "bwd_dkv"):
        pk = per_kernel[k]
        kernels.append({
            "name": f"fa_{k}", "route": "cuda", "source": BWD_SOURCE,
            "replaces": REPLACES[k],
            "launches": sum(train[f"{k}_{d}"] + data_train[f"{k}_{d}"]
                            for d in fa.BWD_D),
            "launches_by_head_dim": {d: train[f"{k}_{d}"]
                                     + data_train[f"{k}_{d}"]
                                     for d in fa.BWD_D},
            "data_train_launches": sum(data_train[f"{k}_{d}"]
                                       for d in fa.BWD_D),
            "launches_per_denoise_step": sum(per_step[f"{k}_{d}"]
                                             for d in fa.BWD_D),
            "max_abs_err": pk["max_abs_err"], "ms": pk["ms"],
            "plain_ms": pk["plain_ms"], "plain_covers": "dq, dk and dv",
            "library_covers": "dq, dk and dv", **{n: pk[n] for n in yard},
            "backward_ms": pk["backward_ms"]})
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
