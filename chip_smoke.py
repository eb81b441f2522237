#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA device

Phases, each printing one line per check (any failure raises and exits
non-zero):
  1. build the hand-written attention kernels from ``csrc/`` (nvcc, sm_90a,
     one process per source, all at once);
  2. each forward kernel against its plain PyTorch version on seeded bf16
     inputs at the denoise shapes: max abs error (bound: two bf16 ulps of
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
  5. reduced-width training on the card in bf16 against the CPU in f32:
     two LoRA steps (losses, factor gradients; every stats-forward and
     backward kernel at D 64, 96 and 128 launched) and one full
     fine-tuning step (loss, gradients);
  6. the trainer's entry point, ``cli.train --synthetic --lora_rank 4`` at
     its demo config: 2 steps saved, then resumed to step 3 (finite
     losses, both checkpoints, the stats and backward kernels launched);
  7. the full-width, full-depth Wan2.1-I2V-14B-480P fusion denoise
     (``FusionConfig()``, 336x592, 81 frames, 3 steps, geometry heads on the
     last) from random weights: shapes, finiteness, launch counts (in all,
     and of the second step, which must match the configuration's layers),
     seconds per step and peak memory;
  8. two full-width LoRA training steps (rank 16, per-block recompute,
     batch 1) on the same model: finite losses, moved factors, an unchanged
     base, exact launch counts, seconds per step and peak memory.
Then one JSON line with the kernels' numbers, and the device JSON line last.
Imports nothing of JAX.

    python3 chip_smoke.py --profile DIR

also runs the 3-step denoise again with its second step and its last step
(the one with the heads) under ``torch.profiler`` (started and stopped
from the pipeline's progress callback) and a third full-width training
step under it, and writes for each its device-time breakdown by kernel
family and by attention kernel, its idle share against the same
unprofiled step and a gzipped Chrome trace into DIR
(``denoise_step_breakdown.json``, ``denoise_heads_step_breakdown.json``,
``train_step_breakdown.json``).
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
]
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
    denoise step (without the last step's heads): what each shape adds to
    its route's launches, which ``phase_full_slice`` measures."""
    n_dit, n_x, n_irg = cfg.dit.num_layers, len(cfg.xattn_set()), cfg.num_irg
    return {"dit_self": n_dit, "dit_cross_text": n_dit,
            "dit_cross_clip": n_dit, "bicross_video_to_geometry": n_x,
            "bicross_geometry_to_video": n_x, "vggt_frame": n_irg,
            "vggt_global": n_irg, "camera_trunk": 0}


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
    g = torch.Generator(device=device).manual_seed(0)
    layers = layers_per_step(FusionConfig())
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
            y["online_ms"] = time_ms(
                lambda: fa.launch("generic", q, k, v, scale), 5)
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
        if name == HEADLINE[kernel]:
            fwd["stats_ms"] = ms["stats"]
            fwd["stats_plain_ms"] = plain["stats"]
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


def expected_launches(cfg, steps):
    """Kernel launches of a denoise: per step DiT self (generic), bicross
    both ways (generic), DiT cross text + CLIP (onekv), VGGT frame + global
    (d64); the camera-head trunk (onekv) on the last step."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    n_irg = len(cfg.xattn_set())
    trunk = 4 * cfg.vggt.camera_head.trunk_depth
    out = {k: 0 for k in fa.LAUNCHES}
    out.update(generic=steps * (cfg.dit.num_layers + 2 * n_irg),
               onekv=steps * 2 * cfg.dit.num_layers + trunk,
               d64=steps * 2 * cfg.num_irg)
    return out


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
    against the profiled wall time as ``<tag>_step_breakdown.json``, with a
    gzipped Chrome trace, to ``out_dir``."""

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
        kernels = {}
        for ev in self.prof.events():
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
                                         key=lambda x: -x[1][0])}}
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


def phase_full_train(device, pipe, cond, plucker_fea, steps=2, seed=1024,
                     latent_fhw=(21, 42, 74), profile_dir=None):
    """LoRA rank 16 with per-block recompute on the full-width model the
    denoise ran: ``steps`` steps at batch 1, lr 1e-4, warm-up 1; with
    ``profile_dir``, one more step under the profiler."""
    import torch
    from fantasy_world_tpu_torch.cli.train import _optimizer
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.schedulers.flow_match import (
        FlowMatchScheduler)
    from fantasy_world_tpu_torch.training.lora import (init_lora, lora_state,
                                                       make_lora_train_step)
    from fantasy_world_tpu_torch.training.step import sample_training_inputs
    fusion, cfg = pipe.fusion, pipe.cfg
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
    n_factors = sum(t.numel() for t in state.values())
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses = []
    events[0].record()
    for i, batch in enumerate(batches):
        losses.append(step(batch))
        events[i + 1].record()
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    losses = [float(x) for x in losses]
    step_s = [events[i].elapsed_time(events[i + 1]) / 1e3
              for i in range(steps)]
    moved = sum(int(t.count_nonzero()) for n, t in state.items()
                if n.endswith(".up"))
    changed = [n for n, t in frozen.items() if not torch.equal(params[n], t)]
    want = expected_train_launches(cfg, steps)
    say("full_train", steps=steps, rank=16, lora_params=n_factors,
        losses="|".join(f"{x:.5f}" for x in losses),
        step_seconds="|".join(f"{x:.3f}" for x in step_s),
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        up_nonzero=moved, base_unchanged=not changed,
        launches=json.dumps({k: v for k, v in launches.items() if v}
                            ).replace(" ", ""))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss {losses}")
    if moved == 0:
        raise AssertionError("no up factor moved in two steps")
    if changed:
        raise AssertionError(f"LoRA training changed base tensors {changed}")
    if launches != want:
        raise AssertionError(f"training launch counts {launches} != {want}")
    if profile_dir:
        prof = ProfiledStep("train", float(np.mean(step_s)), profile_dir)
        prof.begin()
        step(batches[-1])
        prof.end()
        prof.report()
    return launches


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="profile the second and the last step of one more "
                        "full-depth denoise and a third full-width training "
                        "step into DIR")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    # fails here, before any output, when the port is not beside the script
    import fantasy_world_tpu_torch.pipelines.wan_video  # noqa: F401
    from fantasy_world_tpu_torch.ops import flash_attention as fa
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
    phase_small_slice(device)
    phase_small_train(device)
    phase_train_cli()
    gc.collect()
    torch.cuda.empty_cache()
    denoise, per_step, pipe, cond, plucker_fea = phase_full_slice(
        device, profile_dir=args.profile)
    train = phase_full_train(device, pipe, cond, plucker_fea,
                             profile_dir=args.profile)

    yard = ("tflops", "bound_ms", "bound_by", "share", "library_ms",
            "library_ms_by_backend", "by_shape")
    kernels = []
    for k in fa.ROUTES:
        pk = per_kernel[k]
        kernels.append({
            "name": f"fa_fwd_{k}", "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k],
            "launches": denoise[k] + train[f"{k}_stats"],
            "denoise_launches": denoise[k],
            "launches_per_denoise_step": per_step[k],
            "stats_launches": train[f"{k}_stats"],
            "max_abs_err": pk["max_abs_err"], "ms": pk["ms"],
            "plain_ms": pk["plain_ms"], **{n: pk[n] for n in yard},
            "stats_ms": pk["stats_ms"],
            "stats_plain_ms": pk["stats_plain_ms"],
            "stats_by_shape": pk["stats_by_shape"]})
    for k in ("bwd_dq", "bwd_dkv"):
        pk = per_kernel[k]
        kernels.append({
            "name": f"fa_{k}", "route": "cuda", "source": BWD_SOURCE,
            "replaces": REPLACES[k],
            "launches": sum(train[f"{k}_{d}"] for d in fa.BWD_D),
            "launches_by_head_dim": {d: train[f"{k}_{d}"] for d in fa.BWD_D},
            "launches_per_denoise_step": sum(per_step[f"{k}_{d}"]
                                             for d in fa.BWD_D),
            "max_abs_err": pk["max_abs_err"], "ms": pk["ms"],
            "plain_ms": pk["plain_ms"], "plain_covers": "dq, dk and dv",
            "library_covers": "dq, dk and dv", **{n: pk[n] for n in yard},
            "backward_ms": pk["backward_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
