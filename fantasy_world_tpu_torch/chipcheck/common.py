"""The card check's shared arithmetic: the kernels' sources and the TPU
kernels they replace, the tolerances, the attention shapes held to their
plain versions, the printing and timing helpers, the yardsticks (bounds
and the library's times), the one relative-L2 helper, and where the phases
write under the repository's ``build/``.

Imports no torch at module level: the tests import it on a CPU-only host.
"""
from __future__ import annotations

import json
import os
import re
import time

import numpy as np


# the repository root: the package's parent
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
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

# the track head's query points, and its frames: the feature-only DPT
# upsamples the 21 latent frames of an 81-frame clip 4x in time
TRACK_POINTS = 256
TRACK_FRAMES = 1 + 4 * ((81 - 1) // 4)

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
    # FLF2V (the registry's has_image_pos_emb entry) at 336x592: the 514
    # tokens of the start and end images split at 257, so the text keys are
    # the end image's 257 and umT5's 512 -- 769, a remainder of onekv's tiles
    ("flf2v_dit_cross_text", (2, 16317, 40, 128), 769, "onekv"),
    # the track head (TrackConfig(): 8 heads of 48, zero-padded to 64) on
    # TRACK_POINTS query points and the TRACK_FRAMES frames the feature-only
    # DPT gives at 81 video frames, with 64 virtual tracks: time attention
    # over each track's frames, then virtual <- points, virtual self,
    # points <- virtual in every frame
    ("track_time", (TRACK_POINTS + 64, TRACK_FRAMES, 8, 48), TRACK_FRAMES,
     "d64"),
    ("track_virtual_to_point", (TRACK_FRAMES, 64, 8, 48), TRACK_POINTS,
     "d64"),
    ("track_virtual_self", (TRACK_FRAMES, 64, 8, 48), 64, "d64"),
    ("track_point_to_virtual", (TRACK_FRAMES, TRACK_POINTS, 8, 48), 64,
     "d64"),
    # the single-card options at 336x592, 81 frames (21 latent frames of
    # 777 tokens): the 'latent_split' pose attention, each latent frame's
    # tokens over its frame's 777 Plucker tokens (the 'latent_overall' one
    # is dit_self's shape); temporal bicross at T = R = 21, one geometry
    # frame of 777 + 5 tokens a window, both ways, D 96 padded to 128
    ("pose_split", (42, 777, 40, 128), 777, "onekv"),
    ("bicross_temporal_video_to_geometry", (42, 777, 12, 96), 782, "onekv"),
    ("bicross_temporal_geometry_to_video", (42, 782, 12, 96), 777, "onekv"),
    # the multi-GPU path at 336x592, 81 frames, one rank's calls: the DiT
    # at 20 of its 40 heads (mesh_model 2, or Ulysses at mesh_seq 2 after
    # its all-to-all: the whole 16,317 tokens, the padding cut), Ulysses'
    # bicross at 6 of 12 heads and VGGT global at 8 of 16; and the ring's
    # stats calls at mesh_seq 2: rank 0's 11 frames against a part of 11
    # frames (the other rank's 10 zero-padded to 11)
    ("mesh_dit_self_20_heads", (2, 16317, 20, 128), 16317, "generic"),
    ("mesh_dit_cross_text_20_heads", (2, 16317, 20, 128), 512, "onekv"),
    ("mesh_dit_cross_clip_20_heads", (2, 16317, 20, 128), 257, "onekv"),
    ("ulysses_bicross_video_to_geometry", (2, 16317, 6, 96), 16422,
     "generic"),
    ("ulysses_bicross_geometry_to_video", (2, 16422, 6, 96), 16317,
     "generic"),
    ("ulysses_vggt_global", (2, 16422, 8, 64), 16422, "d64"),
    ("ring_dit_self", (2, 11 * 777, 40, 128), 11 * 777, "generic"),
    ("ring_bicross_video_to_geometry", (2, 11 * 777, 12, 96), 11 * 782,
     "generic"),
    ("ring_bicross_geometry_to_video", (2, 11 * 782, 12, 96), 11 * 777,
     "generic"),
    ("ring_vggt_global", (2, 11 * 782, 16, 64), 11 * 782, "d64"),
    # the serving options on a mesh, one rank's calls: a served batch of 2
    # clips (4 CFG rows) at mesh_model 2; the Wan2.2 DiT at 480x832 at
    # mesh_model 2 (21 x 30 x 52 tokens, text keys only); a window of 11
    # latent frames (11 x 777 video, 11 x 782 geometry tokens) through
    # Ulysses at mesh_seq 2, after its all-to-all
    ("mesh_serve_dit_self_20_heads", (4, 16317, 20, 128), 16317, "generic"),
    ("mesh_serve_dit_cross_text_20_heads", (4, 16317, 20, 128), 512,
     "onekv"),
    ("mesh_serve_dit_cross_clip_20_heads", (4, 16317, 20, 128), 257,
     "onekv"),
    ("mesh_wan22_dit_self_20_heads", (2, 32760, 20, 128), 32760, "generic"),
    ("mesh_wan22_dit_cross_text_20_heads", (2, 32760, 20, 128), 512,
     "onekv"),
    ("ulysses_window_dit_self", (2, 11 * 777, 20, 128), 11 * 777,
     "generic"),
    ("ulysses_window_bicross_video_to_geometry", (2, 11 * 777, 6, 96),
     11 * 782, "generic"),
    ("ulysses_window_bicross_geometry_to_video", (2, 11 * 782, 6, 96),
     11 * 777, "generic"),
    ("ulysses_window_vggt_global", (2, 11 * 782, 8, 64), 11 * 782, "d64"),
]
# the multi-GPU cells: one rank's calls per denoise step of its mesh (DiT
# self and cross at mesh_model 2 for 40 blocks; the Ulysses and ring cells
# at mesh_seq 2 for 24 IRG blocks, the ring two stats calls per attention)
MESH_CELLS = {"mesh_dit_self_20_heads": 40, "mesh_dit_cross_text_20_heads": 40,
              "mesh_dit_cross_clip_20_heads": 40,
              "ulysses_bicross_video_to_geometry": 24,
              "ulysses_bicross_geometry_to_video": 24,
              "ulysses_vggt_global": 24, "ring_dit_self": 2 * 40,
              "ring_bicross_video_to_geometry": 2 * 24,
              "ring_bicross_geometry_to_video": 2 * 24,
              "ring_vggt_global": 2 * 24,
              # a served batch's and a Wan2.2 step's 40 blocks at
              # mesh_model 2; each window of a windowed step through
              # Ulysses at mesh_seq 2
              "mesh_serve_dit_self_20_heads": 40,
              "mesh_serve_dit_cross_text_20_heads": 40,
              "mesh_serve_dit_cross_clip_20_heads": 40,
              "mesh_wan22_dit_self_20_heads": 40,
              "mesh_wan22_dit_cross_text_20_heads": 40,
              "ulysses_window_dit_self": 40,
              "ulysses_window_bicross_video_to_geometry": 24,
              "ulysses_window_bicross_geometry_to_video": 24,
              "ulysses_window_vggt_global": 24}
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
# the mesh trainer's backward shapes: Ulysses at 2 seq ranks (every head
# group over the whole sequence) and the ring's hops at 3 seq ranks (21
# latent frames, 7 a part), whose 40 DiT heads do not divide; and the
# pipeline trainer's
MESH_TRAIN_SHAPES = [
    ("ulysses_train_dit_self", (1, 16317, 20, 128), 16317, "generic"),
    ("ulysses_train_vggt_global", (1, 16422, 8, 64), 16422, "d64"),
    ("ulysses_train_bicross_video_to_geometry", (1, 16317, 6, 96), 16422,
     "generic"),
    ("ring_train_dit_self", (1, 7 * 777, 40, 128), 7 * 777, "generic"),
    ("ring_train_vggt_global", (1, 7 * 782, 16, 64), 7 * 782, "d64"),
    # the pipeline trainer's microbatch, Bm = 1 at 480x832x81 (21 x 30 x 52
    # tokens): the DiT's self-attention and its cross-attentions to umT5's
    # 512 and CLIP's 257 keys
    ("pipe_train_dit_self", (1, 32760, 40, 128), 32760, "generic"),
    ("pipe_train_dit_cross_text", (1, 32760, 40, 128), 512, "onekv"),
    ("pipe_train_dit_cross_clip", (1, 32760, 40, 128), 257, "onekv"),
    # 'seq' inside a stage (full_pipe_seq, 2 seq ranks): Ulysses's head
    # group over the microbatch's 32,760 tokens, and the cross-attentions
    # of the rank holding 11 of the 21 latent frames (17,160 queries)
    ("pipe_seq_train_dit_self", (1, 32760, 20, 128), 32760, "generic"),
    ("pipe_seq_train_dit_cross_text", (1, 17160, 40, 128), 512, "onekv"),
    ("pipe_seq_train_dit_cross_clip", (1, 17160, 40, 128), 257, "onekv"),
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


# this process's start: every line ends with the seconds since it
# (``elapsed_s``), which time the phases without a clock of their own
STARTED = time.perf_counter()


def say(phase: str, **fields) -> None:
    fields["elapsed_s"] = f"{time.perf_counter() - STARTED:.1f}"
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def time_ms(fn, reps: int, warm: bool = True) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up
    (``warm=False``: the caller has just run ``fn`` on these inputs)."""
    import torch
    if warm:
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


def fmt(x, spec=".3f"):
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


def max_err(got, ref):
    return (got.float() - ref.float()).abs().max().item()


def to_device(batch, device):
    import torch
    return {k: v if isinstance(v, float) else torch.as_tensor(v,
                                                              device=device)
            for k, v in batch.items()}


# the schedule ladders, card f32 against CPU f32: elementwise products of
# the same host scalars, so only a fused multiply-add's rounding differs
SCHED_TOL = 1e-5
# a cross-attention's key bias: its gradient, the sum over the keys of
# dk, nearly cancels (a softmax does not see a bias added to every key;
# only the key norm lets it through), so the bf16 rounding of dk dominates
# it in any run. Where a layout splits the queries (seq ranks) its partial
# dk round apart from one process's, and the bias is held to the
# reference together with its layer's weight, as one tensor
SOFTMAX_CANCELLED = re.compile(r".*cross_attn\.k(_img)?\.bias$")


def rel_l2(got, want, joint=False):
    """The relative L2 error of ``got`` against ``want``: ||got - want|| /
    ||want||, in float64 on ``got``'s device, the norm floored at 1e-30.

    Tensors, or sequences of tensors taken together as one vector: one
    number. Dicts {name: tensor}: {name: error} for each name of ``got``
    (``want`` may hold more); under ``joint`` each ``SOFTMAX_CANCELLED``
    bias is held together with its layer's weight instead, as one vector
    named "{bias}+weight" (a caller that prints the bias alone asks for it
    without ``joint``)."""
    import torch
    if isinstance(got, dict):
        out = {}
        for n in got:
            if joint and SOFTMAX_CANCELLED.match(n):
                w = n[:-len("bias")] + "weight"
                out[n + "+weight"] = rel_l2([got[n], got[w]],
                                            [want[n], want[w]])
            else:
                out[n] = rel_l2(got[n], want[n])
        return out
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    g = torch.cat([t.flatten().double() for t in got])
    w = torch.cat([t.flatten().to(g.device, torch.float64) for t in want])
    return ((g - w).norm() / w.norm().clamp_min(1e-30)).item()


# what the phases write, under the repository's build/ (which .gitignore
# lists): the mesh ranks' records, the trainer CLIs' checkpoints, the
# one-process pipeline steps' gradients, the serving meshes' inputs and
# exports
MESH_DIR = os.path.join(REPO, "build", "mesh")
TRAIN_CLI_MESH_DIR = os.path.join(REPO, "build", "train_cli_mesh")
TRAIN_CLI_PIPE_DIR = os.path.join(REPO, "build", "train_cli_pipe")
FULL_PIPE_REF = os.path.join(REPO, "build", "full_pipe_grads.pt")
FULL_PIPE_SEQ_REF = os.path.join(REPO, "build", "full_pipe_seq_grads.pt")
SERVING_DIR = os.path.join(REPO, "build", "mesh_serving")
FULL_SERVING_DIR = os.path.join(REPO, "build", "mesh_serving_full")

# the DiT's linears at the full Wan2.1 step: the CFG pair of 16,317 video
# tokens through q/k/v/o (5120 -> 5120), the FFN in (5120 -> 13824) and out
QLINEAR_ROWS = 2 * 16317
QLINEAR_SHAPES = (("dit_qkvo", 5120, 5120), ("dit_ffn_in", 5120, 13824),
                  ("dit_ffn_out", 13824, 5120))
# the dense int8 tensor-core peak of one H100 SXM
PEAK_INT8_OPS = 1979e12


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


def add_counts(*counts):
    """The sum of launch-count dicts, key by key."""
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def nonzero(counts):
    """A launch-count dict's nonzero entries as compact JSON."""
    return json.dumps({k: v for k, v in counts.items() if v}).replace(" ", "")
