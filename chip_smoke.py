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
     exact launch counts with CLIP's). The CPU sides of this clip, of
     ``small_wan22`` and of ``small_ti2v`` run from step 2 on in one
     spawned process of their own (``start_cpu_sides``), beside the card;
     the three are checked against them after the mesh phases;
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
The weights tooling and the track head (``cli/convert.py``,
``cli/verify_weights.py``, ``convert/{registry,manager,bundle}.py``,
``models/vggt/track.py``):
  * after ``train_cli_data``, ``small_verify``: on ``write_reference_layout``
    and ``write_wan22_layout`` (reduced widths, from a seed), each as a
    subprocess: ``cli.convert --variant wan21`` to a bundle, then at once
    ``cli.verify_weights`` on the raw layout (with ``--out_bundle``), on
    the bundle with ``--config_from``, on the Wan2.2 layout, and on the
    Wan2.1 layout with one fusion tensor removed: every phase ok and exit 0,
    equal raw and bundle latents, exit 1 with the census failed first;
  * then ``small_track``: the track head at reduced widths (8 heads of 48)
    on the card against the CPU within SLICE_TOL, exact d64 launches;
  * after step 7, ``full_verify``: verify_weights' census, finite, 2-step
    9-frame denoise with heads and heads checks on the resident full model,
    and the registry (its reference-layout base DiT detects as the 14B I2V
    entry); likewise the Wan2.2 expert (Control-Camera entry) in step 10,
    and in ``full_ti2v`` the TI2V-5B DiT, reloaded through
    ``ModelManager.load_model`` with a bit-equal step output, before the
    decode;
  * last, ``full_track``: the track head at full width from a seed
    (``TrackConfig()``, the feature-only DPT over 21 latent frames of
    VGGT's tokens at 336x592, so 81 frames, 256 points, 4 iterations):
    seconds, peak GB, the attention calls' seconds, exact launches, shapes
    and finiteness.
  The kernels are also held to their plain versions at FLF2V's text
  cross-attention (769 keys) and the track head's four attentions (8 heads
  of 48, padded to 64), with the kernel's time on padded inputs beside.
The single-card options (``models/wan/dit.py``'s latent pose adapters,
``Bicross.forward_temporal``, ``joint_forward(camera_token=, uncond=)``,
``schedulers/{ddim,continuous_ode}.py``):
  * after small_track, ``small_options``: at reduced widths, on the card in
    bf16 against the CPU in f32 within SLICE_TOL with exact launches, a
    standalone DiT forward with each of 'latent_split' and
    'latent_overall', ``joint_forward`` with the example path's pose
    encodings as camera tokens (V = 4f - 3) and with ``uncond`` (the
    bicross launches gone), ``forward_temporal`` with 6 geometry frames
    over 4 video frames; one ladder of each schedule on card tensors
    against the CPU within SCHED_TOL;
  * after full_windowed, ``full_options`` on full_slice's resident model
    (its bicross gates woken for the phase): one CFG-pair
    ``joint_forward`` at 336x592, 81 frames, plain, with camera tokens
    (2, 81, 9) and with ``uncond``; ``forward_temporal`` on one IRG
    block's shapes (T = R = 21, M = 782); one forward of a full-width
    Wan2.1-I2V-14B ``WanDiT`` with each latent method, its tensors the
    fusion DiT's and only the 25 adapters new: each run's seconds, peak
    GB, shapes, finiteness and exact launches;
  * kernel cells ``pose_split`` (onekv, (42, 777, 40, 128) over 777 keys)
    and ``bicross_temporal_{video_to_geometry,geometry_to_video}`` (onekv,
    D 96 padded, 782 and 777 keys).
The multi-GPU path (``parallel/``), with ranks that are spawned processes
sharing this one card over gloo (NCCL refuses two ranks on one device),
the collectives' data moving through staging buffers on the card that
every rank maps (CUDA IPC):
  * after small_options, ``small_meshes``: one spawn of ranks per world
    size (2, 4, 8), each running its meshes one after another --
    ``small_mesh``: the reduced slice's denoise on meshes of 2 ranks
    (1x2x1, Ulysses), 8 (2x2x2) and 4 (1x4x1, Ulysses: 2 heads over 4
    ranks take the ring), each against the CPU run of small_slice within
    SLICE_TOL, with exact launches on every rank, and which gloo
    collectives take CUDA tensors (``[gloo_cuda]``); and
    ``small_mesh_serving``: the serving options at reduced widths, each
    against the CPU's one-process run within SLICE_TOL with exact
    launches on every rank -- int8 and fp8 at 1x1x2 and 2x1x2, TeaCache
    (a skipped step, cut after a segment and resumed from rank 0's
    partial state) and the windows (split 2 | 1) at 1x2x1 with Ulysses,
    the Wan2.2 dual denoise and the HTTP server (two jobs as one batch,
    the other rank following, stopped through rank 0) at 1x1x2; and
    ``small_mesh_train``: one step of the train step with per-block
    recompute -- LoRA rank 4 and full fine-tuning at 1x1x2, LoRA at 1x2x1
    with Ulysses, at 1x4x1 with the ring and at 2x2x2 on a batch of 2 --
    each against the CPU's one-process f32 step of the same seeded model
    and batch (run in the background process) within TRAIN_TOL: the loss,
    every gradient and updated value gathered whole; exact launches on
    every rank, the backward kernels' included;
  * then ``full_mesh``, one spawn of 2 ranks: Ulysses and the ring as
    direct calls at the DiT self, bicross and VGGT global shapes against
    the one-process kernel on the same inputs; the full-width 2-step
    denoise with the heads, cut to 4 + 4 blocks, at 1x1x2 (the DiT's
    megatron splits) and at 1x2x1 with Ulysses, each against the same
    seeded model run once in this process, within SLICE_TOL, exact
    launches; seconds per step and peak GB per rank -- one card's, not
    multi-GPU times; ``full_mesh_train``, two jobs of the same spawn: two
    LoRA rank-16 steps with per-block recompute at full width, 4 + 4
    blocks, 336x592x81, batch 1, at 1x1x2 and at 1x2x1 with Ulysses,
    against the same seeded model and batches stepped in this process
    (losses and LoRA gradients gathered whole within TRAIN_TOL, exact
    launches, seconds per step and peak GB per rank); and
    ``train_cli_mesh``: ``cli.train``'s entry point on a 1x1x2 mesh
    (``--synthetic --mesh_model 2 --lora_rank 4``), 2 steps saved,
    resumed to 3; then the pipeline trainer's jobs: ``full_pipe``, one
    GPipe step of ``WanDiTConfig()`` cut to 4 blocks over 2 stages
    (M = 2, Bm = 1 at 480x832x81, full fine-tuning) against the same step
    in this process (the loss, every gradient within TRAIN_TOL, exact
    launches, seconds and peak GB per rank), and ``train_cli_pipe``,
    ``cli.train --synthetic --pipe_stages 2`` saved at 2 and resumed to
    3 (small_meshes' 2-rank spawn runs ``small_pipe``, the reduced step
    against the CPU's; its 4-rank spawn ``small_pipe_seq``, the same step
    on 2 stages x 2 seq ranks, the self-attention gathered and through
    Ulysses, against the same CPU step, and ``full_pipe_seq``, one step of
    ``WanDiTConfig()`` cut to 2 blocks on 2 stages x 2 seq ranks with
    Ulysses, M = 2, Bm = 1 at 480x832x81, against the same step in this
    process: the loss, every gradient within TRAIN_TOL, exact launches,
    seconds and peak GB per rank);
  * then ``full_mesh_serving``: the serve CLI's mesh at full width cut
    to 4 + 4 blocks, 1x1x2, through its entry points (rank 0 a
    ``GenerationServer`` over ``serve.make_batch_fn``, rank 1
    ``serve.follow``), rank 0 alone holding umT5, CLIP, the VAE and MoGe:
    the int8 model (quantized whole, then split) serving two jobs at
    336x592x81 as one batch and a TeaCache job, then the Wan2.2 server
    at 480x832x81 (``Wan22Sampler.generate_video(mesh=)``, the experts'
    parts swapping); seconds, s per step and peak GB per rank, exact
    launches, the exported clips; then ``wan22_both_resident`` in one
    process: two experts each of a full expert's part at M = 2 kept on
    the card beside umT5 (``place``), a clip with the tiled decode, its
    peak within the reserve;
  * kernel cells ``mesh_*`` (the DiT at 20 of 40 heads, a served batch's
    4 rows, Wan2.2's 32,760 tokens), ``ulysses_*`` (bicross at 6 of 12
    heads, VGGT global at 8 of 16; a window of 11 latent frames) and
    ``ring_*`` (the ring's stats calls at 2 seq ranks); train_kernel cells
    ``ulysses_train_*`` (the backward at the Ulysses head groups over the
    whole sequence) and ``ring_train_*`` (one hop of the ring's backward
    at 3 seq ranks, where 40 DiT heads do not divide: 7 latent frames a
    part), ``pipe_train_*`` (the pipeline's microbatch, Bm = 1 at
    480x832x81) and ``pipe_seq_train_*`` (its Ulysses head group of 20
    over the 32,760 tokens, and the cross-attentions of a seq rank's
    17,160 queries).
Then one JSON line with the kernels' numbers, and the device JSON line last.
Imports nothing of JAX.

    python3 chip_smoke.py --phases small_meshes,full_mesh_serving

runs the build and only the named phases (``ALONE``), and prints neither
the kernels line nor the device line.

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
                  ti2v_dit_cross_text=TI2V_5B.num_layers,
                  flf2v_dit_cross_text=FusionConfig().dit.num_layers)
    # the track head's: one launch a block a refinement iteration
    from fantasy_world_tpu_torch.models.vggt.track import TrackConfig
    tc = TrackConfig()
    layers.update({name: tc.iters * tc.depth for name, *_ in SHAPES
                   if name.startswith("track_")})
    # the options: one launch per adapter block, or per IRG block, of a
    # forward that takes them
    layers.update(pose_split=FusionConfig().dit.camera_adapter_end,
                  **{name: FusionConfig().num_irg for name, *_ in SHAPES
                     if name.startswith("bicross_temporal_")})
    layers.update(MESH_CELLS)
    per_kernel = {k: {"max_abs_err": 0.0, "by_shape": []} for k in fa.ROUTES}
    for name, (B, Lq, H, D), Lk, kernel in SHAPES:
        if fa.route(H, D, Lk) != kernel:
            raise AssertionError(f"{name} routes to {fa.route(H, D, Lk)}")
        q = torch.randn((B, Lq, H, D), generator=g, device=device).bfloat16()
        k = torch.randn((B, Lk, H, D), generator=g, device=device).bfloat16()
        v = torch.randn((B, Lk, H, D), generator=g, device=device).bfloat16()
        scale = D ** -0.5
        out = fa.flash_attention(q, k, v)
        # the reference is the plain version's warm-up; one timed call
        # after it (the plain versions are the slowest part of this phase)
        ref = fa.attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        err, tol = _max_err(out, ref), out_tol(ref)
        plain_ms = time_ms(lambda: fa.attention_plain(q, k, v, scale), 1,
                           warm=False)
        ms = time_ms(lambda: fa.flash_attention(q, k, v), 5)
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
        # below the kernel's head dim the wrapper copies q, k, v into a
        # zero-padded tensor first: the kernel alone on padded inputs
        dk = fa.kernel_dim(H, D, Lk)
        if dk != D:
            qp, kp, vp = (torch.nn.functional.pad(t, (0, dk - D))
                          for t in (q, k, v))
            y["padded_kernel_ms"] = time_ms(
                lambda: fa.launch(kernel, qp, kp, vp, scale), 5)
            del qp, kp, vp
        # the ring's calls take the stats forward: its output and (m2, l)
        # against the plain version's, and its time
        if name.startswith("ring_"):
            so, sm, sl = fa.flash_attention_stats(q, k, v)
            ro, rm, rl = fa.attention_plain_stats(q, k, v, scale)
            y["stats_max_abs_err"] = _max_err(so, ro)
            y["stats_rel_err"] = max(
                ((sm - rm).abs() / rm.abs().clamp_min(1.0)).max().item(),
                ((sl - rl).abs() / rl).max().item())
            if not (y["stats_max_abs_err"] <= out_tol(ro)
                    and y["stats_rel_err"] <= STATS_RTOL):
                raise AssertionError(f"{name}: stats {y['stats_max_abs_err']}"
                                     f", {y['stats_rel_err']}")
            y["stats_ms"] = time_ms(lambda: fa.flash_attention_stats(q, k, v),
                                    5)
            del so, sm, sl, ro, rm, rl
        say("kernel", shape=name, kernel=kernel, max_abs_err=f"{err:.3e}",
            bound=f"{tol:.3e}", ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}",
            online_ms=_fmt(y.get("online_ms")),
            padded_kernel_ms=_fmt(y.get("padded_kernel_ms")),
            stats_ms=_fmt(y.get("stats_ms")),
            tflops=f"{y['tflops']:.1f}",
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
    training shapes, one process's and the mesh trainer's; adds the stats
    and backward numbers to per_kernel."""
    import torch
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=device).manual_seed(1)
    for k in ("bwd_dq", "bwd_dkv"):
        per_kernel[k] = {"max_abs_err": 0.0, "by_shape": []}
    for name, (B, Lq, H, D), Lk, kernel in TRAIN_SHAPES + MESH_TRAIN_SHAPES:
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
        # beside the sum of the two kernels; each plain version was warmed
        # by its reference above and is timed once
        plain = {
            "stats": time_ms(lambda: fa.attention_plain_stats(q, k, v, scale),
                             1, warm=False),
            "bwd": time_ms(lambda: fa.attention_backward_plain(
                q, k, v, o, lse2, do, scale), 1, warm=False)}
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


def phase_small_slice(device):
    """Returns the CPU run's outputs, {name: f32 CPU tensor}."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    fcfg, pcfg, cpu_f, cpu_p, cond = small_slice_setup()
    (height, width, frames), steps = SMALL_GEOMETRY, SMALL_STEPS
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
                                 seed=SMALL_SEED,
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
    return outs["cpu"]


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


# the CPU sides of the reduced clips (f32, the kernels' plain versions):
# host work, run from the start in a process of its own beside the card's
# phases (``start_cpu_sides``), each collected by its phase (``cpu_side``)
CPU_SIDES = ("small_clip", "small_wan22", "small_ti2v", "small_mesh_train",
             "small_pipe")
_CPU_PENDING = {}


def _cpu_side(name):
    import torch
    t0 = time.perf_counter()
    out = globals()[f"{name}_run"](torch.device("cpu"), torch.float32)
    # what goes back to the parent is data: no function of this side's
    out = {k: v for k, v in out.items() if not callable(v)}
    out["seconds"] = time.perf_counter() - t0
    return out


def _cpu_side_init():
    import torch
    # two cores stay with the parent, which launches the card's work, and
    # the parent's own host work goes first where both want a core
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    os.nice(10)


def start_cpu_sides():
    """One spawned process (no CUDA) that runs every ``CPU_SIDES`` run in
    turn; returns its pool, for the caller to close."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(
        1, initializer=_cpu_side_init)
    for name in CPU_SIDES:
        _CPU_PENDING[name] = pool.apply_async(_cpu_side, (name,))
    return pool


def cpu_side(name):
    """``name``'s CPU run: the background process's result (its failure
    raised here), or run here when none was started."""
    pending = _CPU_PENDING.pop(name, None)
    return _cpu_side(name) if pending is None else pending.get()


SMALL_CLIP_RUN = (256, 384, 21, 2)     # height, width, frames, steps


def small_clip_run(dev, dtype):
    """One side of ``small_clip``: ``FantasyWorldSampler.generate_video``
    and ``export`` on ``dev`` in ``dtype``, the modules loaded from f32
    weights built on the CPU from a seed (the same in every process).
    Returns the checked outputs and the float decode of the latents (f32
    CPU tensors), the video, the launches, the exported paths and the
    tokenizer's kind."""
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
    fcfg, pcfg, t5c, clipc, vaec = small_clip_configs()
    ctors = {"fusion": (FusionModel, fcfg), "pose": (CameraPoseEncoder, pcfg),
             "t5": (T5Encoder, t5c), "clip": (CLIPVision, clipc),
             "vae": (WanVAE, vaec)}
    height, width, frames, steps = SMALL_CLIP_RUN
    g = torch.Generator("cpu").manual_seed(11)
    mods = {n: build(lambda: c(cfg), device="cpu", dtype=torch.float32,
                     generator=g) for n, (c, cfg) in ctors.items()}
    wake_zero_inits(mods["fusion"], g)
    if dev.type != "cpu":
        weights, mods = mods, {}
        for n, (c, cfg) in ctors.items():
            mods[n] = build(lambda: c(cfg), device=dev, dtype=dtype)
            mods[n].load_state_dict(weights[n].state_dict())
        del weights
    image, cams = clip_inputs(height, width, frames)
    out_root = os.path.join(REPO, "build", "clip_export")
    pipe = FantasyWorldPipeline(mods["fusion"], mods["pose"], t5=mods["t5"],
                                clip=mods["clip"], vae=mods["vae"])
    tok = install_tokenizer(pipe, t5c.vocab,
                            os.path.join(out_root, f"tokenizer_{dev.type}"))
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
    return {"t": {k: v.float().cpu() for k, v in got.items()},
            "decode": dec.float().cpu(), "video": video,
            "launches": launches, "paths": paths, "tok": tok}


def phase_small_clip(device):
    """``FantasyWorldSampler.generate_video`` and ``export`` at reduced
    widths, on the card in bf16 (kernels) and on the CPU in f32 (plain
    versions) from the same weights (``small_clip_run``): the latents, the
    prediction and the float decode within SLICE_TOL, exact launch counts
    with CLIP's. Runs the card side; returns the check, which takes the
    CPU side when called (after the mesh phases)."""
    import torch
    t0 = time.perf_counter()
    card = small_clip_run(device, torch.bfloat16)
    card_s = time.perf_counter() - t0
    return lambda: check_small_clip(card, card_s)


def check_small_clip(card, card_s):
    import shutil
    t0 = time.perf_counter()
    fcfg, _, _, clipc, _ = small_clip_configs()
    height, width, frames, steps = SMALL_CLIP_RUN
    cpu = cpu_side("small_clip")
    shutil.rmtree(os.path.join(REPO, "build", "clip_export"),
                  ignore_errors=True)
    errs = {k: _rel_l2([card["t"][k]], [cpu["t"][k]]) for k in cpu["t"]}
    errs["decode"] = _rel_l2([card["decode"]], [cpu["decode"]])
    want = expected_launches(fcfg, steps, clip=clipc)
    # the card side's seconds and this check's; the CPU side's apart
    say("small_clip", seconds=f"{card_s + time.perf_counter() - t0:.2f}",
        cpu_side_seconds=f"{cpu['seconds']:.2f}",
        tokenizer=card["tok"], image="example_png",
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


SMALL_WAN22_RUN = (256, 384, 21, 3)    # height, width, frames, steps


def small_wan22_run(dev, dtype):
    """One side of ``small_wan22``: ``Wan22Sampler.generate_video`` (with
    MoGe and an end image) and ``export`` on ``dev`` in ``dtype`` -- on the
    card the low expert in pinned host memory until the swap -- the modules
    loaded from f32 weights built on the CPU from a seed. Returns the
    checked outputs and the float decode (f32 CPU tensors), the video, the
    launches, the exported paths and the stages."""
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
    fcfg, t5c, vaec, mcfg = small_wan22_configs()
    ctors = {"high": (FusionModel, fcfg), "low": (FusionModel, fcfg),
             "t5": (T5Encoder, t5c), "vae": (WanVAE, vaec),
             "moge": (MoGe, mcfg)}
    height, width, frames, steps = SMALL_WAN22_RUN
    g = torch.Generator("cpu").manual_seed(13)
    mods = {n: build(lambda: c(cfg), device="cpu", dtype=torch.float32,
                     generator=g) for n, (c, cfg) in ctors.items()}
    for n in ("high", "low"):
        wake_zero_inits(mods[n], g)
    if dev.type != "cpu":
        weights, mods = mods, {}
        for n, (c, cfg) in ctors.items():
            mods[n] = build(lambda: c(cfg), device=dev, dtype=dtype)
            mods[n].load_state_dict(weights[n].state_dict())
        del weights
        pin_to_host(mods["low"])
    image, cams = clip_inputs(height, width, frames)
    end = np.ascontiguousarray(image[::-1])
    out_root = os.path.join(REPO, "build", "wan22_export")
    pipe = FantasyWorldPipeline(t5=mods["t5"], vae=mods["vae"])
    install_tokenizer(pipe, t5c.vocab,
                      os.path.join(out_root, f"tok_{dev.type}"))
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
    paths = Wan22Sampler.export(video, pred, os.path.join(out_root, str(dev)),
                                stride=8)
    got = check_outputs(fcfg, seen["latents"],
                        {k: torch.from_numpy(v) for k, v in pred.items()},
                        height, width, frames)
    return {"t": {k: v.float().cpu() for k, v in got.items()},
            "decode": dec.float().cpu(), "video": video,
            "launches": launches, "paths": paths, "stages": stages}


def phase_small_wan22(device):
    """``Wan22Sampler.generate_video`` at reduced widths with MoGe and an
    end image, 3 steps (t ~ 1000 and 909 on the high expert, t ~ 715 on
    the low one with the heads), on the card in bf16 -- the low expert in
    pinned host memory until the swap -- and on the CPU in f32 from the
    same weights (``small_wan22_run``): the latents, the prediction and
    the float decode within SLICE_TOL, exact launch counts with MoGe's.
    Runs the card side; returns the check, which takes the CPU side when
    called (after the mesh phases)."""
    import torch
    t0 = time.perf_counter()
    card = small_wan22_run(device, torch.bfloat16)
    card_s = time.perf_counter() - t0
    return lambda: check_small_wan22(card, card_s)


def check_small_wan22(card, card_s):
    import shutil
    t0 = time.perf_counter()
    fcfg, _, _, mcfg = small_wan22_configs()
    height, width, frames, steps = SMALL_WAN22_RUN
    cpu = cpu_side("small_wan22")
    shutil.rmtree(os.path.join(REPO, "build", "wan22_export"),
                  ignore_errors=True)
    errs = {k: _rel_l2([card["t"][k]], [cpu["t"][k]]) for k in cpu["t"]}
    errs["decode"] = _rel_l2([card["decode"]], [cpu["decode"]])
    want = expected_launches(fcfg, steps, moge=(mcfg, moge_tokens(
        mcfg, clip_inputs(height, width, frames)[0].shape[:2])))
    # the card side's seconds and this check's; the CPU side's apart
    say("small_wan22", seconds=f"{card_s + time.perf_counter() - t0:.2f}",
        cpu_side_seconds=f"{cpu['seconds']:.2f}",
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


def _verify_cmd(module, *argv):
    return [sys.executable, "-m", f"fantasy_world_tpu_torch.cli.{module}",
            *argv]


def phase_small_verify():
    """The weights tooling as a user runs it, each command a subprocess on
    the card: ``cli.convert --variant wan21`` of ``write_reference_layout``
    to a bundle; ``cli.verify_weights --variant wan21`` on the raw layout
    (with ``--out_bundle``: save, reload, bit-compare) and on the bundle
    with ``--config_from``; ``--variant wan22`` on ``write_wan22_layout``
    (``small_wan22``'s widths, the Reward-LoRAs merged); and the Wan2.1
    layout with one fusion tensor removed. Every report must have every
    phase ok and exit 0, the raw and bundle latents must be equal (sha256
    of their bytes), and the broken layout must exit 1 with the census the
    first phase to fail. The verifies run at once, the bundle's once the
    convert has written it."""
    import shutil
    import torch
    t0 = time.perf_counter()
    root = os.path.join(REPO, "build", "small_verify")
    shutil.rmtree(root, ignore_errors=True)
    wan, model = write_reference_layout(root)
    wan22, high, low = write_wan22_layout(root)
    fusion = torch.load(model, weights_only=True)
    gone = "IRGBlock.0.x_agg.norm1.weight"
    del fusion[gone]
    broken = os.path.join(root, "model_broken.pth")
    torch.save(fusion, broken)
    del fusion
    bundle = os.path.join(root, "wan21.bundle")
    write_s = time.perf_counter() - t0

    def report(name):
        return os.path.join(root, f"report_{name}.json")

    def verify(name, *argv):
        return subprocess.Popen(
            _verify_cmd("verify_weights", *argv, "--report", report(name)),
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    # the verifies that need no bundle run while the convert writes it
    convert = subprocess.Popen(_verify_cmd(
        "convert", "--variant", "wan21", "--wan_ckpt_path", wan,
        "--model_ckpt", model, "--out", bundle), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = {
        "raw": verify("raw", "--variant", "wan21", "--wan_ckpt_path", wan,
                      "--model_ckpt", model, "--out_bundle",
                      os.path.join(root, "verified.bundle")),
        "wan22": verify("wan22", "--variant", "wan22", "--wan_ckpt_path",
                        wan22, "--model_ckpt_high", high,
                        "--model_ckpt_low", low),
        "broken": verify("broken", "--variant", "wan21", "--wan_ckpt_path",
                         wan, "--model_ckpt", broken)}
    _, err = convert.communicate(timeout=600)
    convert_s = time.perf_counter() - t0 - write_s
    if convert.returncode != 0:
        raise AssertionError(f"cli.convert exit {convert.returncode}: "
                             f"{err[-2000:]}")
    procs["bundle"] = verify("bundle", "--variant", "wan21",
                             "--wan_ckpt_path", bundle, "--config_from",
                             bundle)
    out = {}
    for name, proc in procs.items():
        _, stderr = proc.communicate(timeout=600)
        with open(report(name)) as fh:
            out[name] = (proc.returncode, json.load(fh), stderr)
    shutil.rmtree(root, ignore_errors=True)

    def phases(rep):
        return "|".join(f"{p['name']}:{'ok' if p['ok'] else 'FAIL'}:"
                        f"{p['wall_s']}" for p in rep["phases"])
    digests = {name: next(p["detail"].get("latent_sha256") for p in
                          rep["phases"] if p["name"] == "denoise")
               for name, (_, rep, _) in out.items() if name != "broken"}
    say("small_verify", seconds=f"{time.perf_counter() - t0:.2f}",
        write_layouts_s=f"{write_s:.2f}", convert_s=f"{convert_s:.2f}",
        **{f"{name}_exit": rc for name, (rc, _, _) in out.items()},
        **{f"{name}_phases": phases(rep) for name, (_, rep, _) in
           out.items()},
        raw_bundle_latents_equal=digests["raw"] == digests["bundle"])
    for name in ("raw", "bundle", "wan22"):
        rc, rep, err = out[name]
        if rc != 0 or not rep["ok"] or not all(p["ok"] for p in
                                               rep["phases"]):
            raise AssertionError(f"verify_weights {name}: exit {rc}, "
                                 f"{phases(rep)}: {err[-2000:]}")
    if digests["raw"] != digests["bundle"]:
        raise AssertionError("verify_weights: the bundle's denoise latents "
                             "differ from the raw layout's")
    rc, rep, _ = out["broken"]
    failed = [p for p in rep["phases"] if not p["ok"]]
    if rc != 1 or not failed or failed[0]["name"] != "census:fusion" \
            or failed[0]["detail"].get("n_missing") != 1:
        raise AssertionError(f"verify_weights on a fusion file without "
                             f"{gone}: exit {rc}, {phases(rep)}")


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


def track_launches(tc, forwards=1):
    """d64 launches of the track head: per refinement iteration and block,
    time attention, virtual <- points, virtual self, points <- virtual."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    out = {k: 0 for k in fa.LAUNCHES}
    out["d64"] = forwards * tc.iters * tc.depth * 4
    return out


def phase_small_track(device):
    """The track head (``models/vggt/track.py``: the feature-only DPT, the
    correlation pyramid, 4 refinement iterations) at ``small_track_configs``
    on the card in bf16 against the same weights on the CPU in f32 through
    the plain versions: the feature maps, each iteration's displacement
    from the query points (its coordinates less the queries: the
    coordinates themselves are almost all query), vis and conf within
    SLICE_TOL (relative L2), exactly ``track_launches`` d64 launches. The
    flow head (coordinate and feature deltas) is scaled by 1e-2: each
    iteration's deltas feed the next one's sampling and feature update,
    and at the random init the CPU's own bf16 run of this head differs
    from its f32 run by 4.6e-2 in vis after 4 iterations, too near
    SLICE_TOL to tell a fault from rounding (4.4e-3 at the scale)."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.vggt.track import TrackHead
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    tc, dpt = small_track_configs()
    frames, ph, pw, points = 3, 6, 10, 32
    g = torch.Generator("cpu").manual_seed(9)
    cpu_head = build(lambda: TrackHead(tc, dpt), device="cpu",
                     dtype=torch.float32, generator=g)
    cpu_head.tracker.updateformer.flow_head.weight.data.mul_(1e-2)
    toks, q = track_inputs(dpt, frames, ph, pw, points, g)
    outs, launches = {}, None
    for dev, dtype in (("cpu", torch.float32), (device, torch.bfloat16)):
        head = cpu_head
        if dev != "cpu":
            head = build(lambda: TrackHead(tc, dpt), device=dev, dtype=dtype)
            head.load_state_dict(cpu_head.state_dict())
            fa.reset_launch_counts()
        with torch.no_grad():
            fmaps = head.feature_extractor([t.to(dev, dtype) for t in toks],
                                           (ph, pw), 5)
            coords, vis, conf = head.tracker(q.to(dev), fmaps)
        if dev != "cpu":
            torch.cuda.synchronize()
            launches = dict(fa.LAUNCHES)
        start = q.to(dev)[:, None]
        outs[dev] = {"fmaps": fmaps, "vis": vis, "conf": conf,
                     **{f"disp{i}": c - start for i, c in enumerate(coords)}}
        outs[dev] = {k: v.float().cpu() for k, v in outs[dev].items()}
    errs = {k: ((outs[device][k] - ref).norm()
                / ref.norm().clamp_min(1e-12)).item()
            for k, ref in outs["cpu"].items()}
    want = track_launches(tc)
    T = 1 + 4 * (frames - 1)
    say("small_track", seconds=f"{time.perf_counter() - t0:.2f}",
        frames=T, points=points, fmaps_shape="x".join(
            map(str, outs[device]["fmaps"].shape)),
        device_vs_cpu_rel_l2=json.dumps(
            {k: float(f"{v:.3e}") for k, v in errs.items()}).replace(" ", ""),
        launches=json.dumps({k: v for k, v in launches.items() if v}
                            ).replace(" ", ""))
    if tuple(outs[device]["disp3"].shape) != (1, T, points, 2):
        raise AssertionError(f"track shape {outs[device]['disp3'].shape}")
    bad = {k: v for k, v in errs.items() if not v <= SLICE_TOL}
    if bad:
        raise AssertionError(f"reduced track head disagrees with the CPU "
                             f"path beyond {SLICE_TOL}: {bad}")
    if launches != want:
        raise AssertionError(f"track launches {launches} != {want}")


# ---------------------------------------------------------------------------
# the single-card options: latent pose injection, camera tokens, the uncond
# bicross skip, temporal bicross, the DDIM and continuous-ODE schedules
# ---------------------------------------------------------------------------

POSE_METHODS = ("latent_split", "latent_overall")
# the schedule ladders, card f32 against CPU f32: elementwise products of
# the same host scalars, so only a fused multiply-add's rounding differs
SCHED_TOL = 1e-5


def no_launches():
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    return {k: 0 for k in fa.LAUNCHES}


def pose_dit_launches(dcfg, tokens, frames):
    """Kernel launches of one ``WanDiT.forward`` with Plucker features (one
    token each per video token) over ``tokens`` tokens in ``frames``
    latent frames: per block the self-attention (generic) and the text and
    CLIP cross-attentions (onekv); on each adapter block the pose
    attention, over one frame's Plucker tokens ('latent_split') or all of
    them ('latent_overall'), on the route those keys take."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    n = dcfg.num_layers
    out = no_launches()
    out["generic"] += n
    out["onekv"] += n * (2 if dcfg.has_image_input else 1)
    keys = (tokens // frames if dcfg.pose_inject_method == "latent_split"
            else tokens)
    out[fa.route(dcfg.num_heads, dcfg.head_dim, keys)] += min(
        dcfg.camera_adapter_end, n)
    return out


def joint_launches(cfg, uncond=False):
    """Kernel launches of one ``joint_forward`` without the heads: a
    denoise step's (``expected_launches``) without the camera trunk; with
    ``uncond`` the IRG blocks' two bicross attentions each are gone."""
    out = expected_launches(cfg, 1)
    out["onekv"] -= 4 * cfg.vggt.camera_head.trunk_depth
    if uncond:
        out["generic"] -= 2 * len(cfg.xattn_set())
    return out


def temporal_launches(bcfg, T, S, R, M):
    """``Bicross.forward_temporal``: the video frames over their windows'
    W * M geometry tokens, and back over S video tokens."""
    import math
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    out = no_launches()
    W = math.ceil(R / T)
    for keys in (W * M, S):
        out[fa.route(bcfg.num_heads, bcfg.head_dim, keys)] += 1
    return out


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


def small_options_setup(seed=31):
    """The CPU f32 models and inputs of ``small_options``: the reduced
    fusion model (``small_configs``) with its zero-initialised gates and
    adapters woken, a standalone DiT of its widths per latent pose method
    (adapters woken), and the inputs: a CFG pair at
    ``SMALL_OPTION_GEOMETRY``, Plucker features, the example path's pose
    encodings for 4f - 3 views, temporal bicross streams."""
    import dataclasses
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.dit import WanDiT
    fcfg, _ = small_configs()
    g = torch.Generator("cpu").manual_seed(seed)
    fusion = build(lambda: FusionModel(fcfg), device="cpu",
                   dtype=torch.float32, generator=g)
    wake_zero_inits(fusion, g)
    dits = {}
    for method in POSE_METHODS:
        dcfg = dataclasses.replace(fcfg.dit, pose_inject_method=method)
        dits[method] = build(lambda: WanDiT(dcfg), device="cpu",
                             dtype=torch.float32, generator=g)
        for blk in dits[method].blocks:
            wake_pose_adapter(blk.cross_attn.processor, g)
    height, width, frames = SMALL_OPTION_GEOMETRY
    d = fcfg.dit
    f, lh, lw = (frames - 1) // 4 + 1, height // 8, width // 8
    tokens = f * (lh // 2) * (lw // 2)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale
    T, S, R, M = SMALL_TEMPORAL
    inputs = {
        "latents": randn(2, d.out_dim, f, lh, lw),
        "timestep": torch.full((2,), 800.0),
        "context": randn(2, 16, d.text_dim),
        "clip": randn(2, 257, d.clip_feature_dim),
        "y": randn(2, d.in_dim - d.out_dim, f, lh, lw),
        "plucker": randn(2, tokens, d.plucker_dim, scale=0.3),
        "camera_token": pose_encodings(height, width, 4 * f - 3).expand(
            2, -1, -1).contiguous(),
        "x1": randn(2, T * S, fcfg.bicross.m1_dim),
        "x2": randn(2, R * M, fcfg.bicross.m2_dim),
        "frames": f, "tokens": tokens}
    return fusion, dits, inputs


def small_option_runs(fusion, dits, inputs, device, dtype):
    """Each option once on ``device`` in ``dtype``: {name: (outputs (f32 on
    the host), launches)}. ``fusion``/``dits`` hold the weights (copied to
    ``device`` unless already there)."""
    import torch
    from fantasy_world_tpu_torch.ops import flash_attention as fa

    def to(t):
        return (t.to(device, dtype) if isinstance(t, torch.Tensor)
                and t.is_floating_point() else t)
    x = {k: to(v) for k, v in inputs.items()}
    x["timestep"] = inputs["timestep"].to(device)
    x["camera_token"] = inputs["camera_token"].to(device)
    joint = (x["latents"], x["timestep"], x["context"], x["clip"], x["y"])
    T, S, R, M = SMALL_TEMPORAL
    runs = {
        "camera_token": lambda: fusion.joint_forward(
            *joint, plucker_fea=x["plucker"],
            camera_token=x["camera_token"])[0],
        "uncond": lambda: fusion.joint_forward(
            *joint, plucker_fea=x["plucker"], uncond=True)[0],
        "temporal": lambda: fusion.bicross[0].forward_temporal(
            x["x1"], x["x2"], T, S, R, M)}
    for method, dit in dits.items():
        runs[method] = (lambda dit=dit: dit(
            x["latents"], x["timestep"], x["context"], clip_feature=x["clip"],
            y=x["y"], plucker_fea=x["plucker"]))
    out = {}
    with torch.no_grad():
        for name, run in runs.items():
            before = dict(fa.LAUNCHES)
            got = run()
            got = got if isinstance(got, tuple) else (got,)
            out[name] = ([t.float().cpu() for t in got],
                         {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES})
    return out


def small_option_launches(fusion, dits, inputs):
    """What ``small_option_runs`` should launch on the card."""
    cfg = fusion.cfg
    want = {"camera_token": joint_launches(cfg),
            "uncond": joint_launches(cfg, uncond=True),
            "temporal": temporal_launches(cfg.bicross, *SMALL_TEMPORAL)}
    for method, dit in dits.items():
        want[method] = pose_dit_launches(dit.cfg, inputs["tokens"],
                                         inputs["frames"])
    return want


def scheduler_ladders(device, steps=10, seed=37):
    """One ladder of each of the DDIM and continuous-ODE schedules on f32
    tensors on ``device``: ``add_noise`` at the first step, then ``step``
    down the ladder with 0.5 x + 0.1 n as the model output. Returns {name:
    final sample on the host}."""
    import torch
    from fantasy_world_tpu_torch.schedulers import (ContinuousODEScheduler,
                                                    EnhancedDDIMScheduler)
    g = torch.Generator("cpu").manual_seed(seed)
    clean, noise, n2 = (torch.randn((2, 16, 6, 32, 48), generator=g)
                        .to(device) for _ in range(3))
    out = {}
    for name, sched in (("ddim", EnhancedDDIMScheduler()),
                        ("continuous_ode", ContinuousODEScheduler())):
        sched.set_timesteps(steps)
        x = sched.add_noise(clean, noise, 0)
        for i in range(steps):
            x = sched.step(0.5 * x + 0.1 * n2, i, x)
        out[name] = x.cpu()
    return out


def phase_small_options(device):
    """The options at reduced widths, on the card in bf16 against the CPU
    in f32 (plain versions) within SLICE_TOL, exact launches: a standalone
    DiT forward with each latent pose method, ``joint_forward`` with the
    example path's pose encodings as camera tokens and with ``uncond``,
    ``forward_temporal`` on an uneven split; then one ladder of each
    schedule on card tensors against the CPU within SCHED_TOL."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.dit import WanDiT
    t0 = time.perf_counter()
    fusion, dits, inputs = small_options_setup()
    ref = small_option_runs(fusion, dits, inputs, "cpu", torch.float32)
    want = small_option_launches(fusion, dits, inputs)
    dev_fusion = build(lambda: FusionModel(fusion.cfg), device=device,
                       dtype=torch.bfloat16)
    dev_fusion.load_state_dict(fusion.state_dict())
    dev_dits = {}
    for method, dit in dits.items():
        dev_dits[method] = build(lambda: WanDiT(dit.cfg), device=device,
                                 dtype=torch.bfloat16)
        dev_dits[method].load_state_dict(dit.state_dict())
    got = small_option_runs(dev_fusion, dev_dits, inputs, device,
                            torch.bfloat16)
    errs, bad = {}, []
    for name, (outs, launches) in got.items():
        errs[name] = max(_rel_l2([o], [r])
                         for o, r in zip(outs, ref[name][0]))
        if launches != want[name]:
            bad.append(f"{name}: launches {launches} != {want[name]}")
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            bad.append(f"{name}: non-finite")
    sched_ref = scheduler_ladders("cpu")
    sched = scheduler_ladders(device)
    sched_errs = {k: _rel_l2([sched[k]], [v])
                  for k, v in sched_ref.items()}
    say("small_options", seconds=f"{time.perf_counter() - t0:.2f}",
        device_vs_cpu_rel_l2=json.dumps(
            {k: float(f"{v:.3e}") for k, v in errs.items()}).replace(" ", ""),
        scheduler_rel_l2=json.dumps(
            {k: float(f"{v:.3e}") for k, v in sched_errs.items()}
        ).replace(" ", ""),
        launches=json.dumps({k: {r: n for r, n in v[1].items() if n}
                             for k, v in got.items()}).replace(" ", ""))
    bad += [f"{k}: {v} > {SLICE_TOL}" for k, v in errs.items()
            if not v <= SLICE_TOL]
    bad += [f"{k}: {v} > {SCHED_TOL}" for k, v in sched_errs.items()
            if not v <= SCHED_TOL]
    if bad:
        raise AssertionError("small_options: " + "; ".join(bad))
    del dev_fusion, dev_dits
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# multi-GPU (parallel/): ranks that share this one card over gloo
# ---------------------------------------------------------------------------

# NCCL refuses two ranks on one device, so the mesh phases run their ranks
# as spawned processes that share the card over gloo: gloo meets them at
# barriers, and a collective's data moves through staging buffers on the
# card that every rank maps (CUDA IPC, parallel/distributed.py). The mesh's
# math and its kernel launches are checked; its times are one card's, not
# multi-GPU times. Each rank writes what it found into MESH_DIR. One
# spawn of ranks runs several jobs in turn (``mesh_jobs``): its ranks'
# start (the interpreter, torch, the card, the process group) costs more
# than a reduced mesh's whole denoise.
MESH_DIR = os.path.join(REPO, "build", "mesh")
# full_mesh's denoises at (1, 1, 2) and (1, 2, 1): full width, 4 PCB + 4
# IRG blocks (a Ulysses mesh replicates the weights on each rank, two of
# them on one card; the tensor split's fault would show in any block)
MESH_DEPTH = (8, 4)
# the running job's prefix of its files in MESH_DIR (``_jobs_rank``)
MESH_TAG = ""


def mesh_path(name: str, tag=None) -> str:
    """The file ``name`` of job ``tag`` in MESH_DIR (this rank's running
    job's when None)."""
    return os.path.join(MESH_DIR, (MESH_TAG if tag is None else tag) + name)


def _jobs_rank(rank, jobs):
    """Each ``(tag, fn, args)`` of ``jobs`` in turn on this rank,
    ``fn(rank, *args)`` writing its files under ``tag``; between two jobs
    their card memory and the shared staging buffers are given back."""
    global MESH_TAG
    import torch
    from fantasy_world_tpu_torch.parallel import distributed
    for tag, fn, args in jobs:
        MESH_TAG = tag
        t0 = time.perf_counter()
        fn(rank, *args)
        gc.collect()
        distributed.release_shared()
        torch.cuda.empty_cache()
        if rank == 0:
            say("mesh_job", job=tag.rstrip("_"),
                seconds=f"{time.perf_counter() - t0:.2f}")
    MESH_TAG = ""


def mesh_jobs(world, jobs):
    """``jobs`` [(tag, fn, args)] one after another on ``world`` ranks
    spawned once on this card over gloo (``_jobs_rank``); then {tag: each
    rank's JSON record}."""
    from fantasy_world_tpu_torch.parallel.distributed import spawn
    os.makedirs(MESH_DIR, exist_ok=True)
    for name in os.listdir(MESH_DIR):
        os.remove(os.path.join(MESH_DIR, name))
    spawn(_jobs_rank, world, jobs, backend="gloo", device="cuda")
    records = {}
    for tag, _, _ in jobs:
        records[tag] = []
        for r in range(world):
            with open(mesh_path(f"rank{r}.json", tag)) as fh:
                records[tag].append(json.load(fh))
    return records


def mesh_run(fn, world, *args):
    """``fn(rank, *args)`` in ``world`` spawned ranks on this card over
    gloo; then each rank's JSON record (``MESH_DIR/rank{r}.json``)."""
    return mesh_jobs(world, [("", fn, args)])[""]


def _rank_setup():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    fa.build_kernels()          # loads what the parent built
    return torch.device("cuda", torch.cuda.current_device())


def _rank_record(rank, **fields):
    with open(mesh_path(f"rank{rank}.json"), "w") as fh:
        json.dump(fields, fh)


def gloo_cuda_probe():
    """Which gloo collectives take CUDA tensors in this torch (the mesh
    layer does not use them on CUDA tensors whatever the answer: ranks that
    share the card meet in CUDA IPC staging buffers): {op: "ok" or the
    error's first line}."""
    import torch
    import torch.distributed as dist
    n = dist.get_world_size()
    x = torch.ones(4, device="cuda", dtype=torch.bfloat16)
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(n)], x),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(2 * n, device="cuda"), torch.ones(2 * n,
                                                          device="cuda")),
    }
    out = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 -- reported, not relied on
            out[name] = str(e).splitlines()[0][:80]
        dist.barrier()
    return out


# How each sequence-parallel attention of a mesh runs -- (DiT self, VGGT
# global, bicross both ways) -- written out, not asked of the port's
# dispatch, so that a wrong dispatch shows as wrong launches. Keyed by the
# config (small_configs: 2 heads everywhere; FusionConfig(): DiT 40, VGGT
# 16, bicross 12), the mesh and Ulysses. "local": one seq rank, nothing
# split; "gather": the keys gathered (no Ulysses); "ulysses": the heads
# divide by the seq ranks (the DiT's over its 1/M model share); "ring":
# they do not.
MESH_MODES = {
    ("small", (1, 2, 1), True): ("ulysses", "ulysses", "ulysses"),
    ("small", (2, 2, 2), False): ("gather", "gather", "gather"),
    ("small", (1, 4, 1), True): ("ring", "ring", "ring"),
    ("small", (2, 1, 2), False): ("local", "local", "local"),
    ("small", (1, 2, 2), True): ("ring", "ulysses", "ulysses"),
    ("small", (4, 1, 1), False): ("local", "local", "local"),
    # small_mesh_serving: int8 / fp8, Wan2.2 (same heads) and the server
    # at 1x1x2; the windows of 3 latent frames (split 2 | 1) at 1x2x1
    ("small", (1, 1, 2), False): ("local", "local", "local"),
    ("small_window", (1, 2, 1), True): ("ulysses", "ulysses", "ulysses"),
    # tools/torch_mesh_check.py's windows over 4 cards
    ("small_window", (1, 2, 2), True): ("ring", "ulysses", "ulysses"),
    ("full", (1, 1, 2), False): ("local", "local", "local"),
    ("full", (1, 2, 1), True): ("ulysses", "ulysses", "ulysses"),
    ("full", (1, 1, 4), False): ("local", "local", "local"),
    ("full", (1, 4, 1), True): ("ulysses", "ulysses", "ulysses"),
}


def attention_mode_launches(mode, H, D, q_split, kv_split):
    """{launch key: count} of one attention of this rank run as ``mode``
    (``MESH_MODES``)."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    if mode in ("local", "gather"):
        return {fa.route(H, D, kv_split.length): 1}
    if mode == "ulysses":
        return {fa.route(H // q_split.n, D, kv_split.length): 1}
    if mode == "ring":
        return {fa.route(H, D, max(kv_split.sizes)) + "_stats": kv_split.n}
    raise ValueError(mode)


def mesh_launches(cfg, fhw, shape, modes, steps, rank, text_len, skipped=0,
                  heads=True):
    """Kernel launches of one rank of a ``shape`` mesh over a denoise of
    ``steps`` steps with the heads on the last (rank 0's): per DiT block
    its self-attention (seq-parallel) and cross-attentions at 1/M of the
    heads, per IRG block frame attention (local) and global attention
    (seq-parallel), per coupled block bicross both ways (seq-parallel);
    the camera trunk on rank 0. ``modes``: a ``MESH_MODES`` entry.
    ``skipped``: TeaCache steps whose block stack did not run; ``heads``
    False: no heads step (a window's forward)."""
    from collections import Counter

    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.parallel import sharding
    f, h, w = fhw
    d, s, m = shape
    psi = cfg.vggt.aggregator.patch_start_idx
    sizes = tuple(len(c) for c in np.array_split(np.arange(f), s))
    seq_index = int(np.unravel_index(rank, shape)[1])
    frames = sharding.TokenSplit(None, sizes, seq_index)
    s_dit, s_agg = frames.scaled(h * w), frames.scaled(h * w + psi)
    dc, bc = cfg.dit, cfg.bicross
    vb = cfg.vggt.aggregator.block_cfg
    hd = dc.num_heads // m
    step = Counter()
    m_self, m_glob, m_bi = modes
    self_attn = attention_mode_launches(m_self, hd, dc.head_dim, s_dit,
                                        s_dit)
    glob = attention_mode_launches(m_glob, vb.num_heads, vb.head_dim, s_agg,
                                   s_agg)
    v2g = attention_mode_launches(m_bi, bc.num_heads, bc.head_dim, s_dit,
                                  s_agg)
    g2v = attention_mode_launches(m_bi, bc.num_heads, bc.head_dim, s_agg,
                                  s_dit)
    for _ in range(dc.num_layers):
        step.update(self_attn)
        step[fa.route(hd, dc.head_dim, text_len)] += 1
        if dc.has_image_input:
            step[fa.route(hd, dc.head_dim, 257)] += 1
    for i in range(cfg.num_irg):
        step[fa.route(vb.num_heads, vb.head_dim, h * w + psi)] += 1
        step.update(glob)
        if i in cfg.xattn_set():
            step.update(v2g)
            step.update(g2v)
    out = {k: 0 for k in fa.LAUNCHES}
    for k, v in step.items():
        out[k] += v * (steps - skipped)
    if rank == 0 and heads:
        out["onekv"] += 4 * cfg.vggt.camera_head.trunk_depth
    return out


def mesh_window_launches(cfg, hw, frames, window, shape, modes, steps, rank,
                         text_len):
    """``mesh_launches`` of a sliding-window denoise over ``frames`` latent
    frames in windows of ``window`` = (size, stride): each window a
    forward over its frames, no heads."""
    from fantasy_world_tpu_torch.pipelines.temporal_tiler import window_plan
    return _add(*(mesh_launches(cfg, (t1 - t0, *hw), shape, modes, steps,
                                rank, text_len, heads=False)
                  for t0, t1 in window_plan(frames, *window)))


def small_mesh_denoise(dev, mesh, ulysses):
    """The reduced slice's denoise as this rank's part of ``mesh``: (rank
    0's outputs as f32 CPU tensors, else None; the launches; seconds)."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    fcfg, pcfg, cpu_f, cpu_p, cond = small_slice_setup()
    (height, width, frames) = SMALL_GEOMETRY
    fus = build(lambda: FusionModel(fcfg), device=dev, dtype=torch.bfloat16)
    fus.load_state_dict(cpu_f.state_dict())
    pose = build(lambda: CameraPoseEncoder(pcfg), device=dev,
                 dtype=torch.bfloat16)
    pose.load_state_dict(cpu_p.state_dict())
    pipe = FantasyWorldPipeline(fus, pose)
    pipe.shard(mesh)
    pl = pipe.encode_plucker(cond[4])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fa.reset_launch_counts()
    lat, pred = pipe.denoise(*cond[:4], height, width, num_frames=frames,
                             num_inference_steps=SMALL_STEPS, seed=SMALL_SEED,
                             plucker_fea=pl, mesh=mesh, ulysses=ulysses)
    torch.cuda.synchronize()
    seconds, launches = time.perf_counter() - t0, dict(fa.LAUNCHES)
    got = None
    if mesh.rank == 0:
        got = {k: v.float().cpu() for k, v in check_outputs(
            fcfg, lat, pred, height, width, frames).items()}
    return got, launches, seconds


def _small_mesh_rank(rank, shape, ulysses, probe):
    import torch
    from fantasy_world_tpu_torch.parallel import sharding
    dev = _rank_setup()
    record = {"gloo_cuda": gloo_cuda_probe() if probe else None}
    got, launches, seconds = small_mesh_denoise(
        dev, sharding.make_mesh(*shape), ulysses)
    record.update(launches=launches, seconds=seconds)
    if rank == 0:
        torch.save(got, mesh_path("outputs.pt"))
    _rank_record(rank, **record)


# small_mesh's meshes: (shape, Ulysses); 2 heads do not divide by 4 seq
# ranks, so (1, 4, 1) runs the ring
SMALL_MESH_RUNS = (((1, 2, 1), True), ((2, 2, 2), False), ((1, 4, 1), True))


def check_small_mesh(shape, uly, records, cpu_outs):
    """small_mesh's denoise at ``shape`` (its ranks' ``records`` and rank
    0's outputs) against the CPU's one-process run (``cpu_outs``,
    small_slice's), and every rank's launches exact. Returns the launches,
    all ranks summed."""
    import torch
    fcfg, _ = small_configs()
    height, width, frames = SMALL_GEOMETRY
    fhw = ((frames - 1) // 4 + 1, height // 16, width // 16)
    world = len(records)
    got = torch.load(mesh_path("outputs.pt", "mesh" + mesh_tag(shape)))
    errs = {k: ((got[k] - ref).norm() / ref.norm().clamp_min(1e-12)
                ).item() for k, ref in cpu_outs.items()}
    launch_err = [r for r in range(world) if records[r]["launches"]
                  != mesh_launches(fcfg, fhw, shape,
                                   MESH_MODES["small", shape, uly],
                                   SMALL_STEPS, r, 16)]
    probe = records[0]["gloo_cuda"]
    if probe:
        say("gloo_cuda", **probe)
    say("small_mesh", mesh="x".join(map(str, shape)), ulysses=uly,
        ranks=world,
        rank_denoise_seconds="|".join(f"{r['seconds']:.2f}"
                                      for r in records),
        device_vs_cpu_rel_l2=json.dumps(
            {k: float(f"{v:.3e}") for k, v in errs.items()}).replace(
                " ", ""),
        rank0_launches=_nonzero(records[0]["launches"]))
    bad = {k: v for k, v in errs.items() if not v <= SLICE_TOL}
    if bad:
        raise AssertionError(f"small_mesh {shape}: beyond {SLICE_TOL} "
                             f"of the CPU: {bad}")
    if launch_err:
        raise AssertionError(
            f"small_mesh {shape}: ranks {launch_err} launched "
            f"{[records[r]['launches'] for r in launch_err]}")
    total = {}
    for r in records:
        total = _add(total, r["launches"])
    return total


# the full width's sequence-parallel attentions, 2 seq ranks: 21 latent
# frames split 11 | 10, 777 video and 782 geometry tokens a frame
MESH_ATTENTIONS = [
    # name, (B, H, D), (q tokens a frame, k tokens a frame)
    ("dit_self", (2, 40, 128), (777, 777)),
    ("bicross_video_to_geometry", (2, 12, 96), (777, 782)),
    ("vggt_global", (2, 16, 64), (782, 782)),
]


def mesh_attention_calls(dev, axis, reps):
    """Each MESH_ATTENTIONS shape through Ulysses and the ring over the
    ranks of ``axis`` (the 21 frames split over them), the whole inputs
    drawn from one seed on every rank. Rank 0 returns one row per call:
    the gathered output's error against the one-process kernel on the same
    inputs, and both times (host clock around a synchronised call, after
    every rank met at a barrier)."""
    import torch
    import torch.distributed as dist
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.parallel import ring, sharding, ulysses
    frames = sharding.even_split(21, axis)
    out = []
    for name, (B, H, D), (tq, tk) in MESH_ATTENTIONS:
        g = torch.Generator(device=dev).manual_seed(11)
        qs, ks = frames.scaled(tq), frames.scaled(tk)
        q = torch.randn((B, qs.length, H, D), generator=g, device=dev
                        ).bfloat16()
        k, v = (torch.randn((B, ks.length, H, D), generator=g, device=dev
                            ).bfloat16() for _ in range(2))
        ql, kl, vl = qs.take(q), ks.take(k), ks.take(v)
        ref = fa.flash_attention(q, k, v) if axis.index == 0 else None
        for method in ("ulysses", "ring"):
            def call():
                if method == "ulysses":
                    return ulysses.ulysses_attention(ql, kl, vl, q_split=qs,
                                                     kv_split=ks)
                return ring.ring_attention(ql, kl, vl, kv_split=ks)
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                dist.barrier(group=axis.group)
                t0 = time.perf_counter()
                o = call()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            whole = qs.gather(o)
            if axis.index == 0:
                out.append({"shape": name, "method": method,
                            "max_abs_err": _max_err(whole, ref),
                            "err_bound": out_tol(ref),
                            "ms": float(np.median(times))})
            del o, whole
        if axis.index == 0:
            ms = time_ms(lambda: fa.flash_attention(q, k, v), reps)
            for row in out[-2:]:
                row["one_process_ms"] = ms
        del q, k, v, ref
        torch.cuda.empty_cache()
    return out


def mesh_norm_check(dev, axis, tokens=16317):
    """The DiT's q/k RMS norm as its blocks call it on a column split
    (``models/wan/dit.py:_norm``: the sums of squares summed over the model
    group), at the DiT self shape (2, tokens, 5120) in bf16 with columns of
    scale 0.5 to 2 (a projection's channels differ in size), this rank's
    columns gathered, against the one-process norm: (max abs error, its
    bound). The bound is OUT_RTOL of the largest value, a few bf16 ulps
    there: the two sides sum the squares in another order, and a rounding
    may flip. A norm taken over each rank's own columns is off by tens of
    percent here. Whole-model denoise checks cannot see that fault: a
    random model's 2-step denoise amplifies every rounding difference
    to a few 1e-2, and the wrong norm lands there too."""
    import torch
    from fantasy_world_tpu_torch.models.wan import dit
    from fantasy_world_tpu_torch.ops.norms import rms_norm
    from fantasy_world_tpu_torch.parallel import sharding
    g = torch.Generator(device=dev).manual_seed(3)
    x = (torch.randn((2, tokens, 5120), generator=g, device=dev)
         * torch.linspace(0.5, 2.0, 5120, device=dev)).bfloat16()
    w = (1 + 0.1 * torch.randn(5120, generator=g, device=dev)).bfloat16()
    ref = rms_norm(x, w, 1e-6)
    got = sharding.gather_columns(
        dit._norm(sharding.local_columns(x, axis), w, 1e-6, axis), axis)
    return _max_err(got, ref), OUT_RTOL * ref.float().abs().max().item()


def _mesh_attention_rank(rank, reps):
    import torch.distributed as dist
    from fantasy_world_tpu_torch.parallel import sharding
    dev = _rank_setup()
    axis = sharding.Axis(dist.group.WORLD, dist.get_world_size(), rank)
    err, bound = mesh_norm_check(dev, axis)
    _rank_record(rank, calls=mesh_attention_calls(dev, axis, reps),
                 norm={"max_abs_err": err, "err_bound": bound})


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


def mesh_denoise(device, cfg, seed, mesh=None, ulysses=False):
    """Build the fusion model and the pose encoder on the card from
    ``seed`` (sharded over ``mesh``), then the ``MESH_STEPS``-step denoise
    with the heads on the full width's conditioning. Returns (latents,
    prediction | None, seconds per step, peak GB, launches)."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.camera import (
        CameraPoseEncoder, CameraPoseEncoderConfig)
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    height, width, frames = MESH_GEOMETRY
    g = torch.Generator(device=device).manual_seed(seed)
    fusion = build(lambda: FusionModel(cfg), device=device,
                   dtype=torch.bfloat16, generator=g, mesh=mesh)
    pose = build(lambda: CameraPoseEncoder(CameraPoseEncoderConfig()),
                 device=device, dtype=torch.bfloat16, generator=g)
    pipe = FantasyWorldPipeline(fusion, pose)
    cond = conditioning(cfg.dit, height, width, frames,
                        torch.Generator("cpu").manual_seed(seed), 512)
    pl = pipe.encode_plucker(cond[4])
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(MESH_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    events[0].record()
    kw = {} if mesh is None else {"mesh": mesh, "ulysses": ulysses}
    lat, pred = pipe.denoise(*cond[:4], height, width, num_frames=frames,
                             num_inference_steps=MESH_STEPS, seed=seed,
                             plucker_fea=pl,
                             progress_callback=lambda i, n: events[i].record(),
                             **kw)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    steps = [events[i].elapsed_time(events[i + 1]) / 1e3
             for i in range(MESH_STEPS)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    return lat, pred, steps, peak, launches


def _full_mesh_rank(rank, shape, ulysses, depth, seed):
    import torch
    from fantasy_world_tpu_torch.parallel import sharding
    dev = _rank_setup()
    cfg = mesh_fusion_config(depth)
    mesh = sharding.make_mesh(*shape)
    lat, pred, steps, peak, launches = mesh_denoise(dev, cfg, seed, mesh,
                                                    ulysses)
    if rank == 0:
        got = check_outputs(cfg, lat, pred, *MESH_GEOMETRY)
        torch.save({k: v.float().cpu() for k, v in got.items()},
                   mesh_path("outputs.pt"))
    _rank_record(rank, steps=steps, peak_gb=peak, launches=launches)


# full_mesh's denoises: (mesh shape, Ulysses)
FULL_MESH_RUNS = (((1, 1, 2), False), ((1, 2, 1), True))


def mesh_tag(shape) -> str:
    return "x".join(map(str, shape)) + "_"


def phase_full_mesh(device, seed=1024):
    """At full width on ranks sharing this card: the q/k norm on a column
    split (``mesh_norm_check``), Ulysses and the ring as direct calls at
    the DiT self, bicross and VGGT global shapes (2 ranks) against the
    one-process kernel; then the 2-step denoise with the heads at (1, 1, 2)
    and at (1, 2, 1) with Ulysses, both at ``MESH_DEPTH``, against the same
    seeded model and inputs run once in one process on the card;
    ``full_mesh_train``: two LoRA rank-16 steps with per-block recompute at
    full width and ``MESH_DEPTH``, 336x592x81, batch 1, at (1, 1, 2) and at
    (1, 2, 1) with Ulysses, against the same seeded model and batches
    stepped in one process on the card (the losses and each step's LoRA
    gradients gathered whole within TRAIN_TOL, exact launches); and the
    trainer's entry point on a 1x1x2 mesh (``train_cli_mesh``); then the
    pipeline trainer: ``full_pipe``, one GPipe step of ``WanDiTConfig()``
    at 4 blocks over 2 stages, M = 2, Bm = 1 at 480x832x81, full
    fine-tuning under AdamW, against the same step in one process on the
    card (``check_full_pipe``), and its entry point, ``cli.train
    --pipe_stages 2`` saved and resumed (``train_cli_pipe``). All run as
    jobs of one spawn of 2 ranks. Returns (the denoise runs' launches, the
    mesh training runs', the pipeline's), all ranks summed."""
    import shutil

    import torch
    t0 = time.perf_counter()
    height, width, frames = MESH_GEOMETRY
    fhw = ((frames - 1) // 4 + 1, height // 16, width // 16)
    cfg = mesh_fusion_config(MESH_DEPTH)
    lat, pred, ref_steps, ref_peak, _ = mesh_denoise(device, cfg, seed)
    ref = {k: v.float().cpu() for k, v in check_outputs(
        cfg, lat, pred, height, width, frames).items()}
    del lat, pred
    gc.collect()
    torch.cuda.empty_cache()
    losses, grads, seconds, peak, _ = mesh_lora_steps(device, cfg, seed)
    train_ref = {"losses": losses, "grads": grads, "seconds": seconds,
                 "peak": peak}
    gc.collect()
    torch.cuda.empty_cache()
    pipe_ref = full_pipe_reference(device, seed)
    shutil.rmtree(TRAIN_CLI_MESH_DIR, ignore_errors=True)
    shutil.rmtree(TRAIN_CLI_PIPE_DIR, ignore_errors=True)
    t1 = time.perf_counter()
    records = mesh_jobs(2, [("attention_", _mesh_attention_rank, (3,))] + [
        (mesh_tag(shape), _full_mesh_rank, (shape, uly, MESH_DEPTH, seed))
        for shape, uly in FULL_MESH_RUNS] + [
        ("train" + mesh_tag(shape), _full_mesh_train_rank,
         (shape, uly, MESH_DEPTH, seed))
        for shape, uly in FULL_MESH_RUNS] + [
        ("train_cli_", _train_cli_rank, ()),
        ("pipe_full_", _full_pipe_rank, (seed,)),
        ("train_cli_pipe_", _train_cli_pipe_rank, ())])
    mesh_s = time.perf_counter() - t1
    for row in records["attention_"][0]["calls"]:
        say("full_mesh_attention", ranks=2, **{
            k: (f"{v:.3e}" if k in ("max_abs_err", "err_bound") else
                f"{v:.3f}" if isinstance(v, float) else v)
            for k, v in row.items()})
        if not row["max_abs_err"] <= row["err_bound"]:
            raise AssertionError(f"full_mesh {row['shape']} "
                                 f"{row['method']}: {row['max_abs_err']} > "
                                 f"{row['err_bound']}")
    norm = records["attention_"][0]["norm"]
    say("full_mesh_norm", ranks=2, shape="2x16317x5120",
        max_abs_err=f"{norm['max_abs_err']:.3e}",
        err_bound=f"{norm['err_bound']:.3e}")
    if not norm["max_abs_err"] <= norm["err_bound"]:
        raise AssertionError(f"full_mesh q/k norm on a column split: "
                             f"{norm['max_abs_err']} > {norm['err_bound']}")
    total = {}
    for shape, uly in FULL_MESH_RUNS:
        runs = records[mesh_tag(shape)]
        world = int(np.prod(shape))
        got = torch.load(mesh_path("outputs.pt", mesh_tag(shape)))
        errs = {k: ((got[k] - r).norm() / r.norm().clamp_min(1e-12)).item()
                for k, r in ref.items()}
        launch_err = [r for r in range(world) if runs[r]["launches"]
                      != mesh_launches(cfg, fhw, shape,
                                       MESH_MODES["full", shape, uly],
                                       MESH_STEPS, r, 512)]
        say("full_mesh", mesh="x".join(map(str, shape)), ulysses=uly,
            blocks=f"{cfg.start_index}+{cfg.num_irg}", ranks=world,
            one_process_step_seconds="|".join(f"{s:.3f}" for s in ref_steps),
            one_process_peak_gb=f"{ref_peak:.2f}",
            rank_step_seconds="|".join(
                "/".join(f"{s:.3f}" for s in r["steps"]) for r in runs),
            rank_peak_gb="|".join(f"{r['peak_gb']:.2f}" for r in runs),
            card_vs_one_process_rel_l2=json.dumps(
                {k: float(f"{v:.3e}") for k, v in errs.items()}).replace(
                    " ", ""),
            rank0_launches=_nonzero(runs[0]["launches"]))
        bad = {k: v for k, v in errs.items() if not v <= SLICE_TOL}
        if bad:
            raise AssertionError(f"full_mesh {shape}: beyond {SLICE_TOL} of "
                                 f"the one-process run: {bad}")
        if launch_err:
            raise AssertionError(
                f"full_mesh {shape}: ranks {launch_err} launched "
                f"{[runs[r]['launches'] for r in launch_err]}")
        for r in runs:
            total = _add(total, r["launches"])
    train = _add(check_full_mesh_train(cfg, train_ref, records),
                 check_train_cli_mesh(records["train_cli_"]))
    pipe = _add(check_full_pipe(pipe_ref, records["pipe_full_"]),
                check_train_cli_pipe(records["train_cli_pipe_"]))
    shutil.rmtree(TRAIN_CLI_MESH_DIR, ignore_errors=True)
    shutil.rmtree(TRAIN_CLI_PIPE_DIR, ignore_errors=True)
    os.remove(FULL_PIPE_REF)
    say("full_mesh_phase", seconds=f"{time.perf_counter() - t0:.2f}",
        mesh_seconds=f"{mesh_s:.2f}")
    return total, train, pipe


# ---------------------------------------------------------------------------
# the mesh trainer: the train step on meshes of ranks sharing this card (as
# small_mesh and full_mesh run them: their times are one card's)
# ---------------------------------------------------------------------------

# small_mesh_train's meshes: (shape, Ulysses, modes); one step each, batch
# 2 where the data axis splits it. MESH_MODES gives each one's attentions:
# local at 1x1x2, Ulysses at 1x2x1, the ring at 1x4x1, the gather at 2x2x2
SMALL_MESH_TRAIN_RUNS = (((1, 1, 2), False, ("lora", "full")),
                         ((1, 2, 1), True, ("lora",)),
                         ((1, 4, 1), True, ("lora",)),
                         ((2, 2, 2), False, ("lora",)))
TRAIN_LORA_RANK = 4
MESH_TRAIN_LR = 1e-4
# full_mesh_train: LoRA rank 16, 2 steps at MESH_DEPTH, batch 1, on the
# meshes of FULL_MESH_RUNS
FULL_TRAIN_RANK, FULL_TRAIN_STEPS = 16, 2


def attention_mode_backward(mode, H, D, q_split, kv_split):
    """{launch key: count} of the backward of one attention of this rank
    run as ``mode`` (``MESH_MODES``): dq and dk/dv once, at the head dim
    the kernels run at; the ring's once per hop."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    if mode in ("local", "gather"):
        d, n = fa.kernel_dim(H, D, kv_split.length), 1
    elif mode == "ulysses":
        d, n = fa.kernel_dim(H // q_split.n, D, kv_split.length), 1
    elif mode == "ring":
        d, n = fa.kernel_dim(H, D, max(kv_split.sizes)), kv_split.n
    else:
        raise ValueError(mode)
    return {f"bwd_dq_{d}": n, f"bwd_dkv_{d}": n}


def mesh_train_launches(cfg, fhw, shape, modes, rank, steps, text_len):
    """Kernel launches of one rank of a ``shape`` mesh over ``steps``
    training steps (``expected_train_launches`` on a mesh): every
    attention's stats forward, twice under per-block recompute, and its
    backward, as ``modes`` (a ``MESH_MODES`` entry) runs them -- the DiT's
    at 1/M of its heads -- less the last bicross's geometry-side backward
    (its output feeds only the heads, which the loss does not run)."""
    from collections import Counter

    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.parallel import sharding
    f, h, w = fhw
    d, s, m = shape
    psi = cfg.vggt.aggregator.patch_start_idx
    sizes = tuple(len(c) for c in np.array_split(np.arange(f), s))
    frames = sharding.TokenSplit(None, sizes,
                                 int(np.unravel_index(rank, shape)[1]))
    s_dit, s_agg = frames.scaled(h * w), frames.scaled(h * w + psi)
    dc, bc = cfg.dit, cfg.bicross
    vb = cfg.vggt.aggregator.block_cfg
    hd = dc.num_heads // m
    fwd, bwd = Counter(), Counter()

    def attention(mode, H, D, q_split, kv_split, backward=True):
        for k, v in attention_mode_launches(mode, H, D, q_split,
                                            kv_split).items():
            fwd[k if k.endswith("_stats") else k + "_stats"] += v
        if backward:
            bwd.update(attention_mode_backward(mode, H, D, q_split,
                                               kv_split))

    def whole(n):
        return sharding.TokenSplit(None, (n,), 0)

    m_self, m_glob, m_bi = modes
    for _ in range(dc.num_layers):
        attention(m_self, hd, dc.head_dim, s_dit, s_dit)
        attention("local", hd, dc.head_dim, None, whole(text_len))
        if dc.has_image_input:
            attention("local", hd, dc.head_dim, None, whole(257))
    last = cfg.num_irg - 1
    for i in range(cfg.num_irg):
        attention("local", vb.num_heads, vb.head_dim, None,
                  whole(h * w + psi))
        attention(m_glob, vb.num_heads, vb.head_dim, s_agg, s_agg)
        if i in cfg.xattn_set():
            attention(m_bi, bc.num_heads, bc.head_dim, s_dit, s_agg)
            attention(m_bi, bc.num_heads, bc.head_dim, s_agg, s_dit,
                      backward=i != last)
    out = {k: 0 for k in fa.LAUNCHES}
    for k, v in fwd.items():
        out[k] += v * 2 * steps
    for k, v in bwd.items():
        out[k] += v * steps
    return out


def stack_batches(batches):
    """Numpy batches of one sample (``train_batches``) as one batch, a
    sigma per sample, (B, 1, 1, 1, 1)."""
    out = {k: np.concatenate([b[k] for b in batches])
           for k in batches[0] if k != "sigma"}
    out["sigma"] = np.asarray([b["sigma"] for b in batches],
                              np.float32).reshape(-1, 1, 1, 1, 1)
    return out


def small_train_setup():
    """The reduced model in f32 on the CPU from seed 41 (the zero gates
    woken), its rank-4 LoRA factors (up drawn nonzero: both factors learn)
    and small_mesh_train's batches: (fusion config, base state dict, LoRA
    factors, {1: one sample, 2: two})."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.training.lora import init_lora, lora_state
    fcfg, _ = small_configs()
    g = torch.Generator("cpu").manual_seed(41)
    model = build(lambda: FusionModel(fcfg), device="cpu",
                  dtype=torch.float32, generator=g)
    wake_zero_inits(model, g)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    init_lora(model, TRAIN_LORA_RANK,
              generator=torch.Generator("cpu").manual_seed(42))
    with torch.no_grad():
        for n, t in lora_state(model).items():
            if n.endswith(".up"):
                t.normal_(0.0, 0.02, generator=g)
    lora = {n: t.detach().clone() for n, t in lora_state(model).items()}
    two = train_batches(fcfg.dit, *SMALL_GEOMETRY, 2, seed=43)
    return fcfg, base, lora, {1: two[0], 2: stack_batches(two)}


def train_on(model, trainable, batch, mesh=None, ulysses=False):
    """One AdamW step (lr ``MESH_TRAIN_LR``, no warm-up) of the LoRA or
    full train step over ``trainable``, per-block recompute; the loss."""
    import torch
    from fantasy_world_tpu_torch.training.lora import make_lora_train_step
    from fantasy_world_tpu_torch.training.step import make_train_step
    opt = torch.optim.AdamW(list(trainable.values()), lr=MESH_TRAIN_LR,
                            eps=1e-8)
    lora = all(".lora." in n for n in trainable)
    make = make_lora_train_step if lora else make_train_step
    return float(make(model, opt, remat=True, mesh=mesh,
                      ulysses=ulysses)(batch))


def small_train_model(setup, mode, dev, dtype, mesh=None):
    """``setup``'s (small_train_setup's) model as this rank's part of
    ``mesh`` (or whole) on ``dev``: (model, {name: trainable}) -- the LoRA
    factors, or every parameter."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.parallel import sharding
    from fantasy_world_tpu_torch.training.lora import init_lora, lora_state
    fcfg, base, lora, _ = setup
    model = build(lambda: FusionModel(fcfg), device=dev, dtype=dtype,
                  mesh=mesh)
    model.load_state_dict(base if mesh is None
                          else sharding.shard_state_dict(base, mesh))
    if mode == "full":
        return model, dict(model.named_parameters())
    init_lora(model, TRAIN_LORA_RANK,
              generator=torch.Generator(dev).manual_seed(0))
    trainable = lora_state(model)
    with torch.no_grad():
        for n, p in trainable.items():
            p.copy_(sharding.part_of_whole(lora[n], n, model))
    return model, trainable


def whole_trainable(model, trainable, mesh=None):
    """({name: gradient}, {name: value}) of ``trainable``, each tensor
    gathered whole over the model group, as f32 CPU tensors."""
    from fantasy_world_tpu_torch.parallel import sharding

    def whole(t, n):
        t = t if mesh is None else sharding.whole_tensor(t, n, model, mesh)
        return t.detach().float().cpu()
    return ({n: whole(p.grad, n) for n, p in trainable.items()},
            {n: whole(p, n) for n, p in trainable.items()})


def small_mesh_train_run(dev, dtype):
    """The CPU side of small_mesh_train: one step of each mode and batch
    the meshes run, in one process. {f"{mode}{B}": {loss, grads,
    params}}."""
    setup = small_train_setup()
    out = {}
    for shape, _, modes in SMALL_MESH_TRAIN_RUNS:
        B = 2 if shape[0] > 1 else 1
        for mode in modes:
            if f"{mode}{B}" in out:
                continue
            model, trainable = small_train_model(setup, mode, dev, dtype)
            loss = train_on(model, trainable, _to(setup[3][B], dev))
            grads, params = whole_trainable(model, trainable)
            out[f"{mode}{B}"] = {"loss": loss, "grads": grads,
                                 "params": params}
    return out


def _small_mesh_train_rank(rank, shape, ulysses, modes):
    """small_mesh_train on this rank: one step of each mode, its loss,
    seconds and launches; rank 0 saves the gradients and the updated
    values, gathered whole."""
    import torch
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.parallel import sharding
    dev = _rank_setup()
    mesh = sharding.make_mesh(*shape)
    setup = small_train_setup()
    batch = _to(setup[3][2 if shape[0] > 1 else 1], dev)
    record, saved = {}, {}
    for mode in modes:
        model, trainable = small_train_model(setup, mode, dev,
                                             torch.bfloat16, mesh)
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss = train_on(model, trainable, batch, mesh, ulysses)
        torch.cuda.synchronize()
        record[mode] = {"loss": loss, "seconds": time.perf_counter() - t0,
                        "launches": dict(fa.LAUNCHES)}
        grads, params = whole_trainable(model, trainable, mesh)
        saved[mode] = {"grads": grads, "params": params}
        del model, trainable
        gc.collect()
    if rank == 0:
        torch.save(saved, mesh_path("train.pt"))
    _rank_record(rank, **record)


def check_small_mesh_train(shape, uly, modes, records, cpu):
    """small_mesh_train at ``shape`` against the CPU's one-process step
    (``cpu``, small_mesh_train_run's): the loss, every gradient and
    updated value gathered whole (relative L2 over all of them, as
    small_train holds them) within TRAIN_TOL, every rank's launches exact.
    Returns the launches, all ranks summed."""
    import torch
    fcfg, _ = small_configs()
    height, width, frames = SMALL_GEOMETRY
    fhw = ((frames - 1) // 4 + 1, height // 16, width // 16)
    B = 2 if shape[0] > 1 else 1
    saved = torch.load(mesh_path("train.pt", "train" + mesh_tag(shape)))
    want_launches = [mesh_train_launches(
        fcfg, fhw, shape, MESH_MODES["small", shape, uly], r, 1, 16)
        for r in range(len(records))]
    total = {}
    for mode in modes:
        ref = cpu[f"{mode}{B}"]
        got = saved[mode]
        names = sorted(ref["grads"])
        if sorted(got["grads"]) != names:
            raise AssertionError(f"small_mesh_train {shape} {mode}: other "
                                 f"trainable tensors than one process")
        loss = records[0][mode]["loss"]
        checks = {"loss": abs(loss - ref["loss"]) / abs(ref["loss"]),
                  "grads": _rel_l2([got["grads"][n] for n in names],
                                   [ref["grads"][n] for n in names]),
                  "params": _rel_l2([got["params"][n] for n in names],
                                    [ref["params"][n] for n in names])}
        losses = {r[mode]["loss"] for r in records}
        launch_err = [r for r, rec in enumerate(records)
                      if rec[mode]["launches"] != want_launches[r]]
        say("small_mesh_train", mesh="x".join(map(str, shape)), ulysses=uly,
            mode=mode, batch=B, ranks=len(records),
            loss=f"{loss:.5f}|{ref['loss']:.5f}",
            device_vs_cpu_rel=json.dumps({k: float(f"{v:.3e}") for k, v in
                                          checks.items()}).replace(" ", ""),
            rank_step_seconds="|".join(f"{r[mode]['seconds']:.2f}"
                                       for r in records),
            rank0_launches=_nonzero(records[0][mode]["launches"]))
        bad = {k: v for k, v in checks.items() if not v <= TRAIN_TOL}
        if bad or len(losses) != 1:
            raise AssertionError(f"small_mesh_train {shape} {mode}: beyond "
                                 f"{TRAIN_TOL} of the CPU: {bad}; the "
                                 f"ranks' losses {sorted(losses)}")
        if launch_err:
            got = [records[r][mode]["launches"] for r in launch_err]
            raise AssertionError(
                f"small_mesh_train {shape} {mode}: ranks {launch_err} "
                f"launched {got}, not "
                f"{[want_launches[r] for r in launch_err]}")
        for r in records:
            total = _add(total, r[mode]["launches"])
    return total


def mesh_lora_steps(device, cfg, seed, mesh=None, ulysses=False,
                    steps=FULL_TRAIN_STEPS):
    """The model at ``cfg`` built on the card from ``seed`` (this rank's
    part of ``mesh``; the zero gates woken), LoRA rank FULL_TRAIN_RANK on
    it from seed + 1, and ``steps`` steps on seeded batches at
    MESH_GEOMETRY (512 text tokens): (losses, each step's LoRA gradients
    gathered whole, seconds per step, peak GB, launches)."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.training.lora import (init_lora, lora_state,
                                                       make_lora_train_step)
    g = torch.Generator(device=device).manual_seed(seed)
    model = build(lambda: FusionModel(cfg), device=device,
                  dtype=torch.bfloat16, generator=g, mesh=mesh)
    wake_zero_inits(model, g)
    init_lora(model, FULL_TRAIN_RANK,
              generator=torch.Generator(device=device).manual_seed(seed + 1))
    trainable = lora_state(model)
    opt = torch.optim.AdamW(list(trainable.values()), lr=MESH_TRAIN_LR,
                            eps=1e-8)
    step = make_lora_train_step(model, opt, remat=True, mesh=mesh,
                                ulysses=ulysses)
    batches = [_to(b, device) for b in train_batches(
        cfg.dit, *MESH_GEOMETRY, steps, seed=1031, text_len=512)]
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(steps + 1)]
    losses, grads = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    events[0].record()
    for i, b in enumerate(batches):
        losses.append(float(step(b)))
        events[i + 1].record()
        grads.append(whole_trainable(model, trainable, mesh)[0])
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    seconds = [events[i].elapsed_time(events[i + 1]) / 1e3
               for i in range(steps)]
    return (losses, grads, seconds, torch.cuda.max_memory_allocated() / 1e9,
            launches)


def _full_mesh_train_rank(rank, shape, ulysses, depth, seed):
    import torch
    from fantasy_world_tpu_torch.parallel import sharding
    dev = _rank_setup()
    losses, grads, seconds, peak, launches = mesh_lora_steps(
        dev, mesh_fusion_config(depth), seed, sharding.make_mesh(*shape),
        ulysses)
    if rank == 0:
        torch.save(grads, mesh_path("train_grads.pt"))
    _rank_record(rank, losses=losses, steps=seconds, peak_gb=peak,
                 launches=launches)


def check_full_mesh_train(cfg, ref, records):
    """full_mesh_train's runs against the one-process run on the card
    (``ref``: losses, gradients): the losses and each step's LoRA
    gradients (relative L2 over all factors) within TRAIN_TOL, exact
    launches per rank. Returns the launches, all ranks summed."""
    import torch
    height, width, frames = MESH_GEOMETRY
    fhw = ((frames - 1) // 4 + 1, height // 16, width // 16)
    total = {}
    for shape, uly in FULL_MESH_RUNS:
        runs = records["train" + mesh_tag(shape)]
        grads = torch.load(mesh_path("train_grads.pt",
                                     "train" + mesh_tag(shape)))
        names = sorted(ref["grads"][0])
        errs = {}
        for i in range(FULL_TRAIN_STEPS):
            errs[f"loss{i}"] = (abs(runs[0]["losses"][i] - ref["losses"][i])
                                / abs(ref["losses"][i]))
            errs[f"lora_grads{i}"] = _rel_l2(
                [grads[i][n] for n in names],
                [ref["grads"][i][n] for n in names])
        launch_err = [r for r in range(len(runs)) if runs[r]["launches"]
                      != mesh_train_launches(
                          cfg, fhw, shape, MESH_MODES["full", shape, uly], r,
                          FULL_TRAIN_STEPS, 512)]
        say("full_mesh_train", mesh="x".join(map(str, shape)), ulysses=uly,
            blocks=f"{cfg.start_index}+{cfg.num_irg}", ranks=len(runs),
            lora_rank=FULL_TRAIN_RANK,
            losses="|".join(f"{x:.5f}" for x in runs[0]["losses"]),
            one_process_losses="|".join(f"{x:.5f}" for x in ref["losses"]),
            one_process_step_seconds="|".join(f"{s:.3f}"
                                              for s in ref["seconds"]),
            one_process_peak_gb=f"{ref['peak']:.2f}",
            rank_step_seconds="|".join(
                "/".join(f"{s:.3f}" for s in r["steps"]) for r in runs),
            rank_peak_gb="|".join(f"{r['peak_gb']:.2f}" for r in runs),
            card_vs_one_process_rel=json.dumps(
                {k: float(f"{v:.3e}") for k, v in errs.items()}).replace(
                    " ", ""),
            rank0_launches=_nonzero(runs[0]["launches"]))
        bad = {k: v for k, v in errs.items() if not v <= TRAIN_TOL}
        if bad or len({tuple(r["losses"]) for r in runs}) != 1:
            raise AssertionError(f"full_mesh_train {shape}: beyond "
                                 f"{TRAIN_TOL} of one process: {bad}, or "
                                 f"the ranks' losses differ")
        if launch_err:
            raise AssertionError(
                f"full_mesh_train {shape}: ranks {launch_err} launched "
                f"{[runs[r]['launches'] for r in launch_err]}")
        for r in runs:
            total = _add(total, r["launches"])
    return total


# the trainer CLI on a 1x1x2 mesh: the demo at dim 256 (2 DiT heads, so
# the model splits), LoRA rank 4
MESH_TRAIN_CLI_ARGS = ["--synthetic", "--mesh_model", "2", "--lora_rank",
                       "4", "--demo_dim", "256", "--warmup", "1", "--lr",
                       "1e-3", "--log_every", "1", "--device", "cuda"]


TRAIN_CLI_MESH_DIR = os.path.join(REPO, "build", "train_cli_mesh")


def _train_cli_rank(rank):
    """``cli.train``'s ``run`` on this rank of a 1x1x2 mesh (the process
    group open already, as ``distributed.spawn`` leaves it): 2 steps saved
    into TRAIN_CLI_MESH_DIR, then resumed to step 3; each run's final loss
    and launches."""
    from fantasy_world_tpu_torch.cli.train import main as train_main
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    _rank_setup()
    ckpt = TRAIN_CLI_MESH_DIR
    runs = []
    for steps in (2, 3):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss = train_main(MESH_TRAIN_CLI_ARGS + [
            "--steps", str(steps), "--checkpoint_dir", ckpt])
        runs.append({"loss": loss, "seconds": time.perf_counter() - t0,
                     "launches": dict(fa.LAUNCHES)})
    _rank_record(rank, runs=runs,
                 checkpoints=sorted(os.listdir(ckpt)) if rank == 0 else None)


def check_train_cli_mesh(records):
    """The mesh CLI run: the same finite loss on both ranks, both
    checkpoints, every stats-forward and backward route the demo takes
    launched on every rank. Returns the launches, all ranks summed."""
    routes = ("onekv_stats", "d64_stats", "bwd_dq_64", "bwd_dq_128",
              "bwd_dkv_64", "bwd_dkv_128")
    saved = records[0]["checkpoints"]
    say("train_cli_mesh", mesh="1x1x2", ranks=len(records),
        losses="|".join("/".join(f"{run['loss']:.5f}" for run in r["runs"])
                        for r in records),
        checkpoints="|".join(saved),
        rank_seconds="|".join("/".join(f"{run['seconds']:.1f}"
                                       for run in r["runs"])
                              for r in records),
        rank0_launches="|".join(_nonzero(run["launches"])
                                for run in records[0]["runs"]))
    total = {}
    for i in range(2):
        losses = {r["runs"][i]["loss"] for r in records}
        if len(losses) != 1 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train CLI on a mesh: run {i} losses "
                                 f"{sorted(losses)}")
        for r in records:
            idle = [k for k in routes if r["runs"][i]["launches"][k] == 0]
            if idle:
                raise AssertionError(f"train CLI on a mesh: run {i} "
                                     f"launched no {idle}")
            total = _add(total, r["runs"][i]["launches"])
    if saved != ["step_00000002", "step_00000003"]:
        raise AssertionError(f"train CLI on a mesh: checkpoints {saved}")
    return total


# ---------------------------------------------------------------------------
# the pipeline trainer: the GPipe step of the plain video DiT over 2 stages
# on ranks sharing this card (as the other mesh jobs run: their times are
# one card's), against one process
# ---------------------------------------------------------------------------

PIPE_STAGES = PIPE_MICROBATCHES = 2
PIPE_LR = 1e-4
# small_pipe: small_configs' DiT (2 heads of 128: self over 2304 tokens ->
# generic, cross to 16 text and 257 CLIP keys -> onekv) at 4 blocks, 2 a
# stage, without camera adapters, at SMALL_GEOMETRY
SMALL_PIPE_SEED = 47
SMALL_PIPE_DTYPE = "bfloat16"
# full_pipe: WanDiTConfig() at full width (i2v) cut to 4 blocks, 2 a
# stage, at 480x832x81 (21 x 30 x 52 = 32,760 tokens a sample, Bm = 1),
# 512 text keys
FULL_PIPE_DEPTH = 4
FULL_PIPE_GEOMETRY = (480, 832, 81)
FULL_PIPE_REF = os.path.join(REPO, "build", "full_pipe_grads.pt")
# 'seq' inside a stage, jobs of small_meshes' 4-rank spawn, 2 stages x 2
# seq ranks: small_pipe_seq, small_pipe's model and batch (6 latent frames,
# 3 | 3) with the self-attention gathered and through Ulysses (1 of 2
# heads a rank); full_pipe_seq, WanDiTConfig() cut to 2 blocks (1 a
# stage) at full_pipe's geometry (21 latent frames, 11 | 10: 17,160 |
# 15,600 tokens), Ulysses (20 of 40 heads a rank)
PIPE_SEQ = 2
SMALL_PIPE_SEQ_RUNS = (False, True)
FULL_PIPE_SEQ_DEPTH = 2
FULL_PIPE_SEQ_REF = os.path.join(REPO, "build", "full_pipe_seq_grads.pt")


def small_pipe_config():
    import dataclasses
    fcfg, _ = small_configs()
    return dataclasses.replace(fcfg.dit, num_layers=4, camera_adapter_end=0)


def full_pipe_config(depth=FULL_PIPE_DEPTH):
    from fantasy_world_tpu_torch.models.wan.dit import WanDiTConfig
    return WanDiTConfig(num_layers=depth)


def pipe_seq_split(geometry, seq, rank):
    """The tokens of ``rank``'s frames (a ``TokenSplit``) on a (stages, 1,
    ``seq``, 1) pipe mesh at ``geometry``."""
    from fantasy_world_tpu_torch.parallel.sharding import TokenSplit
    height, width, frames = geometry
    f, hw = (frames - 1) // 4 + 1, (height // 16) * (width // 16)
    sizes = tuple(len(c) * hw for c in np.array_split(np.arange(f), seq))
    return TokenSplit(None, sizes, rank % seq)


def pipe_launches_of(cfg, geometry, text_len, rank, seq=1, ulysses=False,
                     stages=PIPE_STAGES, microbatches=PIPE_MICROBATCHES):
    """``pipe_train_launches`` of ``rank`` of a (``stages``, data, ``seq``,
    1) pipe mesh: the gather, or Ulysses under ``ulysses``, on seq
    ranks."""
    blocks = cfg.num_layers // stages
    if seq == 1:
        return pipe_train_launches(cfg, blocks, pipe_tokens(geometry),
                                   text_len, microbatches)
    return pipe_train_launches(
        cfg, blocks, None, text_len, microbatches,
        mode="ulysses" if ulysses else "gather",
        split=pipe_seq_split(geometry, seq, rank))


def pipe_batch(cfg, geometry, seed, text_len, n=PIPE_MICROBATCHES):
    """``n`` seeded samples at ``geometry`` as one batch (numpy), a sigma
    each; no Plucker features (the plain DiT takes none)."""
    batch = stack_batches(train_batches(cfg, *geometry, n, seed=seed,
                                        text_len=text_len))
    batch.pop("plucker_fea")
    return batch


def pipe_tokens(geometry):
    height, width, frames = geometry
    return ((frames - 1) // 4 + 1) * (height // 16) * (width // 16)


def pipe_train_launches(cfg, blocks, tokens, text_len,
                        microbatches=PIPE_MICROBATCHES, mode="local",
                        split=None):
    """Kernel launches of one pipeline step on a rank holding
    ``blocks`` blocks: each block runs each of its data rank's
    ``microbatches`` through its self-attention (``tokens`` keys) and its
    cross-attentions (the text's and CLIP's keys), each a stats forward
    twice under per-block recompute and one backward, dq and dk/dv, at
    the head dim its kernel runs at. ``split``: where the stage splits its
    frames over seq ranks, this rank's tokens (a ``TokenSplit``) and
    ``mode`` how the self-attention runs over them ("gather", "ulysses" or
    "ring", as ``attention_mode_launches`` counts them); the
    cross-attentions take the rank's queries against the whole keys."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.parallel.sharding import TokenSplit

    def whole(n):
        return TokenSplit(None, (n,), 0)

    split = split or whole(tokens)
    out = {k: 0 for k in fa.LAUNCHES}
    n = blocks * microbatches
    H, D = cfg.num_heads, cfg.head_dim
    attentions = [(mode, split), ("local", whole(text_len))] + (
        [("local", whole(257))] if cfg.has_image_input else [])
    for how, keys in attentions:
        for k, v in attention_mode_launches(how, H, D, split, keys).items():
            out[k if k.endswith("_stats") else k + "_stats"] += 2 * n * v
        for k, v in attention_mode_backward(how, H, D, split, keys).items():
            out[k] += n * v
    return out


def pipe_step(device, dtype, cfg, seed, batch, pipe=None, host_init=False,
              microbatches=PIPE_MICROBATCHES, ulysses=False):
    """One AdamW step (lr PIPE_LR, no warm-up) of ``make_pp_train_step``
    with per-block recompute, on this rank's stage of the plain DiT seeded
    by ``init_stage_`` (the same values at any stage count) on ``device``
    in ``dtype`` -- or, with ``host_init``, drawn in f32 on the CPU and
    copied over, so that a card run starts from a CPU run's values -- over
    ``pipe`` (one process when None) in ``microbatches``, with Ulysses on
    seq ranks under ``ulysses``: (loss, the stage's model, seconds, peak
    GB, launches)."""
    import torch
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.parallel.pipeline import single_pipe
    from fantasy_world_tpu_torch.training.pp import (build_stage_dit,
                                                     make_pp_train_step)
    pipe = pipe or single_pipe()
    if host_init:
        model = build_stage_dit(cfg, pipe, device=device, dtype=dtype)
        model.load_state_dict(build_stage_dit(
            cfg, pipe, device="cpu", dtype=torch.float32,
            seed=seed).state_dict())
    else:
        model = build_stage_dit(cfg, pipe, device=device, dtype=dtype,
                                seed=seed)
    opt = torch.optim.AdamW(model.parameters(), lr=PIPE_LR, eps=1e-8)
    step = make_pp_train_step(model, opt, pipe=pipe,
                              microbatches=microbatches, ulysses=ulysses)
    batch = _to(batch, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    loss = float(step(batch))
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    return loss, model, seconds, peak, dict(fa.LAUNCHES)


def _grads_values(model):
    return ({n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters()},
            {n: p.detach().float().cpu()
             for n, p in model.named_parameters()})


def small_pipe_run(dev, dtype):
    """The CPU side of small_pipe: the step in one process. {loss, grads,
    params}."""
    cfg = small_pipe_config()
    loss, model, _, _, _ = pipe_step(
        dev, dtype, cfg, SMALL_PIPE_SEED,
        pipe_batch(cfg, SMALL_GEOMETRY, SMALL_PIPE_SEED + 2, 16),
        host_init=True)
    grads, params = _grads_values(model)
    return {"loss": loss, "grads": grads, "params": params}


def _small_pipe_rank(rank, seq=1, ulysses=False):
    """small_pipe on this rank (its stage, and its frames on ``seq``
    ranks): the step's loss, seconds, peak and launches; its gradients and
    updated values saved for the parent."""
    import torch
    from fantasy_world_tpu_torch.parallel.pipeline import make_pipe_mesh
    dev = _rank_setup()
    cfg = small_pipe_config()
    loss, model, seconds, peak, launches = pipe_step(
        dev, getattr(torch, SMALL_PIPE_DTYPE), cfg, SMALL_PIPE_SEED,
        pipe_batch(cfg, SMALL_GEOMETRY, SMALL_PIPE_SEED + 2, 16),
        make_pipe_mesh(PIPE_STAGES, seq=seq), host_init=True,
        ulysses=ulysses)
    grads, params = _grads_values(model)
    torch.save({"grads": grads, "params": params},
               mesh_path(f"pipe{rank}.pt"))
    _rank_record(rank, loss=loss, seconds=seconds, peak_gb=peak,
                 launches=launches)


def small_pipe_tag(seq=1, ulysses=False) -> str:
    return ("pipe_small_" if seq == 1 else
            f"pipe_seq_{'ulysses' if ulysses else 'gather'}_small_")


def check_small_pipe(records, cpu, seq=1, ulysses=False):
    """small_pipe (or, on ``seq`` ranks a stage, small_pipe_seq) against
    the CPU's one-process f32 step (``cpu``, small_pipe_run's): the loss
    and, as relative L2, lite's gradients and updated values and each
    rank's block gradients within TRAIN_TOL; lite the same bits on every
    rank; every rank's launches exact. Returns the launches, all ranks
    summed."""
    import torch
    cfg = small_pipe_config()
    tag = small_pipe_tag(seq, ulysses)
    name = ("small_pipe" if seq == 1 else
            f"small_pipe_seq_{'ulysses' if ulysses else 'gather'}")
    saved = [torch.load(mesh_path(f"pipe{r}.pt", tag))
             for r in range(len(records))]
    lite = sorted(n for n in cpu["grads"] if not n.startswith("blocks."))
    checks = {"loss": abs(records[0]["loss"] - cpu["loss"])
              / abs(cpu["loss"]),
              "lite_grads": _rel_l2([saved[0]["grads"][n] for n in lite],
                                    [cpu["grads"][n] for n in lite]),
              "lite_params": _rel_l2([saved[0]["params"][n] for n in lite],
                                     [cpu["params"][n] for n in lite])}
    for r, s in enumerate(saved):
        blocks = sorted(n for n in s["grads"] if n.startswith("blocks."))
        checks[f"rank{r}_block_grads"] = _rel_l2(
            [s["grads"][n] for n in blocks],
            [cpu["grads"][n] for n in blocks])
    lite_equal = all(torch.equal(s["params"][n], saved[0]["params"][n])
                     for s in saved for n in lite)
    want = [pipe_launches_of(cfg, SMALL_GEOMETRY, 16, r, seq, ulysses)
            for r in range(len(records))]
    launch_err = [r for r, rec in enumerate(records)
                  if rec["launches"] != want[r]]
    say(name, stages=PIPE_STAGES, seq=seq, ulysses=ulysses,
        microbatches=PIPE_MICROBATCHES, blocks=cfg.num_layers,
        loss=f"{records[0]['loss']:.5f}|{cpu['loss']:.5f}",
        device_vs_cpu_rel=json.dumps({k: float(f"{v:.3e}") for k, v in
                                      checks.items()}).replace(" ", ""),
        lite_bit_equal=lite_equal,
        rank_step_seconds="|".join(f"{r['seconds']:.2f}" for r in records),
        rank_peak_gb="|".join(f"{r['peak_gb']:.2f}" for r in records),
        rank0_launches=_nonzero(records[0]["launches"]))
    bad = {k: v for k, v in checks.items() if not v <= TRAIN_TOL}
    if bad or len({r["loss"] for r in records}) != 1 or not lite_equal:
        raise AssertionError(f"{name}: beyond {TRAIN_TOL} of the CPU: "
                             f"{bad}; the ranks' losses "
                             f"{[r['loss'] for r in records]}; lite equal "
                             f"on every rank: {lite_equal}")
    if launch_err:
        raise AssertionError(f"{name}: ranks {launch_err} launched "
                             f"{[records[r]['launches'] for r in launch_err]}"
                             f", not {[want[r] for r in launch_err]}")
    return _add(*(r["launches"] for r in records))


def full_pipe_reference(device, seed, depth=FULL_PIPE_DEPTH,
                        path=FULL_PIPE_REF):
    """full_pipe's step in one process on the card (the whole model of
    ``depth`` blocks): its loss, seconds, peak GB and launches; its
    gradients saved to ``path`` for the ranks."""
    import torch
    cfg = full_pipe_config(depth)
    loss, model, seconds, peak, launches = pipe_step(
        device, torch.bfloat16, cfg, seed,
        pipe_batch(cfg, FULL_PIPE_GEOMETRY, seed + 7, 512))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({n: p.grad.detach().cpu()
                for n, p in model.named_parameters()}, path)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": loss, "seconds": seconds, "peak": peak,
            "launches": launches}


def _full_pipe_rank(rank, seed, depth=FULL_PIPE_DEPTH, seq=1,
                    ulysses=False, path=FULL_PIPE_REF):
    """full_pipe (or full_pipe_seq: ``seq`` ranks a stage) on this rank:
    the step, then the relative L2 of each of its gradients against the
    one-process run's (saved at ``path``)."""
    import torch
    from fantasy_world_tpu_torch.parallel.pipeline import make_pipe_mesh
    dev = _rank_setup()
    cfg = full_pipe_config(depth)
    loss, model, seconds, peak, launches = pipe_step(
        dev, torch.bfloat16, cfg, seed,
        pipe_batch(cfg, FULL_PIPE_GEOMETRY, seed + 7, 512),
        make_pipe_mesh(PIPE_STAGES, seq=seq), ulysses=ulysses)
    ref = torch.load(path, mmap=True, weights_only=True)
    errs, alone = pipe_grad_rel_l2(
        {n: p.grad for n, p in model.named_parameters()}, ref, dev,
        joint=seq > 1)
    _rank_record(rank, loss=loss, seconds=seconds, peak_gb=peak,
                 launches=launches, grad_rel_l2=errs, cancelled=alone,
                 blocks=sorted({n.split(".")[1] for n in errs
                                if n.startswith("blocks.")}, key=int))


# a cross-attention's key bias: its gradient, the sum over the keys of
# dk, nearly cancels (a softmax does not see a bias added to every key;
# only the key norm lets it through), so the bf16 rounding of dk dominates
# it in any run. Where a layout splits the queries (seq ranks) its partial
# dk round apart from one process's, and the bias is held to the
# reference together with its layer's weight, as one tensor
SOFTMAX_CANCELLED = re.compile(r".*cross_attn\.k(_img)?\.bias$")


def pipe_grad_rel_l2(grads, ref, device, joint=False):
    """(the relative L2 of each gradient of ``grads`` ({name: tensor})
    against ``ref``'s, each SOFTMAX_CANCELLED bias under ``joint`` together
    with its layer's weight, named "{bias}+weight"; those biases' own
    relative L2, which ``joint`` leaves ungated)."""
    def rel(names):
        want = [ref[n].to(device).float() for n in names]
        num = sum((grads[n].to(device).float() - w).norm() ** 2
                  for n, w in zip(names, want))
        den = sum(w.norm() ** 2 for w in want)
        return (num.sqrt() / den.sqrt().clamp_min(1e-30)).item()
    errs, alone = {}, {}
    for n in grads:
        if joint and SOFTMAX_CANCELLED.match(n):
            alone[n] = rel([n])
            errs[n + "+weight"] = rel([n, n[:-len("bias")] + "weight"])
        else:
            errs[n] = rel([n])
    return errs, alone


def check_full_pipe(ref, records, depth=FULL_PIPE_DEPTH, seq=1,
                    ulysses=False):
    """full_pipe's (full_pipe_seq's: ``seq`` ranks a stage) ranks against
    the one-process step on the card (``ref``): the same loss on every
    rank, within TRAIN_TOL of one process's, every gradient's relative L2
    within TRAIN_TOL (``pipe_grad_rel_l2``: on seq ranks each
    cross-attention key bias with its weight), exact launches per rank.
    Returns the launches, all ranks summed."""
    cfg = full_pipe_config(depth)
    name = "full_pipe" if seq == 1 else "full_pipe_seq"
    worst = {r: max(rec["grad_rel_l2"].items(), key=lambda kv: kv[1])
             for r, rec in enumerate(records)}
    loss_err = abs(records[0]["loss"] - ref["loss"]) / abs(ref["loss"])
    want = [pipe_launches_of(cfg, FULL_PIPE_GEOMETRY, 512, r, seq, ulysses)
            for r in range(len(records))]
    say(name, stages=PIPE_STAGES, seq=seq, ulysses=ulysses,
        microbatches=PIPE_MICROBATCHES, blocks=cfg.num_layers,
        geometry="x".join(map(str, FULL_PIPE_GEOMETRY)),
        loss=f"{records[0]['loss']:.5f}|{ref['loss']:.5f}",
        loss_rel=f"{loss_err:.3e}",
        rank_blocks="|".join(",".join(r["blocks"]) for r in records),
        worst_grad_rel_l2="|".join(f"{n}:{v:.3e}"
                                   for n, v in worst.values()),
        **({"cancelled_alone_rel_l2": "|".join(
            f"{n}:{v:.3e}" for n, v in sorted(
                {n: v for r in records
                 for n, v in r["cancelled"].items()}.items()))}
           if seq > 1 else {}),
        one_process_step_seconds=f"{ref['seconds']:.3f}",
        one_process_peak_gb=f"{ref['peak']:.2f}",
        rank_step_seconds="|".join(f"{r['seconds']:.3f}" for r in records),
        rank_peak_gb="|".join(f"{r['peak_gb']:.2f}" for r in records),
        rank0_launches=_nonzero(records[0]["launches"]))
    bad = {n: v for r in records for n, v in r["grad_rel_l2"].items()
           if not v <= TRAIN_TOL}
    if (bad or not loss_err <= TRAIN_TOL
            or len({r["loss"] for r in records}) != 1):
        raise AssertionError(f"{name}: beyond {TRAIN_TOL} of one "
                             f"process: gradients {bad}, loss {loss_err}, "
                             f"the ranks' losses "
                             f"{[r['loss'] for r in records]}")
    launch_err = [r for r, rec in enumerate(records)
                  if rec["launches"] != want[r]]
    if launch_err:
        raise AssertionError(f"{name}: ranks {launch_err} launched "
                             f"{[records[r]['launches'] for r in launch_err]}"
                             f", not {[want[r] for r in launch_err]}")
    return _add(*(r["launches"] for r in records))


# the trainer CLI's pipeline mode on 2 stages: the JAX trainer's demo DiT at
# dim 256 (8 heads of 32 -> d64, D zero-padded to 64), 4 blocks
PIPE_TRAIN_CLI_ARGS = ["--synthetic", "--pipe_stages", "2", "--demo_dim",
                       "256", "--demo_layers", "4", "--warmup", "1", "--lr",
                       "1e-3", "--log_every", "1", "--device", "cuda"]
TRAIN_CLI_PIPE_DIR = os.path.join(REPO, "build", "train_cli_pipe")


def _train_cli_pipe_rank(rank):
    """``cli.train``'s ``run`` on this stage of a 2-stage pipeline (the
    process group open already): 2 steps saved into TRAIN_CLI_PIPE_DIR,
    then resumed to step 3; each run's final loss, seconds and
    launches."""
    from fantasy_world_tpu_torch.cli.train import main as train_main
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    _rank_setup()
    runs = []
    for steps in (2, 3):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss = train_main(PIPE_TRAIN_CLI_ARGS + [
            "--steps", str(steps), "--checkpoint_dir", TRAIN_CLI_PIPE_DIR])
        runs.append({"loss": loss, "seconds": time.perf_counter() - t0,
                     "launches": dict(fa.LAUNCHES)})
    _rank_record(rank, runs=runs,
                 checkpoints=(sorted(os.listdir(TRAIN_CLI_PIPE_DIR))
                              if rank == 0 else None))


def check_train_cli_pipe(records):
    """The pipeline CLI run: the same finite loss on both stages, both
    checkpoints, the d64 stats forward and both backward kernels launched
    on every rank in every run. Returns the launches, all ranks summed."""
    routes = ("d64_stats", "bwd_dq_64", "bwd_dkv_64")
    saved = records[0]["checkpoints"]
    say("train_cli_pipe", stages=PIPE_STAGES, ranks=len(records),
        losses="|".join("/".join(f"{run['loss']:.5f}" for run in r["runs"])
                        for r in records),
        checkpoints="|".join(saved),
        rank_seconds="|".join("/".join(f"{run['seconds']:.1f}"
                                       for run in r["runs"])
                              for r in records),
        rank0_launches="|".join(_nonzero(run["launches"])
                                for run in records[0]["runs"]))
    total = {}
    for i in range(2):
        losses = {r["runs"][i]["loss"] for r in records}
        if len(losses) != 1 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train CLI on a pipeline: run {i} losses "
                                 f"{sorted(losses)}")
        for r in records:
            idle = [k for k in routes if r["runs"][i]["launches"][k] == 0]
            if idle:
                raise AssertionError(f"train CLI on a pipeline: run {i} "
                                     f"launched no {idle}")
            total = _add(total, r["runs"][i]["launches"])
    if saved != ["step_00000002", "step_00000003"]:
        raise AssertionError(f"train CLI on a pipeline: checkpoints {saved}")
    return total


# ---------------------------------------------------------------------------
# the serving options on a mesh: int8 / fp8, TeaCache, the sliding window,
# the Wan2.2 dual-expert denoise and the server, on ranks sharing this card
# (as small_mesh and full_mesh run them: their times are one card's)
# ---------------------------------------------------------------------------

SERVING_DIR = os.path.join(REPO, "build", "mesh_serving")
# small_mesh_serving at 128x192: 9 frames (3 latent frames of 8 x 12
# tokens, split 2 | 1 over 2 seq ranks) for all but the windows, which
# take 17 frames (5 latent frames) in windows of 3 every 2 -- (0, 3) and
# (2, 5), each split 2 | 1
SMALL_SERVING_GEOMETRY = (128, 192, 9)
SMALL_WINDOW_GEOMETRY = (128, 192, 17)
SMALL_WINDOW = (3, 2)
SMALL_SERVING_CASES = {
    (1, 1, 2): (False, ("int8", "fp8", "wan22", "server")),
    (2, 1, 2): (False, ("int8", "fp8")),
    (1, 2, 1): (True, ("tea", "window")),
}
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


def mesh_mode_frames(name):
    """The latent frames over which ``MESH_MODES[name, ...]`` is taken."""
    return {"small": (SMALL_GEOMETRY[2] - 1) // 4 + 1,
            "small_window": SMALL_WINDOW[0],
            "full": (MESH_GEOMETRY[2] - 1) // 4 + 1}[name]


def small_serving_inputs():
    """The reduced models from seeds (f32, the zero gates woken) and the
    conditioning of every small_mesh_serving case, as state dicts and CPU
    tensors: the Wan2.1 fusion model and pose encoder (``small_configs``),
    the two Wan2.2 experts (``small_wan22_configs``), the server's umT5,
    CLIP and VAE (``small_clip_configs``)."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
    from fantasy_world_tpu_torch.models.wan.clip import CLIPVision
    from fantasy_world_tpu_torch.models.wan.t5 import T5Encoder
    from fantasy_world_tpu_torch.models.wan.vae import WanVAE
    g = torch.Generator("cpu").manual_seed(41)
    fcfg, pcfg = small_configs()
    ccfg, _, t5c, clipc, vaec = small_clip_configs()
    wcfg = small_wan22_configs()[0]

    def made(ctor, cfg, wake=False):
        m = build(lambda: ctor(cfg), device="cpu", dtype=torch.float32,
                  generator=g)
        if wake:
            wake_zero_inits(m, g)
        return m.state_dict()

    sds = {"fusion": made(FusionModel, fcfg, True),
           "pose": made(CameraPoseEncoder, pcfg),
           "high": made(FusionModel, wcfg, True),
           "low": made(FusionModel, wcfg, True),
           "clip_fusion": made(FusionModel, ccfg, True),
           "clip_pose": made(CameraPoseEncoder, pcfg),
           "t5": made(T5Encoder, t5c), "clip": made(CLIPVision, clipc),
           "vae": made(WanVAE, vaec)}
    h, w, n = SMALL_SERVING_GEOMETRY
    cg = torch.Generator("cpu").manual_seed(42)
    f = (n - 1) // 4 + 1
    cond = {"serving": conditioning(fcfg.dit, h, w, n, cg, 16),
            "window": conditioning(fcfg.dit, *SMALL_WINDOW_GEOMETRY, cg, 16),
            "wan22": [torch.randn((1, 16, wcfg.dit.text_dim), generator=cg),
                      torch.randn((1, 16, wcfg.dit.text_dim), generator=cg),
                      torch.randn((1, wcfg.dit.in_dim - wcfg.dit.out_dim, f,
                                   h // 8, w // 8), generator=cg),
                      torch.randn((1, 24, f, h, w), generator=cg)]}
    return {"sds": sds, "cond": cond}


def _serving_modules(inputs, dev, dtype, names_ctors):
    """Modules built on ``dev`` in ``dtype`` and filled from the inputs'
    state dicts: {name: module} for each (name, (ctor, cfg))."""
    from fantasy_world_tpu_torch.core.params import build
    out = {}
    for name, (ctor, cfg) in names_ctors.items():
        out[name] = build(lambda: ctor(cfg), device=dev, dtype=dtype)
        out[name].load_state_dict(inputs["sds"][name])
    return out


def serving_case(case, inputs, dev, mesh=None, ulysses=False):
    """One small_mesh_serving case on ``dev`` (bf16 on the card, f32 on the
    CPU), on ``mesh`` or in one process: (rank 0's outputs as f32 CPU
    tensors, else None; this rank's launches). ``case``: "int8" / "fp8"
    (quantized, then split: JAX's order; 2 steps with the heads),
    "tea" (4 steps whose plan skips the second, cut after a segment of 2
    and resumed from the partial state), "window" (2 steps in windows),
    "wan22" (the dual-expert denoise over the boundary, 3 steps), "server"
    (two clips over HTTP as one batch, on a mesh; in one process the same
    batch through ``generate_videos``)."""
    import torch
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    meshed = mesh is not None and not mesh.trivial
    dtype = torch.float32 if str(dev) == "cpu" else torch.bfloat16
    fcfg, pcfg = small_configs()
    lead = not meshed or mesh.rank == 0
    kw = {"mesh": mesh, "ulysses": ulysses} if meshed else {}
    if case == "server":
        return _serving_server_case(inputs, dev, dtype, mesh)
    if case == "wan22":
        from fantasy_world_tpu_torch.pipelines.wan_video_22 import (
            DualModelDenoiser)
        wcfg = small_wan22_configs()[0]
        mods = _serving_modules(inputs, dev, dtype, {
            "high": (FusionModel, wcfg), "low": (FusionModel, wcfg)})
        den = DualModelDenoiser(mods["high"], mods["low"])
        if meshed:
            den.shard(mesh)
        ctx_p, ctx_n, y, ctrl = inputs["cond"]["wan22"]
        h, w, n = SMALL_SERVING_GEOMETRY
        fa.reset_launch_counts()
        lat, pred = den.denoise(ctx_p, ctx_n, y, h, w, num_frames=n,
                                num_inference_steps=3, seed=5,
                                control_camera_latents=ctrl, **kw)
        launches = dict(fa.LAUNCHES)
        if not lead:
            return None, launches
        return {k: v.float().cpu() for k, v in check_outputs(
            wcfg, lat, pred, h, w, n).items()}, launches
    mods = _serving_modules(inputs, dev, dtype, {
        "fusion": (FusionModel, fcfg), "pose": (CameraPoseEncoder, pcfg)})
    pipe = FantasyWorldPipeline(mods["fusion"], mods["pose"])
    if case in ("int8", "fp8"):
        pipe.quantize(case, min_dim=SMALL_QUANT_MIN_DIM)
    if meshed:
        pipe.shard(mesh)
    window = case == "window"
    cond = inputs["cond"]["window" if window else "serving"]
    h, w, n = SMALL_WINDOW_GEOMETRY if window else SMALL_SERVING_GEOMETRY
    pl = pipe.encode_plucker(cond[4])

    def denoise(**more):
        return pipe.denoise(*cond[:4], h, w, num_frames=n, seed=3,
                            plucker_fea=pl, **kw, **more)
    fa.reset_launch_counts()
    if case == "tea":
        thresh = float(inputs["thresh"])
        path = os.path.join(SERVING_DIR, f"partial_{dev.type}.npz")
        tea = dict(num_inference_steps=4, tea_cache_l1_thresh=thresh,
                   gen_ckpt_path=path)
        if meshed:
            try:
                denoise(segment_size=2, progress_callback=_cut_after_first,
                        **tea)
                raise AssertionError("the cut mesh run was not cut")
            except _Cut:
                pass
            lat, pred = denoise(segment_size=1, **tea)
        else:
            lat, pred = denoise(num_inference_steps=4,
                                tea_cache_l1_thresh=thresh)
    elif case == "window":
        lat, pred = denoise(num_inference_steps=2,
                            sliding_window_size=SMALL_WINDOW[0],
                            sliding_window_stride=SMALL_WINDOW[1])
    else:
        lat, pred = denoise(num_inference_steps=2)
    launches = dict(fa.LAUNCHES)
    if not lead:
        return None, launches
    if case == "window":
        return {"latents": lat.float().cpu()}, launches
    return {k: v.float().cpu() for k, v in check_outputs(
        fcfg, lat, pred, h, w, n).items()}, launches


SERVE_PROMPTS = (PROMPT, "a river at dawn")


def _serving_server_case(inputs, dev, dtype, mesh):
    """The server's batch: two clips of ``SMALL_SERVING_GEOMETRY`` with
    the example image and a 9-frame orbit, seeds 3 and 4, 2 steps. On a
    mesh rank 0 serves them over HTTP (port 0 on 127.0.0.1), batched as
    one B = 2 run, and the other ranks follow; rank 0 then stops the
    server, which stops the followers. Returns (rank 0's latents per clip
    and whether its files were written, the launches)."""
    import argparse
    import torch
    from fantasy_world_tpu_torch.cli import serve
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
    from fantasy_world_tpu_torch.models.wan.clip import CLIPVision
    from fantasy_world_tpu_torch.models.wan.t5 import T5Encoder
    from fantasy_world_tpu_torch.models.wan.vae import WanVAE
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    from fantasy_world_tpu_torch.sampler import FantasyWorldSampler
    ccfg, pcfg, t5c, clipc, vaec = small_clip_configs()
    mods = _serving_modules(inputs, dev, dtype, {
        "clip_fusion": (FusionModel, ccfg), "clip_pose": (CameraPoseEncoder,
                                                          pcfg),
        "t5": (T5Encoder, t5c), "clip": (CLIPVision, clipc),
        "vae": (WanVAE, vaec)})
    pipe = FantasyWorldPipeline(mods["clip_fusion"], mods["clip_pose"],
                                t5=mods["t5"], clip=mods["clip"],
                                vae=mods["vae"],
                                tokenizer_path=os.path.join(SERVING_DIR,
                                                            "tok"))
    meshed = mesh is not None and not mesh.trivial
    if meshed:
        pipe.shard(mesh)
    seen = []
    denoise = pipe.denoise

    def record(*a, **k):
        lat, pred = denoise(*a, **k)
        seen.append(lat)
        return lat, pred
    pipe.denoise = record
    sampler = FantasyWorldSampler(pipe)
    h, w, n = SMALL_SERVING_GEOMETRY
    req = {"image_path": EXAMPLE_IMAGE, "height": h, "width": w,
           "num_frames": n, "sample_steps": 2, "neg_prompt": NEG_PROMPT,
           "camera_json": os.path.join(SERVING_DIR, "cams.json")}
    reqs = [{**req, "prompt": p, "seed": s}
            for p, s in zip(SERVE_PROMPTS, (3, 4))]
    out_root = os.path.join(SERVING_DIR, f"out_{dev.type}")
    args = argparse.Namespace(segment_size=None, output_root=out_root,
                              ulysses=False, variant="wan21")
    fa.reset_launch_counts()
    written = True
    if not meshed:
        from fantasy_world_tpu_torch.serving.server import DEFAULTS
        cams = [serve._cameras({**DEFAULTS, **r}) for r in reqs]
        serve.make_run_fn(sampler, args)([{**DEFAULTS, **r} for r in reqs],
                                         cams, None)
    else:
        for result in (serve_on_mesh(mesh.rank, mesh, sampler, args, [reqs],
                                     2) or [[]])[0]:
            names = os.listdir(result["output_dir"])
            written = written and any(x.startswith("video") for x in names) \
                and "recon_confthresh1.0.ply" in names
    launches = dict(fa.LAUNCHES)
    if meshed and mesh.rank != 0:
        return None, launches
    if len(seen) != 1 or seen[0].shape[0] != 2:
        raise AssertionError(f"the two jobs ran as {[t.shape for t in seen]}")
    return {"latents": seen[0].float().cpu(),
            "written": torch.tensor(bool(written))}, launches


def serving_launches(case, shape, uly, rank):
    """The launches a small_mesh_serving case makes on ``rank``."""
    fcfg = small_configs()[0]
    h, w, n = SMALL_SERVING_GEOMETRY
    fhw = ((n - 1) // 4 + 1, h // 16, w // 16)
    modes = MESH_MODES["small", shape, uly]
    if case in ("int8", "fp8"):
        return mesh_launches(fcfg, fhw, shape, modes, 2, rank, 16)
    if case == "wan22":
        return mesh_launches(small_wan22_configs()[0], fhw, shape, modes, 3,
                             rank, 16)
    if case == "server":
        ccfg, _, _, clipc, _ = small_clip_configs()
        out = mesh_launches(ccfg, fhw, shape, modes, 2, rank, 512)
        if rank == 0:
            for _ in SERVE_PROMPTS:
                out = _add(out, encoder_launches(clip=clipc))
        return out
    if case == "tea":
        return mesh_launches(fcfg, fhw, shape, modes, 4, rank, 16,
                             skipped=1)
    h, w, n = SMALL_WINDOW_GEOMETRY
    f = (n - 1) // 4 + 1
    return mesh_window_launches(
        fcfg, (h // 16, w // 16), f, SMALL_WINDOW, shape,
        MESH_MODES["small_window", shape, uly], 2, rank, 16)


def _small_serving_rank(rank, shape, ulysses, cases):
    import torch
    from fantasy_world_tpu_torch.parallel import sharding
    dev = _rank_setup()
    mesh = sharding.make_mesh(*shape)
    # written by this script's parent process: numpy arrays among them
    inputs = torch.load(os.path.join(SERVING_DIR, "inputs.pt"),
                        weights_only=False)
    record, outs = {}, {}
    for case in cases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, launches = serving_case(case, inputs, dev, mesh, ulysses)
        torch.cuda.synchronize()
        record[case] = {"launches": launches,
                        "seconds": time.perf_counter() - t0}
        outs[case] = got
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        torch.save(outs, mesh_path("outputs.pt"))
    _rank_record(rank, **record)


def small_serving_prepare():
    """small_mesh_serving's inputs and TeaCache threshold written to
    SERVING_DIR for the ranks, with the tokenizer and the cameras of the
    server case; then each case's one-process CPU run (f32, the kernels'
    plain versions): {case: outputs}."""
    import shutil
    import torch
    from fantasy_world_tpu_torch.cli import make_camera_json
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    shutil.rmtree(SERVING_DIR, ignore_errors=True)
    os.makedirs(SERVING_DIR)
    inputs = small_serving_inputs()
    fcfg = small_configs()[0]
    cpu_f = FusionModel(fcfg)
    cpu_f.load_state_dict(inputs["sds"]["fusion"])
    thresh, plan = tea_threshold(cpu_f.dit, 4)
    del cpu_f
    inputs["thresh"] = thresh
    torch.save(inputs, os.path.join(SERVING_DIR, "inputs.pt"))
    write_tokenizer(small_clip_configs()[2].vocab,
                    os.path.join(SERVING_DIR, "tok"))
    make_camera_json.main(["--out", os.path.join(SERVING_DIR, "cams.json"),
                           "--motion", "orbit_left", "--frames",
                           str(SMALL_SERVING_GEOMETRY[2])])
    t0 = time.perf_counter()
    cpu = {case: serving_case(case, inputs, torch.device("cpu"))[0]
           for case in ("int8", "fp8", "tea", "window", "wan22", "server")}
    say("small_mesh_serving_cpu", seconds=f"{time.perf_counter() - t0:.2f}",
        tea_thresh=f"{thresh:.6g}",
        tea_plan="".join("s" if s else "c" for s in plan))
    if not plan[1] or plan.sum() != 1:
        raise AssertionError(f"TeaCache plan {plan}: one skip, the second")
    return cpu


def check_small_serving(shape, uly, cases, records, cpu):
    """small_mesh_serving's ``cases`` at ``shape`` (its ranks' ``records``
    and rank 0's outputs) against their CPU runs (``cpu``) within
    SLICE_TOL, and every rank's launches exact. Returns the launches, all
    ranks summed."""
    import torch
    world = len(records)
    got = torch.load(mesh_path("outputs.pt", "serving" + mesh_tag(shape)))
    total = {}
    for case in cases:
        ref = cpu[case]
        errs = {k: ((got[case][k] - v).norm()
                    / v.norm().clamp_min(1e-12)).item()
                for k, v in ref.items() if k != "written"}
        launch_err = [r for r in range(world)
                      if records[r][case]["launches"]
                      != serving_launches(case, shape, uly, r)]
        fields = {}
        if case == "server":
            fields["files_written"] = bool(got[case]["written"])
        say("small_mesh_serving", case=case,
            mesh="x".join(map(str, shape)), ulysses=uly, ranks=world,
            rank_seconds="|".join(f"{r[case]['seconds']:.2f}"
                                  for r in records),
            device_vs_cpu_rel_l2=json.dumps(
                {k: float(f"{v:.3e}") for k, v in errs.items()}
            ).replace(" ", ""),
            rank0_launches=_nonzero(records[0][case]["launches"]),
            **fields)
        bad = {k: v for k, v in errs.items() if not v <= SLICE_TOL}
        if bad:
            raise AssertionError(f"small_mesh_serving {case} {shape}: "
                                 f"beyond {SLICE_TOL} of the CPU: {bad}")
        if launch_err:
            raise AssertionError(
                f"small_mesh_serving {case} {shape}: ranks {launch_err} "
                f"launched "
                f"{[records[r][case]['launches'] for r in launch_err]}")
        if case == "server" and not fields["files_written"]:
            raise AssertionError("the served jobs wrote no MP4/PLY")
        for r in records:
            total = _add(total, r[case]["launches"])
    return total


def phase_small_meshes(device, cpu_outs, seed=1024):
    """small_mesh and small_mesh_serving at reduced widths, on meshes of
    ranks sharing this card, one spawn of ranks per world size running
    each mesh of that size as a job (``mesh_jobs``).

    small_mesh: the reduced slice's denoise (``SMALL_MESH_RUNS``) against
    the CPU's one-process run (``cpu_outs``, small_slice's).

    small_mesh_serving: the serving options, each against the CPU's
    one-process run of the same case (f32, the kernels' plain versions)
    within SLICE_TOL, with exact launches on every rank: int8 and fp8
    (quantized whole, then split) at 1x1x2 and 2x1x2; TeaCache at 1x2x1
    with Ulysses, the plan skipping a step, cut after a segment and resumed
    from rank 0's partial state; the windowed denoise at 1x2x1 with
    Ulysses on windows split 2 | 1; the Wan2.2 dual-expert denoise at 1x1x2
    across the boundary; the server at 1x1x2 (the last job of its spawn):
    two jobs over HTTP batched as one B = 2 run on both ranks, the files
    written, the ranks stopped through rank 0's shutdown (each rank exits
    0: the spawn raises otherwise).

    small_mesh_train: one step of the train step with per-block recompute
    (``SMALL_MESH_TRAIN_RUNS``: LoRA rank 4 and full fine-tuning at 1x1x2,
    LoRA at 1x2x1 with Ulysses, at 1x4x1 with the ring and at 2x2x2 on a
    batch of 2), each against the CPU's one-process f32 step of the same
    seeded model and batch (the background process's) within TRAIN_TOL,
    with exact launches on every rank, the backward's included.

    small_pipe (a job of the 2-rank spawn): one GPipe step of the reduced
    plain DiT over 2 stages, M = 2, against the CPU's one-process f32 step
    (``check_small_pipe``); small_pipe_seq (jobs of the 4-rank spawn): the
    same step over 2 stages x 2 seq ranks, the self-attention gathered and
    through Ulysses, against the same CPU step.

    full_pipe_seq (a job of the 4-rank spawn): one GPipe step of
    ``WanDiTConfig()`` cut to 2 blocks over 2 stages x 2 seq ranks with
    Ulysses (M = 2, Bm = 1 at 480x832x81, full fine-tuning), against the
    same step in this process, run first (``check_full_pipe``).

    Returns (small_mesh's launches, small_mesh_serving's,
    small_mesh_train's, small_pipe's, small_pipe_seq's and
    full_pipe_seq's), all ranks summed."""
    import shutil
    t_phase = time.perf_counter()
    pipe_seq_ref = full_pipe_reference(device, seed, FULL_PIPE_SEQ_DEPTH,
                                       FULL_PIPE_SEQ_REF)
    cpu = small_serving_prepare()
    # the 2-rank server case last: it stops the ranks' serving loop
    jobs = {}
    for shape, uly in SMALL_MESH_RUNS:
        jobs.setdefault(int(np.prod(shape)), []).append(
            ("mesh" + mesh_tag(shape), _small_mesh_rank,
             (shape, uly, shape == (1, 2, 1))))
    for shape, uly, modes in SMALL_MESH_TRAIN_RUNS:
        jobs.setdefault(int(np.prod(shape)), []).append(
            ("train" + mesh_tag(shape), _small_mesh_train_rank,
             (shape, uly, modes)))
    jobs[PIPE_STAGES].append(("pipe_small_", _small_pipe_rank, ()))
    pipe_seq = PIPE_STAGES * PIPE_SEQ
    for uly in SMALL_PIPE_SEQ_RUNS:
        jobs[pipe_seq].append((small_pipe_tag(PIPE_SEQ, uly),
                               _small_pipe_rank, (PIPE_SEQ, uly)))
    jobs[pipe_seq].append(("pipe_seq_full_", _full_pipe_rank,
                           (seed, FULL_PIPE_SEQ_DEPTH, PIPE_SEQ, True,
                            FULL_PIPE_SEQ_REF)))
    for shape, (uly, cases) in sorted(SMALL_SERVING_CASES.items(),
                                      key=lambda kv: "server" in kv[1][1]):
        jobs.setdefault(int(np.prod(shape)), []).append(
            ("serving" + mesh_tag(shape), _small_serving_rank,
             (shape, uly, cases)))
    mesh, serving, train, pipe, pipe_seq = {}, {}, {}, {}, {}
    train_cpu = None
    for world, world_jobs in sorted(jobs.items()):
        t0 = time.perf_counter()
        records = mesh_jobs(world, world_jobs)
        for tag, fn, args in world_jobs:
            if fn is _small_pipe_rank:
                got = check_small_pipe(records[tag], cpu_side("small_pipe"),
                                       *args)
                if args:
                    pipe_seq = _add(pipe_seq, got)
                else:
                    pipe = got
                continue
            if fn is _full_pipe_rank:
                pipe_seq = _add(pipe_seq, check_full_pipe(
                    pipe_seq_ref, records[tag], *args[1:4]))
                continue
            shape, uly, third = args
            if tag.startswith("mesh"):
                mesh = _add(mesh, check_small_mesh(shape, uly, records[tag],
                                                   cpu_outs))
            elif tag.startswith("train"):
                train_cpu = train_cpu or cpu_side("small_mesh_train")
                train = _add(train, check_small_mesh_train(
                    shape, uly, third, records[tag], train_cpu))
            else:
                serving = _add(serving, check_small_serving(
                    shape, uly, third, records[tag], cpu))
        say("small_mesh_world", ranks=world,
            meshes="|".join(tag.rstrip("_") for tag, _, _ in world_jobs),
            seconds=f"{time.perf_counter() - t0:.2f}")
    shutil.rmtree(SERVING_DIR, ignore_errors=True)
    os.remove(FULL_PIPE_SEQ_REF)
    say("small_meshes_phase", seconds=f"{time.perf_counter() - t_phase:.2f}")
    return mesh, serving, train, pipe, pipe_seq


FULL_SERVING_DIR = os.path.join(REPO, "build", "mesh_serving_full")
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


def instrument_entry(sampler, entry, denoiser, runs, stages):
    """Wrap ``sampler``'s generate call ``entry`` and its ``denoiser``'s
    ``denoise`` in place: each generate call appends to ``runs`` its
    seconds, s per denoise step (CUDA events from the denoise's progress
    callback, which the serve path leaves free), peak GB and kernel
    launches (the counts set to 0 at its start); the denoise's stages
    (Wan2.2: the control adapters, "swap") go to ``stages``."""
    import torch
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    generate, denoise, steps = getattr(sampler, entry), denoiser.denoise, []

    def timed_denoise(*a, **k):
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def progress(done, total):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        if k.get("progress_callback") is not None:
            raise AssertionError("the serve path passed a progress callback")
        k["progress_callback"] = progress
        inner = k.get("stage_callback") or (lambda name: None)
        if "stage_callback" in k:
            k["stage_callback"] = lambda name: (stages.append(name),
                                                inner(name))
        out = denoise(*a, **k)
        steps.append(events)
        return out

    def timed_generate(*a, **k):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        steps.clear()
        t0 = time.perf_counter()
        out = generate(*a, **k)
        torch.cuda.synchronize()
        runs.append({"seconds": time.perf_counter() - t0,
                     "steps": [e[i].elapsed_time(e[i + 1]) / 1e3
                               for e in steps for i in range(len(e) - 1)],
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": dict(fa.LAUNCHES)})
        return out
    setattr(sampler, entry, timed_generate)
    denoiser.denoise = timed_denoise


def serve_on_mesh(rank, mesh, sampler, args, batches, max_batch):
    """The served mesh as ``cli.serve`` runs it: rank 0 a
    ``GenerationServer`` over ``serve.make_batch_fn`` on 127.0.0.1:0, each
    batch of ``batches`` (lists of requests) posted over HTTP once the one
    before is done, then ``serve.stop``; the other ranks ``serve.follow``.
    Rank 0 returns the jobs' results (statuses checked), the others None."""
    import urllib.request
    from fantasy_world_tpu_torch.cli import serve
    from fantasy_world_tpu_torch.serving.server import GenerationServer
    if rank != 0:
        ran = serve.follow(sampler, args, mesh)
        if ran != len(batches):
            raise AssertionError(f"rank {rank} followed {ran} batches")
        return None
    server = GenerationServer(
        serve.make_batch_fn(sampler, args, mesh, args.variant == "wan22"),
        port=0, max_batch=max_batch, linger_s=1.0)
    server.start()
    done = []
    try:
        for batch in batches:
            ids = []
            for r in batch:
                post = urllib.request.Request(
                    f"http://127.0.0.1:{server.port}/v1/generate",
                    data=json.dumps(r).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(post, timeout=30) as resp:
                    ids.append(json.loads(resp.read())["job_id"])
            deadline, jobs = time.time() + 600, []
            while time.time() < deadline:
                jobs = [server.get(i) for i in ids]
                if all(j.status in ("done", "error") for j in jobs):
                    break
                time.sleep(0.05)
            bad = [(j.status, j.error) for j in jobs if j.status != "done"]
            if bad:
                raise AssertionError(f"served jobs: {bad}")
            done.append([j.result for j in jobs])
    finally:
        serve.stop(server, mesh)
    return done


def _full_serving_rank(rank, seed):
    """full_mesh_serving on one rank of the 1x1x2 mesh, through the serve
    CLI's entry points (``serve_on_mesh``), each rank's sampler built as
    ``serve.load_sampler`` builds it, from seeded weights: umT5-XXL, CLIP,
    the VAE and MoGe-2 on rank 0 only, the fusion model built whole,
    quantized to int8 and then split (``pipe.shard``). The Wan2.1 server
    takes two jobs (one B = 2 batch, 2 steps), then one TeaCache job (3
    steps, the plan skipping the second); then, CLIP and the fusion model
    gone, the Wan2.2 server (``--variant wan22``): both experts built as
    this rank's parts and placed (``DualModelDenoiser.place``), one job
    of 2 steps across the boundary. Records per generate call s per step,
    seconds, peak GB and launches; rank 0 its exports and the plan."""
    import argparse
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.core.quant import count_quantized
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
    from fantasy_world_tpu_torch.parallel import sharding
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    from fantasy_world_tpu_torch.pipelines.wan_video_22 import (
        DualModelDenoiser, expert_bytes)
    from fantasy_world_tpu_torch.sampler import (FantasyWorldSampler,
                                                 Wan22Sampler)
    from fantasy_world_tpu_torch.serving.server import expandable_segments
    # as cli.serve's main does on every rank, before the models load (the
    # ranks share this card: the default segments stay)
    alloc = expandable_segments()
    dev = _rank_setup()
    mesh = sharding.make_mesh(1, 1, 2)
    cfg, pcfg, wcfg, (h, w, n), (wh, ww, wn) = full_serving_configs()
    g = torch.Generator(device=dev).manual_seed(seed)
    tok = os.path.join(FULL_SERVING_DIR, "tok")
    record, runs, stages, exported = {"alloc": alloc}, [], [], {}

    def recording_export(sampler):
        export = sampler.export

        def recorded(video, pred, out_dir, **kw):
            exported[os.path.basename(out_dir)] = (
                list(video.shape), str(video.dtype),
                {k: list(v.shape) for k, v in pred.items()},
                bool(all(np.isfinite(v).all() for v in pred.values())))
            paths = export(video, pred, out_dir, **kw)
            exported[os.path.basename(out_dir)] += (
                sorted(os.listdir(out_dir)),)
            return paths
        sampler.export = recorded

    t0 = time.perf_counter()
    # rank 0 alone conditions and decodes (``serve.load_sampler``'s
    # ``encoders``); the encoders' own seed keeps every rank's models equal
    enc, moge = ({}, None) if rank else full_encoders(
        dev, torch.Generator(device=dev).manual_seed(seed + 1))
    fusion = build(lambda: FusionModel(cfg), device=dev, dtype=torch.bfloat16,
                   generator=g)
    pose = build(lambda: CameraPoseEncoder(pcfg), device=dev,
                 dtype=torch.bfloat16, generator=g)
    pipe = FantasyWorldPipeline(fusion, pose, **enc, tokenizer_path=tok)
    # the serve CLI's order: quantized whole, then split
    layers = pipe.quantize("int8")
    pipe.shard(mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    record["build"] = {"seconds": time.perf_counter() - t0, "layers": layers,
                       "weights_gb": torch.cuda.memory_allocated() / 1e9,
                       "quantized": count_quantized(fusion)}
    sampler = FantasyWorldSampler(pipe, moge)
    instrument_entry(sampler, "generate_videos", pipe, runs, stages)
    recording_export(sampler)
    thresh, plan = tea_threshold(fusion.dit, 3, dev)
    record["tea_plan"] = "".join("s" if s else "c" for s in plan)
    req = {"image_path": EXAMPLE_IMAGE, "camera_json": FULL_SERVING_CAMERAS,
           "height": h, "width": w, "num_frames": n, "sample_steps": 2,
           "neg_prompt": NEG_PROMPT}
    batches = [[dict(req, prompt=p, seed=seed + i)
                for i, p in enumerate(SERVE_PROMPTS[:SERVE_CLIPS])],
               [dict(req, prompt=PROMPT, seed=seed + 2, sample_steps=3,
                     tea_cache_l1_thresh=thresh)]]
    args = argparse.Namespace(segment_size=None, ulysses=False,
                              output_root=os.path.join(FULL_SERVING_DIR,
                                                       "wan21"),
                              variant="wan21")
    record["wan21_results"] = serve_on_mesh(rank, mesh, sampler, args,
                                            batches, SERVE_CLIPS)
    del sampler, pipe, fusion, pose
    enc.pop("clip", None)
    gc.collect()
    torch.cuda.empty_cache()
    # Wan2.2: each expert built as this rank's part (no whole expert on
    # any rank), then placed beside umT5, the VAE and MoGe
    t0 = time.perf_counter()
    experts = []
    for _ in range(2):
        m = build(lambda: FusionModel(wcfg), device=dev, dtype=torch.bfloat16,
                  generator=g, mesh=mesh)
        wake_zero_inits(m, g)
        experts.append(m)
    den = DualModelDenoiser(*experts).place()
    torch.cuda.synchronize()
    record["wan22_build"] = {
        "seconds": time.perf_counter() - t0,
        "expert_gb": expert_bytes(experts[0]) / 1e9,
        "devices": "|".join(str(den._device_of(m)) for m in experts),
        "resident_gb": torch.cuda.memory_allocated() / 1e9}
    sampler = Wan22Sampler(FantasyWorldPipeline(
        t5=enc.get("t5"), vae=enc.get("vae"), tokenizer_path=tok), den, moge)
    instrument_entry(sampler, "generate_video", den, runs, stages)
    recording_export(sampler)
    args = argparse.Namespace(segment_size=None, ulysses=False,
                              output_root=os.path.join(FULL_SERVING_DIR,
                                                       "wan22"),
                              variant="wan22")
    record["wan22_results"] = serve_on_mesh(
        rank, mesh, sampler, args,
        [[dict(req, prompt=PROMPT, seed=seed, height=wh, width=ww,
               num_frames=wn)]], 1)
    record["wan22_stages"] = "|".join(stages)
    record["runs"] = runs
    record["exported"] = exported
    _rank_record(rank, **record)


def expert_part_bytes(cfg, model_ranks: int) -> int:
    """The bytes of one rank's part of a bf16 fusion model of ``cfg`` at
    a model split of ``model_ranks`` (``sharding.PARAM_RULES``), reckoned
    on the meta device."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.parallel import sharding
    model = build(lambda: FusionModel(cfg), device="meta",
                  dtype=torch.bfloat16)
    sizes = {"data": 1, "seq": 1, "model": model_ranks}
    total = 0
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        spec = sharding.param_spec(name, t.shape, sizes)
        total += t.numel() * t.element_size() // math.prod(
            sizes[a] for a in spec if a)
    return total


# the one-process Wan2.2 clip of wan22_both_resident: each expert cut to
# the fewest blocks (half PCB, half IRG) at which it holds at least a rank's
# part of the full expert at a model split of 2
BOTH_RESIDENT_DEPTHS = tuple((2 * k, k) for k in range(8, 20))


def wan22_both_resident(device, seed=1024, steps=2):
    """The placement a rank takes from ``--mesh_model 2`` on, one rank a
    card, exercised in one process: two experts of the full width, each cut
    to the first of ``BOTH_RESIDENT_DEPTHS`` that holds at least a rank's
    part of the full expert at M = 2 (``expert_part_bytes``), built on the
    card beside umT5-XXL, the VAE and MoGe-2; ``DualModelDenoiser.place``
    must keep both there (``both_fit``); then ``Wan22Sampler.generate_video``
    at 480x832x81, ``steps`` steps with the heads and the tiled decode.
    One process holds the whole activations, more than a rank of the split
    does, so its peak bounds the rank's from above. Prints the resident and
    peak GB (through the decode and before it), checks that no expert
    swapped, the peak above the two experts within
    ``ACTIVATION_RESERVE_BYTES``, finite outputs of their shapes and the
    exact launches; returns the launches."""
    import torch
    from fantasy_world_tpu_torch.convert.checkpoint import wan22_fusion_config
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.moge.model import MoGeConfig
    from fantasy_world_tpu_torch.models.wan.t5 import T5Config
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines import wan_video_22 as w22
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    from fantasy_world_tpu_torch.sampler import Wan22Sampler
    height, width, frames = 480, 832, 81
    t_phase = time.perf_counter()
    base = wan22_fusion_config()
    part = expert_part_bytes(base, 2)
    depth = next(d for d in BOTH_RESIDENT_DEPTHS
                 if expert_part_bytes(mesh_fusion_config(d, base), 1) >= part)
    cfg = mesh_fusion_config(depth, base)
    g = torch.Generator(device=device).manual_seed(seed + 5)
    enc, moge = full_encoders(device, g, clip=False)
    experts = []
    for _ in range(2):
        m = build(lambda: FusionModel(cfg), device=device,
                  dtype=torch.bfloat16, generator=g)
        wake_zero_inits(m, g)
        experts.append(m)
    den = w22.DualModelDenoiser(*experts).place()
    devices = [str(den._device_of(m)) for m in experts]
    tok = os.path.join(FULL_SERVING_DIR, "tok_one")
    write_tokenizer(T5Config().vocab, tok)
    sampler = Wan22Sampler(FantasyWorldPipeline(
        t5=enc["t5"], vae=enc["vae"], tokenizer_path=tok), den, moge)
    image, cams = clip_inputs(height, width, frames)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    stages, denoised = [], []
    denoise = den.denoise

    def measured(*a, **k):
        out = denoise(*a, **k)
        torch.cuda.synchronize()
        denoised.append(torch.cuda.max_memory_allocated())
        return out
    den.denoise = measured
    stage = stages.append
    t0 = time.perf_counter()
    video, pred = sampler.generate_video(
        PROMPT, NEG_PROMPT, image=image, camera_params=cams, seed=seed,
        height=height, width=width, num_frames=frames, sample_steps=steps,
        stage_callback=stage)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    pair = 2 * w22.expert_bytes(experts[0])
    mcfg = MoGeConfig()
    want = expected_launches(cfg, steps, moge=(
        mcfg, moge_tokens(mcfg, image.shape[:2])))
    shapes = expected_shapes(cfg, height, width, frames)
    say("wan22_both_resident", seconds=f"{seconds:.2f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.2f}",
        blocks=f"{cfg.start_index}+{cfg.num_irg}",
        expert_gb=f"{pair / 2e9:.2f}",
        rank_part_gb_at_model_2=f"{part / 1e9:.2f}", devices="|".join(devices),
        resident_gb=f"{resident / 1e9:.2f}",
        peak_gb_before_decode=f"{denoised[0] / 1e9:.2f}",
        peak_gb=f"{peak / 1e9:.2f}",
        peak_above_experts_gb=f"{(peak - pair) / 1e9:.2f}",
        reserve_gb=f"{w22.ACTIVATION_RESERVE_BYTES / 1e9:.2f}",
        stages="|".join(stages), video_shape="x".join(map(str, video.shape)),
        launches=_nonzero(launches))
    if any(d != str(device) for d in devices) or "swap" in stages:
        raise AssertionError(f"both experts should stay on {device}: "
                             f"{devices}, stages {stages}")
    if peak - pair > w22.ACTIVATION_RESERVE_BYTES:
        raise AssertionError(f"the clip took {(peak - pair) / 1e9:.2f} GB "
                             f"beside the experts, beyond the reserve")
    if video.shape != (frames, height, width, 3) or video.dtype != np.uint8:
        raise AssertionError(f"video {video.shape} {video.dtype}")
    for k, v in pred.items():
        if tuple(v.shape) != shapes[k] or not np.isfinite(v).all():
            raise AssertionError(f"{k} {v.shape}, finite "
                                 f"{np.isfinite(v).all()}")
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    return launches


def phase_full_mesh_serving(device, seed=1024):
    """The serve CLI's mesh at full width on 2 ranks sharing this card
    (1x1x2), cut to ``MESH_SERVING_DEPTH`` (``_full_serving_rank``): the
    Wan2.1 server (``FusionConfig()`` at 336x592x81, int8) with a batch of
    2 jobs and a TeaCache job over HTTP, then the Wan2.2 server
    (480x832x81, 2 steps, one per expert: two ranks' parts of both experts
    do not fit one card beside the reserve, ``both_fit``, so the low one
    waits in pinned host memory and swaps in). Prints s per step, seconds
    and peak GB per rank for each generate call, rank 0 with the encoders,
    and the launches, which must be exact; the exported
    clips of their shapes, finite, their MP4 and PLY written. Then
    ``wan22_both_resident`` in this process. Returns the launches, both
    ranks and this process summed."""
    import shutil
    from fantasy_world_tpu_torch.models.moge.model import MoGeConfig
    from fantasy_world_tpu_torch.models.wan.clip import CLIPVisionConfig
    from fantasy_world_tpu_torch.models.wan.t5 import T5Config
    from fantasy_world_tpu_torch.sampler import read_image
    t0 = time.perf_counter()
    shutil.rmtree(FULL_SERVING_DIR, ignore_errors=True)
    write_tokenizer(T5Config().vocab, os.path.join(FULL_SERVING_DIR, "tok"))
    records = mesh_run(_full_serving_rank, 2, seed)
    shape, modes = (1, 1, 2), MESH_MODES["full", (1, 1, 2), False]
    cfg, _, wcfg, (h, w, n), (wh, ww, wn) = full_serving_configs()
    fhw = ((n - 1) // 4 + 1, h // 16, w // 16)
    wfhw = ((wn - 1) // 4 + 1, wh // 16, ww // 16)
    mcfg = MoGeConfig()
    # MoGe sees the image as it is on disk
    moge = (mcfg, moge_tokens(mcfg, read_image(EXAMPLE_IMAGE).shape[:2]))
    per_clip = encoder_launches(CLIPVisionConfig(), moge)
    want = {"serve": lambda r: _add(mesh_launches(cfg, fhw, shape, modes, 2,
                                                  r, 512),
                                    *([per_clip] * SERVE_CLIPS
                                      if r == 0 else [])),
            "tea": lambda r: _add(mesh_launches(cfg, fhw, shape, modes, 3, r,
                                                512, skipped=1),
                                  *([per_clip] if r == 0 else [])),
            "wan22": lambda r: _add(mesh_launches(wcfg, wfhw, shape, modes, 2,
                                                  r, 512),
                                    *([encoder_launches(moge=moge)]
                                      if r == 0 else []))}
    total = {}
    for i, (run, expect) in enumerate(want.items()):
        got = [r["runs"][i] for r in records]
        say("full_mesh_serving", run=run, mesh="1x1x2", ranks=2,
            blocks=f"{cfg.start_index}+{cfg.num_irg}",
            rank_seconds="|".join(f"{x['seconds']:.3f}" for x in got),
            rank_step_seconds="|".join(
                "/".join(f"{s:.3f}" for s in x["steps"]) for x in got),
            rank_peak_gb="|".join(f"{x['peak_gb']:.2f}" for x in got),
            rank0_launches=_nonzero(got[0]["launches"]))
        bad = [r for r in range(2) if got[r]["launches"] != expect(r)]
        if bad:
            raise AssertionError(
                f"full_mesh_serving {run}: ranks {bad} launched "
                f"{[got[r]['launches'] for r in bad]}, want "
                f"{[expect(r) for r in bad]}")
        for x in got:
            total = _add(total, x["launches"])
    r0 = records[0]
    if any(len(r["runs"]) != 3 for r in records):
        raise AssertionError(f"generate calls per rank: "
                             f"{[len(r['runs']) for r in records]}")
    # the exports: 2 + 1 Wan2.1 clips and 1 Wan2.2 clip
    served = {os.path.basename(job["output_dir"]): geometry
              for results, geometry in ((r0["wan21_results"], (cfg, h, w, n)),
                                        (r0["wan22_results"],
                                         (wcfg, wh, ww, wn)))
              for batch in results for job in batch}
    if sorted(r0["exported"]) != sorted(served) or len(served) != 4:
        raise AssertionError(f"exported {sorted(r0['exported'])}, served "
                             f"{sorted(served)}")
    for job, (vshape, vdtype, pshapes, finite, files) in \
            r0["exported"].items():
        jcfg, jh, jw, jn = served[job]
        shapes = expected_shapes(jcfg, jh, jw, jn)
        if (tuple(vshape) != (jn, jh, jw, 3) or vdtype != "uint8"
                or not finite or not pshapes
                or any(tuple(v) != shapes[k] for k, v in pshapes.items())
                or not any(f.startswith("video") for f in files)
                or not any(f.endswith(".ply") for f in files)):
            raise AssertionError(f"job {job}: video {vshape} {vdtype}, "
                                 f"finite {finite}, {pshapes}, {files}")
    say("full_mesh_serving_phase", seconds=f"{time.perf_counter() - t0:.2f}",
        int8_layers=r0["build"]["quantized"],
        weights_gb="|".join(f"{r['build']['weights_gb']:.2f}"
                            for r in records),
        build_seconds=f"{r0['build']['seconds']:.2f}",
        tea_plan=r0["tea_plan"],
        wan22_expert_gb=f"{r0['wan22_build']['expert_gb']:.2f}",
        wan22_resident_gb="|".join(f"{r['wan22_build']['resident_gb']:.2f}"
                                   for r in records),
        wan22_devices=r0["wan22_build"]["devices"],
        wan22_stages=r0["wan22_stages"], allocator=r0["alloc"],
        exported="|".join(f"{k}:{'x'.join(map(str, v[0]))}"
                          for k, v in sorted(r0["exported"].items())))
    if r0["tea_plan"] != "csc":
        raise AssertionError(f"full-width TeaCache plan {r0['tea_plan']}")
    if "swap" not in r0["wan22_stages"].split("|"):
        raise AssertionError(f"Wan2.2 stages {r0['wan22_stages']}: the "
                             f"experts did not trade places")
    total = _add(total, wan22_both_resident(device, seed))
    shutil.rmtree(FULL_SERVING_DIR, ignore_errors=True)
    return total


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
    from fantasy_world_tpu_torch.models.moge.model import MoGeConfig
    from fantasy_world_tpu_torch.models.wan.clip import CLIPVisionConfig
    from fantasy_world_tpu_torch.models.wan.t5 import T5Config
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    from fantasy_world_tpu_torch.sampler import FantasyWorldSampler
    cfg = pipe.cfg
    height, width, frames = 336, 592, 81
    t_phase = t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed + 2)
    enc, moge = full_encoders(device, g)
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
        weights_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}",
        registry=check_detected("full_wan22", high.state_dict(), "wan22",
                                cfg))
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


def aliased_pose_dit(fusion_dit, method, device, generator=None, like=None):
    """A full-width standalone ``WanDiT`` with the latent pose adapter
    ``method`` whose tensors are the resident fusion DiT's: built on the
    meta device, every tensor but the adapters pointed at ``fusion_dit``'s
    (nothing copied); the adapters (2 x plucker_dim x dim a block) taken
    from the DiT ``like``, or allocated on ``device`` and woken from
    ``generator``."""
    import dataclasses
    import torch
    from fantasy_world_tpu_torch.models.wan.dit import WanDiT
    cfg = dataclasses.replace(fusion_dit.cfg, pose_inject_method=method)
    with torch.device("meta"):
        dit = WanDiT(cfg)
    dit = dit.to(fusion_dit.patch_embedding.weight.dtype)
    src = {k: v for k, v in fusion_dit.state_dict().items()
           if ".processor." not in k}
    if like is not None:
        src.update({k: v for k, v in like.state_dict().items()
                    if ".processor." in k})
    dit.load_state_dict(src, strict=False, assign=True)
    if like is None:
        for blk in dit.blocks:
            proc = blk.cross_attn.processor
            if proc is not None:
                proc.to_empty(device=device)
                wake_pose_adapter(proc, generator, std=0.02)
    meta = [n for n, t in dit.state_dict().items() if t.is_meta]
    if meta:
        raise AssertionError(f"{method} DiT: {len(meta)} tensors left on "
                             f"the meta device, e.g. {meta[:3]}")
    return dit


def phase_full_options(device, pipe, cond, plucker_fea, seed=1024,
                       geometry=(336, 592, 81)):
    """The options at full width on ``phase_full_slice``'s resident
    ``FusionConfig()`` model, its bicross gates woken for the phase (they
    carry the geometry stream into the video's) and put back after: one
    CFG-pair ``joint_forward`` at 336x592, 81 frames, plain, with the
    example camera path's pose encodings as camera tokens (2, 81, 9), and
    with ``uncond``; ``forward_temporal`` of the first IRG block's bicross
    on random streams of its shapes (T = R = 21, S = 777, M = 782); then
    one forward of a full-width Wan2.1-I2V-14B ``WanDiT`` with each latent
    pose method, its tensors the fusion DiT's and only its 25 adapters new.
    Each: shapes, finiteness, exact launches, seconds, peak GB; the camera
    and uncond outputs must differ from the plain one. Returns the
    launches."""
    import torch
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    cfg, fusion = pipe.cfg, pipe.fusion
    dt = pipe.dtype
    height, width, frames = geometry
    f, lh, lw = (frames - 1) // 4 + 1, height // 8, width // 8
    tokens = f * (lh // 2) * (lw // 2)
    t_phase = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed)
    lat = torch.randn((2, cfg.dit.out_dim, f, lh, lw), generator=g,
                      device=device).to(dt)
    ts = torch.full((2,), 900.0, device=device)
    ctx = torch.cat([cond[0], cond[1]]).to(device, dt)
    clip = torch.cat([cond[2]] * 2).to(device, dt)
    y = torch.cat([cond[3]] * 2).to(device, dt)
    pl2 = torch.cat([plucker_fea] * 2)
    cam = pose_encodings(height, width, frames).expand(2, -1, -1).to(device)
    joint = (lat, ts, ctx, clip, y)
    T, S, R = f, tokens // f, f
    M = S + cfg.vggt.aggregator.patch_start_idx
    x1 = torch.randn((2, T * S, cfg.bicross.m1_dim), generator=g,
                     device=device).to(dt)
    x2 = torch.randn((2, R * M, cfg.bicross.m2_dim), generator=g,
                     device=device).to(dt)
    launches = no_launches()
    rows, outs = [], {}

    def measure(name, run, want):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(fa.LAUNCHES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.no_grad():
            out = run()
        end.record()
        end.synchronize()
        got = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        out = out if isinstance(out, tuple) else (out,)
        finite = all(bool(torch.isfinite(o).all()) for o in out)
        rows.append(f"{name}:{start.elapsed_time(end) / 1e3:.3f}s:"
                    f"{torch.cuda.max_memory_allocated() / 1e9:.2f}GB:"
                    + ",".join("x".join(map(str, o.shape)) for o in out)
                    + f":finite={finite}:" + json.dumps(
                        {k: v for k, v in got.items() if v}
                    ).replace(" ", ""))
        if got != want or not finite:
            raise AssertionError(f"full_options {name}: launches {got} "
                                 f"(want {want}), finite {finite}")
        for k, v in got.items():
            launches[k] += v
        outs[name] = out

    gammas = [(b.gamma_m1, b.gamma_m2) for b in fusion.bicross]
    saved = [(a.clone(), b.clone()) for a, b in gammas]
    try:
        with torch.no_grad():
            for pair in gammas:
                for gamma in pair:
                    gamma.normal_(0.0, 0.1, generator=g)
        measure("plain", lambda: fusion.joint_forward(
            *joint, plucker_fea=pl2)[0], joint_launches(cfg))
        measure("camera_token", lambda: fusion.joint_forward(
            *joint, plucker_fea=pl2, camera_token=cam)[0],
            joint_launches(cfg))
        measure("uncond", lambda: fusion.joint_forward(
            *joint, plucker_fea=pl2, uncond=True)[0],
            joint_launches(cfg, uncond=True))
        measure("temporal", lambda: fusion.bicross[0].forward_temporal(
            x1, x2, T, S, R, M), temporal_launches(cfg.bicross, T, S, R, M))
    finally:
        with torch.no_grad():
            for (a, b), (sa, sb) in zip(gammas, saved):
                a.copy_(sa)
                b.copy_(sb)
    moved = {name: _rel_l2([outs[name][0]], [outs["plain"][0]])
             for name in ("camera_token", "uncond")}
    del x1, x2, outs["temporal"]
    dit = None
    for method in POSE_METHODS:
        dit = aliased_pose_dit(fusion.dit, method, device, generator=g,
                               like=dit)
        measure(method, lambda: dit(lat, ts, ctx, clip_feature=clip, y=y,
                                    plucker_fea=pl2),
                pose_dit_launches(dit.cfg, tokens, f))
    del dit
    say("full_options", seconds=f"{time.perf_counter() - t_phase:.2f}",
        runs="|".join(rows),
        rel_l2_vs_plain=json.dumps({k: float(f"{v:.3e}")
                                    for k, v in moved.items()}
                                   ).replace(" ", ""),
        launches=json.dumps({k: v for k, v in launches.items() if v}
                            ).replace(" ", ""))
    unmoved = [k for k, v in moved.items() if not v > 0]
    if unmoved:
        raise AssertionError(f"full_options: {unmoved} equal the plain "
                             f"forward")
    del outs, lat, ctx, clip, y, pl2
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


SMALL_TI2V_RUN = (512, 768, 21, 2)     # height, width, frames, steps


def small_ti2v_run(dev, dtype):
    """One side of ``small_ti2v``: the TI2V-5B clip (``run_ti2v``) on
    ``dev`` in ``dtype`` from f32 weights built on the CPU from a seed,
    then the float decode of its latents and of unit-normal latents (the
    VAE's own bf16 error, apart from the range of the denoised latents).
    Returns these (f32 CPU tensors), the first-frame latent, the video,
    the launches, whether frame 0 was clamped to it and the tokenizer's
    kind, and ``decode_here``: the float decode of given latents by this
    side's VAE (the card's, of the CPU side's latents)."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.wan.dit import WanDiT
    from fantasy_world_tpu_torch.models.wan.t5 import T5Encoder
    from fantasy_world_tpu_torch.models.wan.vae38 import WanVAE38
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    from fantasy_world_tpu_torch.sampler import image_pm1
    dcfg, t5c, vcfg = small_ti2v_configs()
    ctors = {"dit": (WanDiT, dcfg), "t5": (T5Encoder, t5c),
             "vae": (WanVAE38, vcfg)}
    height, width, frames, steps = SMALL_TI2V_RUN
    g = torch.Generator("cpu").manual_seed(17)
    mods = {n: build(lambda: c(cfg), device="cpu", dtype=torch.float32,
                     generator=g) for n, (c, cfg) in ctors.items()}
    image, _ = clip_inputs(height, width, frames)
    image = image_pm1(image, height, width)
    rand_lat = torch.randn(small_ti2v_latent_shape(), generator=g)
    if dev.type != "cpu":
        weights, mods = mods, {}
        for n, (c, cfg) in ctors.items():
            mods[n] = build(lambda: c(cfg), device=dev, dtype=dtype)
            mods[n].load_state_dict(weights[n].state_dict())
        del weights
    pipe = FantasyWorldPipeline(t5=mods["t5"], vae=mods["vae"],
                                dit=mods["dit"])
    tok = install_tokenizer(pipe, t5c.vocab, os.path.join(
        REPO, "build", "small_ti2v", f"tok_{dev.type}"))
    fa.reset_launch_counts()
    lat, first, video = run_ti2v(pipe, image, height, width, frames, steps,
                                 seed=3)
    launches = dict(fa.LAUNCHES)
    out = {"latents": lat.float().cpu(), "first": first.float().cpu(),
           "video": video, "launches": launches, "tok": tok,
           "clamped": torch.equal(lat[:, :, :1], first.to(lat.dtype))}
    with torch.no_grad():
        out["decode"] = pipe.vae.decode(lat).float().cpu()
        out["decode_random_latents"] = pipe.vae.decode(
            rand_lat.to(dev, dtype)).float().cpu()
    vae = pipe.vae

    @torch.no_grad()
    def decode_here(latents):
        return vae.decode(latents.to(dev, dtype)).float().cpu()
    out["decode_here"] = decode_here
    return out


def small_ti2v_latent_shape():
    height, width, frames, _ = SMALL_TI2V_RUN
    return (1, 48, (frames - 1) // 4 + 1, height // 16, width // 16)


def phase_small_ti2v(device):
    """The TI2V-5B path at the widths of ``small_ti2v_configs``, 512x768,
    21 frames, 2 steps, on the card in bf16 against the CPU in f32 from the
    same weights (``small_ti2v_run``): the first-frame latent, the latents,
    the float decode of each run's latents, the card's decode of the CPU's
    latents and both decodes of unit-normal latents within SLICE_TOL,
    frame 0 equal to the clean latent after the loop, exact launches.
    Runs the card side; returns the check, which takes the CPU side when
    called (after the mesh phases)."""
    import torch
    t0 = time.perf_counter()
    card = small_ti2v_run(device, torch.bfloat16)
    card_s = time.perf_counter() - t0
    return lambda: check_small_ti2v(card, card_s)


def check_small_ti2v(card, card_s):
    import shutil
    t0 = time.perf_counter()
    dcfg = small_ti2v_configs()[0]
    height, width, frames, steps = SMALL_TI2V_RUN
    cpu = cpu_side("small_ti2v")
    # the CPU's latents through the card's VAE: the VAE alone
    card["decode_same_latents"] = card.pop("decode_here")(cpu["latents"])
    shutil.rmtree(os.path.join(REPO, "build", "small_ti2v"),
                  ignore_errors=True)
    errs = {k: _rel_l2([card[k]], [cpu[k]])
            for k in ("first", "latents", "decode")}
    errs["decode_same_latents"] = _rel_l2([card["decode_same_latents"]],
                                          [cpu["decode"]])
    errs["decode_random_latents"] = _rel_l2(
        [card["decode_random_latents"]], [cpu["decode_random_latents"]])
    want = ti2v_launches(dcfg, steps)
    # the card side's seconds and this check's; the CPU side's apart
    say("small_ti2v", seconds=f"{card_s + time.perf_counter() - t0:.2f}",
        cpu_side_seconds=f"{cpu['seconds']:.2f}",
        tokenizer=card["tok"], image="example_png",
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
    if tuple(card["latents"].shape) != small_ti2v_latent_shape() \
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
    is the clean first-frame latent. Between the conditioning and the
    denoise, ``ti2v_reload_check`` (the registry's TI2V entry, and a second
    DiT from ``ModelManager`` with a bit-equal step output); its two
    forwards' launches are counted apart. The check comes before the
    denoise and not just before the decode: there, the second DiT's
    allocations, freed with the cache, left the tiled decode half as slow
    again (most likely because cuDNN keeps the plan it first finds for a
    convolution's shape, and which plans it can take depends on the
    allocator's state at that moment)."""
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
    reload = {}

    def reload_check(noise, context, first):
        before = dict(fa.LAUNCHES)
        ti2v_reload_check(device, dit, noise, context, first)
        reload.update({k: fa.LAUNCHES[k] - before[k] for k in before})
        mark("reload_check")
    lat, first, video = run_ti2v(pipe, image, height, width, frames, steps,
                                 seed, mark=mark, tiled=True,
                                 before_denoise=reload_check)
    torch.cuda.synchronize()
    # the clip's launches: the reload check's two forwards are a
    # comparison, counted apart
    launches = {k: v - reload[k] for k, v in fa.LAUNCHES.items()}
    stage_s = {name: marks[i - 1][1].elapsed_time(ev) / 1e3
               for i, (name, ev, _) in enumerate(marks) if i}
    peak_gb = {name: peak / 1e9 for name, _, peak in marks[1:]}
    step_s = [stage_s[f"denoise_step{i}"] for i in range(1, steps + 1)]
    fixed = sum(v for k, v in stage_s.items()
                if not k.startswith("denoise") and k != "reload_check")
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
                            ).replace(" ", ""),
        reload_check_launches=json.dumps({k: v for k, v in reload.items()
                                          if v}).replace(" ", ""))
    # the resident DiT's forward and the reloaded one's
    if reload != ti2v_launches(TI2V_5B, 2):
        raise AssertionError(f"TI2V reload check launches {reload}")
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


def phase_full_verify(device, pipe, steps=2, frames=9):
    """``cli/verify_weights.py``'s checks on the resident full-width,
    full-depth Wan2.1 model of ``phase_full_slice``: the census against
    ``FusionConfig()`` built on the meta device, the NaN/Inf scan of every
    tensor of the fusion model and the pose encoder, the registry (the
    reference-layout base DiT must detect as the 14B I2V entry), a 2-step
    denoise of 9 frames at 336x592 with the heads, and the heads' sanity.
    Each check's seconds and peak GB; exact launches. Returns the
    launches."""
    import torch
    from fantasy_world_tpu_torch.cli import verify_weights as vw
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    cfg = pipe.fusion.cfg
    seconds, peak, res = {}, {}, {}

    def check(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res[name] = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        peak[name] = torch.cuda.max_memory_allocated() / 1e9

    check("census", lambda: vw.census(pipe.fusion.state_dict(),
                                      vw.architecture(cfg)))
    check("finite", lambda: vw.finiteness(
        {"fusion": pipe.fusion.state_dict(),
         "pose": pipe.pose_encoder.state_dict()}, device))
    check("registry", lambda: check_detected(
        "full_verify", pipe.fusion.state_dict(), "wan21", cfg))
    fa.reset_launch_counts()
    check("denoise", lambda: vw.denoise_check(pipe, cfg, "wan21",
                                              steps=steps, frames=frames))
    launches = dict(fa.LAUNCHES)
    detail, pred = res["denoise"]
    check("heads", lambda: vw.head_sanity(pred))
    want = expected_launches(cfg, steps)
    say("full_verify", seconds=json.dumps(
        {k: round(v, 3) for k, v in seconds.items()}).replace(" ", ""),
        peak_gb=json.dumps({k: round(v, 2) for k, v in peak.items()}
                           ).replace(" ", ""),
        census_keys=res["census"]["keys"],
        census_ok=res["census"]["ok"], scanned=res["finite"]["scanned"],
        nonfinite=len(res["finite"]["nonfinite"]), registry=res["registry"],
        latent_shape="x".join(map(str, detail["latent_shape"])),
        denoise_ok=detail["ok"], heads_ok=res["heads"]["ok"],
        launches=json.dumps({k: v for k, v in launches.items() if v}
                            ).replace(" ", ""))
    failed = [k for k in ("census", "finite", "heads") if not res[k]["ok"]]
    if failed or not detail["ok"]:
        raise AssertionError(f"full_verify: {failed or 'denoise'} failed: "
                             f"{ {k: res[k] for k in failed} }")
    if launches != want:
        raise AssertionError(f"full_verify launches {launches} != {want}")
    return launches


def phase_full_track(device, points=TRACK_POINTS, seed=1024):
    """The track head at full width from a seed: ``TrackConfig()`` (4
    iterations, 6 blocks of 384, 8 heads of 48, 7 pyramid levels) over
    the feature-only DPT of VGGT's 1024-wide aggregated tokens (2048 with
    the frame and global halves) of 21 latent frames at 336x592, so 81
    frames of 168 x 296 feature maps, and ``points`` query points. Prints
    the feature extractor's and the tracker's seconds and peak GB (CUDA
    events), the seconds inside the tracker's attention calls (their zero
    padding of D 48 to 64 included), exact launches, and the outputs'
    shapes and finiteness. Returns the launches."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.vggt import track as track_mod
    from fantasy_world_tpu_torch.models.vggt.model import VGGTConfig
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    vcfg = VGGTConfig()
    tc, dpt = vcfg.track, vcfg.track_dpt
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed + 7)
    head = build(lambda: track_mod.TrackHead(tc, dpt), device=device,
                 dtype=torch.bfloat16, generator=g)
    ph, pw, latent_frames = 336 // 16, 592 // 16, 21
    toks, q = track_inputs(dpt, latent_frames, ph, pw, points, g,
                           device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() / 1e9
    spans = []
    attention = track_mod.dot_product_attention

    def timed_attention(q_, k_, v_, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        o = attention(q_, k_, v_, **kw)
        ev[1].record()
        spans.append(ev)
        return o
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    peaks = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    track_mod.dot_product_attention = timed_attention
    try:
        with torch.no_grad():
            events[0].record()
            fmaps = head.feature_extractor(toks, (ph, pw), 5)
            events[1].record()
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            torch.cuda.reset_peak_memory_stats()
            coords, vis, conf = head.tracker(q, fmaps)
            events[2].record()
    finally:
        track_mod.dot_product_attention = attention
    torch.cuda.synchronize()
    peaks.append(torch.cuda.max_memory_allocated() / 1e9)
    launches = dict(fa.LAUNCHES)
    fe_s = events[0].elapsed_time(events[1]) / 1e3
    tr_s = events[1].elapsed_time(events[2]) / 1e3
    attn_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    T = 1 + 4 * (latent_frames - 1)
    finite = all(bool(torch.isfinite(x).all()) for x in (*coords, vis, conf))
    shapes = {"fmaps": tuple(fmaps.shape), "track": tuple(coords[-1].shape),
              "vis": tuple(vis.shape), "conf": tuple(conf.shape)}
    want_shapes = {"fmaps": (1, T, tc.latent_dim, 168, 296),
                   "track": (1, T, points, 2), "vis": (1, T, points),
                   "conf": (1, T, points)}
    want = track_launches(tc)
    say("full_track", build_s=f"{build_s:.2f}",
        head_params=sum(p.numel() for p in head.parameters()),
        resident_gb=f"{resident:.2f}", feature_extractor_s=f"{fe_s:.3f}",
        tracker_s=f"{tr_s:.3f}", tracker_attention_s=f"{attn_s:.3f}",
        attention_calls=len(spans),
        feature_extractor_peak_gb=f"{peaks[0]:.2f}",
        tracker_peak_gb=f"{peaks[1]:.2f}", iters=len(coords),
        shapes=json.dumps({k: list(v) for k, v in shapes.items()}
                          ).replace(" ", ""), finite=finite,
        launches=json.dumps({k: v for k, v in launches.items() if v}
                            ).replace(" ", ""))
    if shapes != want_shapes or not finite:
        raise AssertionError(f"full_track: shapes {shapes} (want "
                             f"{want_shapes}), finite {finite}")
    if launches != want:
        raise AssertionError(f"full_track launches {launches} != {want}")
    del head, toks, fmaps, coords, vis, conf
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def ti2v_reload_check(device, dit, latents, context, first):
    """Before the TI2V denoise: the resident DiT's state dict in the
    reference layout (q/k columns interleaved back) must detect as the
    TI2V-5B entry, and ``ModelManager.load_model`` of that dict in memory
    must give a second DiT whose step output -- one forward of the
    positive row at t = 500 on ``latents`` (the conditioning's noise) with
    frame 0 fused -- equals the resident one's bit for bit. Prints the
    seconds and the peak GB; frees the second DiT."""
    import torch
    from fantasy_world_tpu_torch.convert.checkpoint import (
        dit_reference_state_dict)
    from fantasy_world_tpu_torch.convert.manager import ModelManager
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    h = check_detected("full_ti2v", dit.state_dict(), "ti2v")
    mm = ModelManager(device, torch.bfloat16)
    name = mm.load_model(dit_reference_state_dict(dit.state_dict(), dit.cfg))
    _, second = mm.fetch_model(name)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    # as denoise_ti2v feeds its DiT: the conditioning's noise and context
    # come from the host
    w = dit.patch_embedding.weight
    x = latents.to(w.device, w.dtype, copy=True)
    x[:, :, :1] = first.to(w.device, w.dtype)
    context = context.to(w.device, w.dtype)
    t = torch.full((x.shape[0],), 500.0, device=device)
    with torch.no_grad():
        a = dit(x, t, context, fuse_first_frame=True)
        b = second(x, t, context, fuse_first_frame=True)
    equal = torch.equal(a, b)
    torch.cuda.synchronize()
    say("full_ti2v_reload", registry=h, model=name,
        load_s=f"{load_s:.2f}", seconds=f"{time.perf_counter() - t0:.2f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        step_output_bit_equal=equal)
    if not equal:
        raise AssertionError("the DiT reloaded through ModelManager gives "
                             "another step output")
    del mm, second, a, b
    gc.collect()
    torch.cuda.empty_cache()


# the phases that ``--phases`` runs alone: each needs only the card
def _train_kernels_alone(device):
    """phase_train_kernels on its own (no forward phase before it)."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    phase_train_kernels(device, {k: {"max_abs_err": 0.0} for k in fa.ROUTES})


ALONE = {"kernels": phase_kernels, "train_kernels": _train_kernels_alone,
         "full_mesh": phase_full_mesh,
         "small_meshes": lambda device: phase_small_meshes(
             device, phase_small_slice(device)),
         "full_mesh_serving": phase_full_mesh_serving}


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="profile the second and the last step of one more "
                        "full-depth denoise, a third full-width training "
                        "step and both steps of one more Wan2.2 clip into "
                        "DIR")
    p.add_argument("--phases", default=None,
                   help="run only these phases (comma-separated: "
                        f"{', '.join(ALONE)}) after the build, and print no "
                        "kernels line and no device line: a partial check")
    args = p.parse_args(argv)
    only = None if args.phases is None else args.phases.split(",")
    if only is not None and not set(only) <= set(ALONE):
        p.error(f"--phases takes {', '.join(ALONE)}")
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
    if only is not None:
        for name in only:
            ALONE[name](device)
        say("done", seconds=f"{time.perf_counter() - t_start:.1f}",
            phases=args.phases)
        return 0
    # the reduced clips' CPU sides run beside the card's phases from here;
    # their checks wait until after the mesh phases
    cpu_pool = start_cpu_sides()
    per_kernel = phase_kernels(device)
    phase_train_kernels(device, per_kernel)
    phase_qlinear(device)
    small_cpu = phase_small_slice(device)
    phase_small_windowed(device)
    small_checks = [phase_small_clip(device), phase_small_wan22(device),
                    phase_small_ti2v(device)]
    phase_small_serve(device)
    phase_small_train(device)
    phase_train_cli()
    phase_train_cli_data()
    phase_small_verify()
    phase_small_track(device)
    phase_small_options(device)
    gc.collect()
    torch.cuda.empty_cache()
    # the mesh phases: ranks that share the card, before the full model
    # takes it
    # (pipe_train: the pipeline trainer's launches; ``pipe`` below is the
    # full model's pipeline)
    (mesh, mesh_serving, mesh_train, pipe_train,
     pipe_seq) = phase_small_meshes(device, small_cpu)
    full_mesh, full_mesh_train, full_pipe = phase_full_mesh(device)
    mesh = _add(mesh, full_mesh)
    mesh_train = _add(mesh_train, full_mesh_train)
    # pipe_train: every pipeline launch; pipe_seq: those with seq ranks
    pipe_train = _add(pipe_train, full_pipe, pipe_seq)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_serving = _add(mesh_serving, phase_full_mesh_serving(device))
    # the reduced clips against their CPU sides, done by now
    for check in small_checks:
        check()
    cpu_pool.close()
    cpu_pool.join()
    del small_checks
    gc.collect()
    torch.cuda.empty_cache()
    denoise, per_step, pipe, cond, plucker_fea = phase_full_slice(
        device, profile_dir=args.profile)
    verify = phase_full_verify(device, pipe)
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
    options = phase_full_options(device, pipe, cond, plucker_fea)
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
    gc.collect()
    torch.cuda.empty_cache()
    track = phase_full_track(device)

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
                         + ti2v[k] + verify[k] + track[k] + options[k]
                         + mesh.get(k, 0) + mesh.get(f"{k}_stats", 0)
                         + mesh_serving.get(k, 0)
                         + mesh_serving.get(f"{k}_stats", 0)
                         + mesh_train.get(f"{k}_stats", 0)
                         + pipe_train.get(f"{k}_stats", 0)),
            "denoise_launches": denoise[k],
            "mesh_launches": mesh.get(k, 0) + mesh.get(f"{k}_stats", 0),
            "mesh_train_launches": mesh_train.get(f"{k}_stats", 0),
            "pipe_train_launches": pipe_train.get(f"{k}_stats", 0),
            "pipe_seq_train_launches": pipe_seq.get(f"{k}_stats", 0),
            "mesh_serving_launches": (mesh_serving.get(k, 0)
                                      + mesh_serving.get(f"{k}_stats", 0)),
            "verify_launches": verify[k],
            "track_launches": track[k],
            "options_launches": options[k],
            "windowed_step_launches": windowed[k],
            "clip_run_launches": clip_run[k],
            "serve_launches": serve[k],
            "data_train_launches": data_train[k] + data_train[f"{k}_stats"],
            "wan22_clip_launches": wan22[k],
            "wan22_int8_step_launches": quant[k],
            "ti2v_clip_launches": ti2v[k],
            "launches_per_denoise_step": per_step[k],
            "stats_launches": (train[f"{k}_stats"] + data_train[f"{k}_stats"]
                               + mesh.get(f"{k}_stats", 0)
                               + mesh_serving.get(f"{k}_stats", 0)
                               + mesh_train.get(f"{k}_stats", 0)
                               + pipe_train.get(f"{k}_stats", 0)),
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
                        + mesh.get(f"{k}_stats", 0)
                        + mesh_serving.get(f"{k}_stats", 0)
                        + mesh_train.get(f"{k}_stats", 0)
                        + pipe_train.get(f"{k}_stats", 0)
                        for k in fa.ROUTES),
        "launches_by_route": {k: train[f"{k}_stats"]
                              + data_train[f"{k}_stats"]
                              + mesh.get(f"{k}_stats", 0)
                              + mesh_serving.get(f"{k}_stats", 0)
                              + mesh_train.get(f"{k}_stats", 0)
                              + pipe_train.get(f"{k}_stats", 0)
                              for k in fa.ROUTES},
        "mesh_launches": sum(mesh.get(f"{k}_stats", 0) for k in fa.ROUTES),
        "mesh_train_launches": sum(mesh_train.get(f"{k}_stats", 0)
                                   for k in fa.ROUTES),
        "pipe_train_launches": sum(pipe_train.get(f"{k}_stats", 0)
                                   for k in fa.ROUTES),
        "pipe_seq_train_launches": sum(pipe_seq.get(f"{k}_stats", 0)
                                       for k in fa.ROUTES),
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
                            + mesh_train.get(f"{k}_{d}", 0)
                            + pipe_train.get(f"{k}_{d}", 0)
                            for d in fa.BWD_D),
            "launches_by_head_dim": {d: train[f"{k}_{d}"]
                                     + data_train[f"{k}_{d}"]
                                     + mesh_train.get(f"{k}_{d}", 0)
                                     + pipe_train.get(f"{k}_{d}", 0)
                                     for d in fa.BWD_D},
            "mesh_train_launches": sum(mesh_train.get(f"{k}_{d}", 0)
                                       for d in fa.BWD_D),
            "pipe_train_launches": sum(pipe_train.get(f"{k}_{d}", 0)
                                       for d in fa.BWD_D),
            "pipe_seq_train_launches": sum(pipe_seq.get(f"{k}_{d}", 0)
                                           for d in fa.BWD_D),
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
