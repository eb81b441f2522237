#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA device

This script only runs the check: it prints the card's ``nvidia-smi`` line, runs
the phases of ``fantasy_world_tpu_torch/chipcheck/registry.py:PHASES`` in
their order (``registry.run``), each phase's wall seconds on a
``[phase_done]`` line as it ends and all of them on one ``[phase_seconds]``
line after the last, then assembles the kernels line and prints the device
line. The phases' code lives in ``fantasy_world_tpu_torch/chipcheck/``:
``common.py`` (tolerances, shapes, yardsticks, ``rel_l2``), ``inputs.py``
(seeded configurations, models and inputs), ``launches.py`` (every exact
launch count), ``kernels.py``, ``small.py``, ``pipe.py``, ``mesh.py``,
``serving.py`` and ``full.py`` (the phases), ``jobs.py`` (the mesh ranks'
spawns) and ``profile.py`` (``--profile``'s breakdowns).

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
    step in bf16, then quantized to int8 in place and the step twice:
    seconds, peak and resident GB, the drift against bf16, the ``qlinear``
    calls of the second int8 step (under ``--profile`` also the device time
    of the quantization glue).
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
every rank maps (CUDA IPC). ``meshes_start``, right after the kernel
cells, spawns one world of ranks per size (1, 2, 4, 8; ``jobs.World``)
and starts every mesh job there, so that they run beside the reduced
phases, in an order the card's memory allows (full_pipe_seq first, then
full_mesh's one-process runs, then full_mesh's jobs); the phases below
wait for them and check:
  * after small_options, ``small_meshes``: each world size (2, 4, 8)
    running its meshes one after another --
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
  * then ``full_mesh``, on the 2 ranks: Ulysses and the ring as
    direct calls at the DiT self, bicross and VGGT global shapes against
    the one-process kernel on the same inputs; the full-width 2-step
    denoise with the heads, cut to 4 + 4 blocks, at 1x1x2 (the DiT's
    megatron splits) and at 1x2x1 with Ulysses, each against the same
    seeded model run once in one process (the 1-rank world), within
    SLICE_TOL, exact launches; seconds per step and peak GB per rank --
    one card's, not multi-GPU times; ``full_mesh_train``, two jobs: two
    LoRA rank-16 steps with per-block recompute at full width, 4 + 4
    blocks, 336x592x81, batch 1, at 1x1x2 and at 1x2x1 with Ulysses,
    against the same seeded model and batches stepped in one process
    (losses and LoRA gradients gathered whole within TRAIN_TOL, exact
    launches, seconds per step and peak GB per rank); and
    ``train_cli_mesh``: ``cli.train``'s entry point on a 1x1x2 mesh
    (``--synthetic --mesh_model 2 --lora_rank 4``), 2 steps saved,
    resumed to 3; then the pipeline trainer's jobs: ``full_pipe``, one
    GPipe step of ``WanDiTConfig()`` cut to 4 blocks over 2 stages
    (M = 2, Bm = 1 at 480x832x81, full fine-tuning) against the same step
    in one process (the loss, every gradient within TRAIN_TOL, exact
    launches, seconds and peak GB per rank), and ``train_cli_pipe``,
    ``cli.train --synthetic --pipe_stages 2`` saved at 2 and resumed to
    3 (small_meshes' 2 ranks run ``small_pipe``, the reduced step
    against the CPU's; its 4 ranks ``small_pipe_seq``, the same step
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

runs the build and the named phases, any of the registry's, each with the
phases that give what it needs (``registry.plan``: small_meshes takes
small_slice's CPU run, full_serve the full clip's pipeline, a reduced
clip its check), and prints neither the kernels line nor the device
line.

    python3 chip_smoke.py --profile DIR

also runs the 3-step denoise again with its second step and its last step
(the one with the heads) under ``torch.profiler`` (started and stopped
from the pipeline's progress callback), a third full-width training step
under it, the Wan2.2 clip again with its two steps under it (the high
expert's, and the low one's with the heads) and full_quant's second int8
step under it, and writes for each its
device-time breakdown by kernel family and by attention kernel, its idle
share against the same unprofiled step and a gzipped Chrome trace into DIR
(``denoise_step_breakdown.json``, ``denoise_heads_step_breakdown.json``,
``train_step_breakdown.json``, ``wan22_denoise_step_breakdown.json``,
``wan22_denoise_heads_step_breakdown.json``,
``wan22_int8_step_breakdown.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def kernels_line(state):
    """The kernels JSON line's rows from a whole run's state: each
    kernel's launches on every path of the run, its numbers at its
    headline shape and by shape."""
    from fantasy_world_tpu_torch.chipcheck.common import (BWD_SOURCE, JAX_FA,
                                                          REPLACES, SOURCES,
                                                          add_counts)
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    per_kernel, per_step = state["per_kernel"], state["per_step"]
    denoise, windowed, clip_run = (state["denoise"], state["windowed"],
                                   state["clip_run"])
    serve, train, data_train = (state["serve"], state["train"],
                                state["data_train"])
    wan22, quant, ti2v = state["wan22"], state["quant"], state["ti2v"]
    verify, track, options = (state["verify"], state["track"],
                              state["options"])
    mesh = add_counts(state["mesh_small"], state["mesh_full"])
    mesh_serving = add_counts(state["mesh_serving_small"],
                              state["mesh_serving_full"],
                              state["both_resident"])
    mesh_train = add_counts(state["mesh_train_small"],
                            state["mesh_train_full"])
    # pipe_train: every pipeline launch; pipe_seq: those with seq ranks
    pipe_seq = state["pipe_seq"]
    pipe_train = add_counts(state["pipe_train_small"],
                            state["pipe_train_full"], pipe_seq)
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
    return kernels


def main(argv=None) -> int:
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    try:
        from fantasy_world_tpu_torch.chipcheck import registry
        from fantasy_world_tpu_torch.chipcheck.common import say
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="profile the second and the last step of one more "
                        "full-depth denoise, a third full-width training "
                        "step, both steps of one more Wan2.2 clip and the "
                        "second int8 step of full_quant into DIR")
    p.add_argument("--phases", default=None,
                   help="run only these phases (comma-separated, any of: "
                        f"{', '.join(registry.BY_NAME)}) after the build, "
                        "each with the phases that give what it needs, and "
                        "print no kernels line and no device line: a "
                        "partial check")
    args = p.parse_args(argv)
    names = None
    if args.phases is not None:
        names = ["build"] + args.phases.split(",")
        try:
            registry.plan(names)
        except KeyError as e:
            p.error(str(e))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # fails here, before any output, when the port is not whole
    import fantasy_world_tpu_torch.pipelines.wan_video  # noqa: F401
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
    state, seconds = registry.run(device, names, args.profile,
                                  keep=("per_kernel",))
    say("phase_seconds", **{name: f"{s:.1f}" for name, s in seconds.items()})
    if names is not None:
        say("done", seconds=f"{time.perf_counter() - t_start:.1f}",
            phases=args.phases)
        return 0
    kernels = kernels_line(state)
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
