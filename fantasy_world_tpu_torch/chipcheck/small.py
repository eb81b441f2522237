"""The reduced-width phases: each path on the card in bf16 against the same
weights on the CPU in f32 through the kernels' plain versions -- the slice,
the sliding window, the clips (Wan2.1, Wan2.2, TI2V-5B; their CPU sides run
in a process of their own, ``start_cpu_sides``), the serving options, the
training steps, the trainer's and the weights tools' command lines, the
track head and the single-card options.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from .common import (REPO, SCHED_TOL, SLICE_TOL, TRAIN_TOL, add_counts, rel_l2,
                     say, to_device)
from .inputs import (NEG_PROMPT, POSE_METHODS, PROMPT, SMALL_GEOMETRY,
                     SMALL_OPTION_GEOMETRY, SMALL_QUANT_MIN_DIM, SMALL_SEED,
                     SMALL_STEPS, SMALL_TEMPORAL, check_outputs, clip_inputs,
                     conditioning, Cut, cut_after_first, install_tokenizer,
                     pose_encodings, run_ti2v, saved_as, small_clip_configs,
                     small_configs, small_slice_setup, small_ti2v_configs,
                     small_track_configs, small_wan22_configs, tea_threshold,
                     track_inputs, train_batches, wake_pose_adapter,
                     wake_zero_inits, write_pan_clip, write_reference_layout,
                     write_tokenizer, write_wan22_layout)
from .launches import (encoder_launches, expected_launches,
                       expected_train_launches, expected_window_launches,
                       moge_tokens, small_option_launches, ti2v_launches,
                       track_launches)


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
    errs = rel_l2(outs[device], outs["cpu"])
    say("small_slice", device_vs_cpu_rel_l2=json.dumps(
        {k: float(f"{v:.3e}") for k, v in errs.items()}).replace(" ", ""))
    bad = {k: v for k, v in errs.items() if not v <= SLICE_TOL}
    if bad:
        raise AssertionError(f"reduced slice disagrees with the CPU path "
                             f"beyond {SLICE_TOL}: {bad}")
    return outs["cpu"]


# the CPU sides of the reduced clips (f32, the kernels' plain versions):
# host work, run from the start in a process of its own beside the card's
# phases (``start_cpu_sides``), each collected by its phase (``cpu_side``)
# {name: the module of this package whose ``{name}_run`` it is}
CPU_SIDES = {"small_clip": "small", "small_wan22": "small",
             "small_ti2v": "small", "small_mesh_train": "mesh",
             "small_pipe": "pipe"}
_CPU_PENDING = {}


def _cpu_side(name):
    import importlib
    import torch
    t0 = time.perf_counter()
    module = importlib.import_module(f"{__package__}.{CPU_SIDES[name]}")
    out = getattr(module, f"{name}_run")(torch.device("cpu"), torch.float32)
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
    with CLIP's. Runs the card side; returns it and its seconds for
    ``phase_small_clip_check``, which takes the CPU side (after the mesh
    phases)."""
    import torch
    t0 = time.perf_counter()
    card = small_clip_run(device, torch.bfloat16)
    return card, time.perf_counter() - t0


def phase_small_clip_check(card_side):
    """``small_clip``'s card side (``phase_small_clip``) against its CPU
    side (``cpu_side``)."""
    import shutil
    card, card_s = card_side
    t0 = time.perf_counter()
    fcfg, _, _, clipc, _ = small_clip_configs()
    height, width, frames, steps = SMALL_CLIP_RUN
    cpu = cpu_side("small_clip")
    shutil.rmtree(os.path.join(REPO, "build", "clip_export"),
                  ignore_errors=True)
    errs = {k: rel_l2([card["t"][k]], [cpu["t"][k]]) for k in cpu["t"]}
    errs["decode"] = rel_l2([card["decode"]], [cpu["decode"]])
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
    Runs the card side; returns it and its seconds for
    ``phase_small_wan22_check``, which takes the CPU side (after the mesh
    phases)."""
    import torch
    t0 = time.perf_counter()
    card = small_wan22_run(device, torch.bfloat16)
    return card, time.perf_counter() - t0


def phase_small_wan22_check(card_side):
    """``small_wan22``'s card side (``phase_small_wan22``) against its CPU
    side (``cpu_side``)."""
    import shutil
    card, card_s = card_side
    t0 = time.perf_counter()
    fcfg, _, _, mcfg = small_wan22_configs()
    height, width, frames, steps = SMALL_WAN22_RUN
    cpu = cpu_side("small_wan22")
    shutil.rmtree(os.path.join(REPO, "build", "wan22_export"),
                  ignore_errors=True)
    errs = {k: rel_l2([card["t"][k]], [cpu["t"][k]]) for k in cpu["t"]}
    errs["decode"] = rel_l2([card["decode"]], [cpu["decode"]])
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
            losses.append(float(step(to_device(b, dev))))
            grads.append([state[n].grad.float().cpu() for n in names])
        launches = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        del m, state, opt, sched, step
        # one full fine-tuning step from the same weights, no adapters
        full = model_on(dev, dtype, lora=False)
        params = [p for _, p in sorted(full.named_parameters())]
        opt = torch.optim.AdamW(params, lr=1e-4, eps=1e-8)
        full_loss = float(make_train_step(full, opt, remat=True)(
            to_device(batches[0], dev)))
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
    checks.update({f"lora_grads{i}": rel_l2(a, b) for i, (a, b) in
                   enumerate(zip(card["grads"], cpu["grads"]))})
    checks["full_loss"] = (abs(card["full_loss"] - cpu["full_loss"])
                           / abs(cpu["full_loss"]))
    checks["full_grads"] = rel_l2(card["full_grads"], cpu["full_grads"])
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
        want = add_counts(expected_train_launches(fcfg, ran),
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
    errs = rel_l2(outs[device], outs["cpu"])
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
        errs[name] = max(rel_l2([o], [r])
                         for o, r in zip(outs, ref[name][0]))
        if launches != want[name]:
            bad.append(f"{name}: launches {launches} != {want[name]}")
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            bad.append(f"{name}: non-finite")
    sched_ref = scheduler_ladders("cpu")
    sched = scheduler_ladders(device)
    sched_errs = {k: rel_l2([sched[k]], [v])
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


def phase_small_serve(device):
    """The serving options at reduced widths, on the card in bf16 against
    the CPU in f32 from the same weights, each within SLICE_TOL (relative
    L2 of the latents and the prediction): the Wan2.1 denoise with its
    model quantized to int8 and to fp8 (each quantized where it runs), and
    with TeaCache, cut after its first segment and resumed from the partial
    state (the CPU run unsegmented; the card's plan and the CPU's equal);
    the Wan2.2 dual-expert denoise with both experts quantized to int8 on
    the card and the low one then pinned in host memory (``place_expert``,
    in ``load_wan22``'s order), the dual plan, cut at the expert boundary
    and resumed there, the low expert swapped in. Each cut run runs
    segments of two steps and is cut after the first; the resumed run, in
    segments of one, reports its start."""
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
        errs[mode] = rel_l2(denoise(card), denoise(cpu))
        fields[f"{mode}_layers"] = n_card
        del cpu, card
    # TeaCache, segmented, cut after the first segment and resumed
    (cpu, _), (card, _) = pipe_on("cpu"), pipe_on(device)
    thresh, plan_cpu = tea_threshold(cpu.fusion.dit, steps)
    plan_card = tc.compute_skip_schedule(card.fusion.dit, ts, thresh)
    path = os.path.join(work, "wan21_partial.npz")
    try:
        denoise(card, tea_cache_l1_thresh=thresh, segment_size=2,
                gen_ckpt_path=path, progress_callback=cut_after_first)
        raise AssertionError("the cut run was not cut")
    except Cut:
        pass
    calls = []
    got = denoise(card, tea_cache_l1_thresh=thresh, segment_size=1,
                  gen_ckpt_path=path,
                  progress_callback=lambda *a: calls.append(a))
    errs["tea_resumed"] = rel_l2(got, denoise(cpu,
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
                  progress_callback=cut_after_first)
        raise AssertionError("the cut Wan2.2 run was not cut")
    except Cut:
        pass
    got = denoise22(dens["card"], segment_size=1, gen_ckpt_path=path,
                    progress_callback=lambda *a: calls.append(a),
                    stage_callback=stages.append)
    errs["wan22_int8_tea_resumed"] = rel_l2(got, denoise22(dens["cpu"]))
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
    err = rel_l2([outs[str(device)]], [outs["cpu"]])
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
    Runs the card side; returns it and its seconds for
    ``phase_small_ti2v_check``, which takes the CPU side (after the mesh
    phases)."""
    import torch
    t0 = time.perf_counter()
    card = small_ti2v_run(device, torch.bfloat16)
    return card, time.perf_counter() - t0


def phase_small_ti2v_check(card_side):
    """``small_ti2v``'s card side (``phase_small_ti2v``) against its CPU
    side (``cpu_side``)."""
    import shutil
    card, card_s = card_side
    t0 = time.perf_counter()
    dcfg = small_ti2v_configs()[0]
    height, width, frames, steps = SMALL_TI2V_RUN
    cpu = cpu_side("small_ti2v")
    # the CPU's latents through the card's VAE: the VAE alone
    card["decode_same_latents"] = card.pop("decode_here")(cpu["latents"])
    shutil.rmtree(os.path.join(REPO, "build", "small_ti2v"),
                  ignore_errors=True)
    errs = {k: rel_l2([card[k]], [cpu[k]])
            for k in ("first", "latents", "decode")}
    errs["decode_same_latents"] = rel_l2([card["decode_same_latents"]],
                                         [cpu["decode"]])
    errs["decode_random_latents"] = rel_l2(
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
