"""The full-width phases on one card: the Wan2.1 fusion denoise, the clip
around it with its encoders, the served batch, the LoRA and data training
steps, the windowed step, the single-card options, the Wan2.2 clip with its
int8 step, TI2V-5B, the weights tools on the resident model and the track
head.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import time

import numpy as np

from .common import (REPO, SERVE_CLIPS, SHAPES, TRACK_POINTS, add_counts,
                     nonzero, rel_l2, say)
from .inputs import (EXAMPLE_IMAGE, NEG_PROMPT, POSE_METHODS, PROMPT,
                     check_detected, check_outputs, clip_inputs, conditioning,
                     expected_shapes, full_encoders, install_tokenizer,
                     pose_encodings, run_ti2v, saved_as, tea_threshold,
                     track_inputs, wake_pose_adapter, wake_zero_inits,
                     write_pan_clip)
from .launches import (encoder_launches, expected_launches,
                       expected_train_launches, expected_window_launches,
                       joint_launches, layers_per_step, moge_tokens,
                       no_launches, pose_dit_launches, temporal_launches,
                       ti2v_launches, track_launches)
from .profile import ProfiledStep


import contextlib


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


def phase_full_wan22(device, t5, vae, steps=2, seed=1024, profile_dir=None):
    """The Wan2.2-Fun-A14B-Control-Camera clip at full width and depth:
    two experts of ``wan22_fusion_config()`` and MoGe-2 built from a seed,
    the low expert moved to pinned host memory, umT5 and the VAE of the
    Wan2.1 clip (``t5``, ``vae``) shared; ``Wan22Sampler.generate_video``
    at 480x832, 81
    frames, ``steps`` steps (2: t = 1000 on the high expert, t ~ 833 on
    the low one, swapped in, with the heads), tiled VAE encode and decode,
    and ``export``. Prints each stage's seconds and peak GB, the launches,
    the output shapes and that every output is finite. With
    ``profile_dir``, the clip runs again with its two steps under the
    profiler, started and stopped from the sampler's callbacks. Then
    ``full_quant`` on the expert left on the card (under the profiler too
    with ``profile_dir``). Returns the clip's launches and full_quant's."""
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
    pipe = FantasyWorldPipeline(t5=t5, vae=vae)
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
    quant = full_quant(device, den, profile_dir=profile_dir)
    del den, high, low, moge, pipe, video, pred
    gc.collect()
    torch.cuda.empty_cache()
    return launches, quant


def phase_full_serve(device, cpipe, moge, seed=1024,
                     geometry=(336, 592, 81)):
    """An in-process ``GenerationServer`` on 127.0.0.1:0 over the full-width,
    full-depth Wan2.1 sampler of the clip (umT5-XXL, CLIP ViT-H, the VAE,
    MoGe-2), with the serve CLI's batch function in segments of one step:
    two same-key jobs (2 steps) batched as B = 2, then one TeaCache job (4
    steps, a plan that skips), posted over HTTP and polled to ``done``.
    Prints each batch's seconds, peak GB and launches, the plan, the
    progress seen; checks the exported outputs' shapes, that they are
    finite, and the exact launches. Returns the launches, the batches'
    numbers, and umT5 and the VAE, which the Wan2.2 clip shares (CLIP and
    MoGe go once full_data_train is done with the clip's pipeline)."""
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
    want = add_counts(
        expected_launches(cfg, steps, clip=clip_cfg, moge=moge),
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
    return launches, batches, cpipe.t5, cpipe.vae


@contextlib.contextmanager
def counted_qlinear():
    """While open, each ``qlinear`` call of ``core.params.linear`` (a
    quantized layer's forward) adds one to the yielded {"n": count}."""
    from fantasy_world_tpu_torch.core import params
    calls, inner = {"n": 0}, params.qlinear

    def counted(*args, **kwargs):
        calls["n"] += 1
        return inner(*args, **kwargs)
    params.qlinear = counted
    try:
        yield calls
    finally:
        params.qlinear = inner


def full_quant(device, den, geometry=(480, 832, 81), profile_dir=None):
    """The Wan2.2 expert resident after full_wan22's clip (``den``),
    one mid denoise step (t = 833, the CFG pair at 480x832, 81 frames, no
    heads) in bf16, then quantized to int8 in place and the same step
    twice: seconds, peak GB, the resident GB before and after, whether two
    int8 experts would fit the card together, the int8 step's relative L2
    drift against bf16, and the ``qlinear`` calls of the second int8 step
    (``counted_qlinear``), which must be some. With ``profile_dir``, that
    step runs under the profiler: the device time of the activation quant,
    the int32 products and the rescale."""
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
    drift = rel_l2(got, ref)
    prof = (ProfiledStep("wan22_int8_step", int8_s, profile_dir)
            if profile_dir else None)
    with counted_qlinear() as calls:
        if prof:
            prof.begin()
        _, int8_s2, _ = step()
        if prof:
            prof.end()
    launches = dict(fa.LAUNCHES)
    total = torch.cuda.get_device_properties(device).total_memory / 1e9
    both = resident_after + expert_after + (int8_peak - resident_after)
    profiled = {}
    if prof:
        report = prof.report()
        glue = sum(report["ranges"].get(k, 0.0) for k in
                   ("qlinear_act_quant", "qlinear_rescale"))
        profiled = dict(
            qlinear_device_s=json.dumps({k: round(v, 3) for k, v in
                                         report["ranges"].items()}
                                        ).replace(" ", ""),
            quant_glue_share=f"{glue / report['device_busy_s']:.4f}")
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
        drift_rel_l2=f"{drift:.4e}", qlinear_calls=calls["n"], **profiled,
        launches=json.dumps({k: v for k, v in launches.items() if v}
                            ).replace(" ", ""))
    # three steps without the heads
    want = expected_launches(cfg, 3)
    want["onekv"] -= 4 * cfg.vggt.camera_head.trunk_depth
    if n == 0 or not math.isfinite(drift) or not torch.isfinite(got).all():
        raise AssertionError(f"int8 step: {n} layers, drift {drift}")
    if not calls["n"]:
        raise AssertionError("the int8 step ran no qlinear")
    if prof and not report["ranges"]:
        raise AssertionError("the profiler saw no qlinear range")
    if launches != want:
        raise AssertionError(f"quant step launches {launches} != {want}")
    return launches


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
        launches=nonzero(run["launches"]))
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
    want_build = add_counts(
        {k: 0 for k in fa.LAUNCHES},
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
        build_launches=nonzero(run["build_launches"]),
        launches=nonzero(run["launches"]))
    if shapes != want_shapes:
        raise AssertionError(f"batch shapes {shapes} != {want_shapes}")
    if not finite:
        raise AssertionError("the clip's batch is not finite")
    check_lora_run(run, expected_train_launches(cfg, steps), want_build)
    # the model leaves as it came: without adapters, whose factors and
    # gradients full_train would otherwise hold through its own steps
    launches = add_counts(run["build_launches"], run["launches"])
    del run, batch, batches
    for _, layer in target_layers(fusion):
        layer._modules.pop("lora", None)
    return launches


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
    moved = {name: rel_l2([outs[name][0]], [outs["plain"][0]])
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
