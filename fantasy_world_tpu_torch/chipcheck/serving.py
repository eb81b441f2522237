"""The serving options on a mesh: the reduced cases (int8, fp8, TeaCache,
the windows, the Wan2.2 dual denoise, the HTTP server) against the CPU's
one-process run, the serve CLI's mesh at full width cut in depth, and two
Wan2.2 experts resident in one process.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import time

import numpy as np

from .common import (FULL_SERVING_DIR, SERVE_CLIPS, SERVING_DIR, SLICE_TOL,
                     add_counts, nonzero, rel_l2, say)
from .inputs import (EXAMPLE_IMAGE, FULL_SERVING_CAMERAS, NEG_PROMPT, PROMPT,
                     SERVE_PROMPTS, SMALL_QUANT_MIN_DIM,
                     SMALL_SERVING_GEOMETRY, SMALL_WINDOW,
                     SMALL_WINDOW_GEOMETRY, check_outputs, clip_inputs,
                     conditioning, Cut, cut_after_first, expected_shapes,
                     full_encoders, full_serving_configs, mesh_fusion_config,
                     small_clip_configs, small_configs, small_wan22_configs,
                     tea_threshold, wake_zero_inits, write_tokenizer)
from .launches import (MESH_MODES, encoder_launches, expected_launches,
                       mesh_launches, moge_tokens, serving_launches)
from .jobs import mesh_path, mesh_run, mesh_tag, rank_record, rank_setup


SMALL_SERVING_CASES = {
    (1, 1, 2): (False, ("int8", "fp8", "wan22", "server")),
    (2, 1, 2): (False, ("int8", "fp8")),
    (1, 2, 1): (True, ("tea", "window")),
}


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
                denoise(segment_size=2, progress_callback=cut_after_first,
                        **tea)
                raise AssertionError("the cut mesh run was not cut")
            except Cut:
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


def small_serving_rank(rank, shape, ulysses, cases):
    import torch
    from fantasy_world_tpu_torch.parallel import sharding
    dev = rank_setup()
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
    rank_record(rank, **record)


def small_serving_write():
    """small_mesh_serving's inputs and TeaCache threshold (and its plan)
    written to SERVING_DIR for the ranks, with the tokenizer and the
    cameras of the server case."""
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
    inputs["thresh"], inputs["plan"] = tea_threshold(cpu_f.dit, 4)
    del cpu_f
    torch.save(inputs, os.path.join(SERVING_DIR, "inputs.pt"))
    write_tokenizer(small_clip_configs()[2].vocab,
                    os.path.join(SERVING_DIR, "tok"))
    make_camera_json.main(["--out", os.path.join(SERVING_DIR, "cams.json"),
                           "--motion", "orbit_left", "--frames",
                           str(SMALL_SERVING_GEOMETRY[2])])


def small_serving_cpu():
    """Each small_mesh_serving case's one-process CPU run (f32, the
    kernels' plain versions) on ``small_serving_write``'s inputs, and the
    TeaCache plan's check: {case: outputs}."""
    import torch
    inputs = torch.load(os.path.join(SERVING_DIR, "inputs.pt"),
                        weights_only=False)
    thresh, plan = inputs["thresh"], inputs["plan"]
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
        errs = rel_l2({k: got[case][k] for k in ref if k != "written"},
                      ref)
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
            rank0_launches=nonzero(records[0][case]["launches"]),
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
            total = add_counts(total, r[case]["launches"])
    return total


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


def full_serving_rank(rank, seed):
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
    dev = rank_setup()
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
    rank_record(rank, **record)


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


def phase_wan22_both_resident(device, seed=1024, steps=2):
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
    import shutil
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
        launches=nonzero(launches))
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
    shutil.rmtree(FULL_SERVING_DIR, ignore_errors=True)
    return launches


def phase_full_mesh_serving(device, seed=1024):
    """The serve CLI's mesh at full width on 2 ranks sharing this card
    (1x1x2), cut to ``MESH_SERVING_DEPTH`` (``full_serving_rank``): the
    Wan2.1 server (``FusionConfig()`` at 336x592x81, int8) with a batch of
    2 jobs and a TeaCache job over HTTP, then the Wan2.2 server
    (480x832x81, 2 steps, one per expert: two ranks' parts of both experts
    do not fit one card beside the reserve, ``both_fit``, so the low one
    waits in pinned host memory and swaps in). Prints s per step, seconds
    and peak GB per rank for each generate call, rank 0 with the encoders,
    and the launches, which must be exact; the exported
    clips of their shapes, finite, their MP4 and PLY written. Returns the
    launches, both ranks summed."""
    import shutil
    from fantasy_world_tpu_torch.models.moge.model import MoGeConfig
    from fantasy_world_tpu_torch.models.wan.clip import CLIPVisionConfig
    from fantasy_world_tpu_torch.models.wan.t5 import T5Config
    from fantasy_world_tpu_torch.sampler import read_image
    t0 = time.perf_counter()
    shutil.rmtree(FULL_SERVING_DIR, ignore_errors=True)
    write_tokenizer(T5Config().vocab, os.path.join(FULL_SERVING_DIR, "tok"))
    records = mesh_run(full_serving_rank, 2, seed)
    shape, modes = (1, 1, 2), MESH_MODES["full", (1, 1, 2), False]
    cfg, _, wcfg, (h, w, n), (wh, ww, wn) = full_serving_configs()
    fhw = ((n - 1) // 4 + 1, h // 16, w // 16)
    wfhw = ((wn - 1) // 4 + 1, wh // 16, ww // 16)
    mcfg = MoGeConfig()
    # MoGe sees the image as it is on disk
    moge = (mcfg, moge_tokens(mcfg, read_image(EXAMPLE_IMAGE).shape[:2]))
    per_clip = encoder_launches(CLIPVisionConfig(), moge)
    want = {"serve": lambda r: add_counts(
                mesh_launches(cfg, fhw, shape, modes, 2, r, 512),
                *([per_clip] * SERVE_CLIPS if r == 0 else [])),
            "tea": lambda r: add_counts(
                mesh_launches(cfg, fhw, shape, modes, 3, r, 512, skipped=1),
                *([per_clip] if r == 0 else [])),
            "wan22": lambda r: add_counts(
                mesh_launches(wcfg, wfhw, shape, modes, 2, r, 512),
                *([encoder_launches(moge=moge)] if r == 0 else []))}
    total = {}
    for i, (run, expect) in enumerate(want.items()):
        got = [r["runs"][i] for r in records]
        say("full_mesh_serving", run=run, mesh="1x1x2", ranks=2,
            blocks=f"{cfg.start_index}+{cfg.num_irg}",
            rank_seconds="|".join(f"{x['seconds']:.3f}" for x in got),
            rank_step_seconds="|".join(
                "/".join(f"{s:.3f}" for s in x["steps"]) for x in got),
            rank_peak_gb="|".join(f"{x['peak_gb']:.2f}" for x in got),
            rank0_launches=nonzero(got[0]["launches"]))
        bad = [r for r in range(2) if got[r]["launches"] != expect(r)]
        if bad:
            raise AssertionError(
                f"full_mesh_serving {run}: ranks {bad} launched "
                f"{[got[r]['launches'] for r in bad]}, want "
                f"{[expect(r) for r in bad]}")
        for x in got:
            total = add_counts(total, x["launches"])
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
    shutil.rmtree(FULL_SERVING_DIR, ignore_errors=True)
    return total
