"""The mesh phases: the reduced slice's denoise, the mesh trainer and the
pipeline trainer on meshes of 2, 4 and 8 ranks sharing this card
(``small_meshes``), and at full width cut in depth, with Ulysses and the
ring as direct calls (``full_mesh``), each against one process.
"""
from __future__ import annotations

import gc
import json
import math
import os
import time

import numpy as np

from .common import (FULL_PIPE_REF, FULL_PIPE_SEQ_REF, OUT_RTOL, SERVING_DIR,
                     SLICE_TOL, TRAIN_CLI_MESH_DIR, TRAIN_CLI_PIPE_DIR,
                     TRAIN_TOL, add_counts, max_err, nonzero, out_tol, rel_l2,
                     say, time_ms, to_device)
from .inputs import (MESH_DEPTH, MESH_GEOMETRY, MESH_STEPS, PIPE_STAGES,
                     SMALL_GEOMETRY, SMALL_SEED, SMALL_STEPS, check_outputs,
                     conditioning, mesh_fusion_config, small_configs,
                     small_slice_setup, stack_batches, train_batches,
                     wake_zero_inits)
from .launches import MESH_MODES, mesh_launches, mesh_train_launches
from .jobs import (close_worlds, gloo_cuda_probe, mesh_path, mesh_tag,
                   rank_record, rank_setup, world)
from .small import cpu_side
from .pipe import (FULL_PIPE_SEQ_DEPTH, PIPE_SEQ, SMALL_PIPE_SEQ_RUNS,
                   check_full_pipe, check_small_pipe, check_train_cli_pipe,
                   full_pipe_rank, full_pipe_reference, small_pipe_rank,
                   small_pipe_tag, train_cli_pipe_rank)
from .serving import (SMALL_SERVING_CASES, check_small_serving,
                      small_serving_cpu, small_serving_rank,
                      small_serving_write)


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


def small_mesh_rank(rank, shape, ulysses, probe):
    import torch
    from fantasy_world_tpu_torch.parallel import sharding
    dev = rank_setup()
    record = {"gloo_cuda": gloo_cuda_probe() if probe else None}
    got, launches, seconds = small_mesh_denoise(
        dev, sharding.make_mesh(*shape), ulysses)
    record.update(launches=launches, seconds=seconds)
    if rank == 0:
        torch.save(got, mesh_path("outputs.pt"))
    rank_record(rank, **record)


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
    errs = rel_l2({k: got[k] for k in cpu_outs}, cpu_outs)
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
        rank0_launches=nonzero(records[0]["launches"]))
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
        total = add_counts(total, r["launches"])
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
                            "max_abs_err": max_err(whole, ref),
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
    return max_err(got, ref), OUT_RTOL * ref.float().abs().max().item()


def mesh_attention_rank(rank, reps):
    import torch.distributed as dist
    from fantasy_world_tpu_torch.parallel import sharding
    dev = rank_setup()
    axis = sharding.Axis(dist.group.WORLD, dist.get_world_size(), rank)
    err, bound = mesh_norm_check(dev, axis)
    rank_record(rank, calls=mesh_attention_calls(dev, axis, reps),
                norm={"max_abs_err": err, "err_bound": bound})


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


def full_mesh_rank(rank, shape, ulysses, depth, seed):
    import torch
    from fantasy_world_tpu_torch.parallel import sharding
    dev = rank_setup()
    cfg = mesh_fusion_config(depth)
    mesh = sharding.make_mesh(*shape)
    lat, pred, steps, peak, launches = mesh_denoise(dev, cfg, seed, mesh,
                                                    ulysses)
    if rank == 0:
        got = check_outputs(cfg, lat, pred, *MESH_GEOMETRY)
        torch.save({k: v.float().cpu() for k, v in got.items()},
                   mesh_path("outputs.pt"))
    rank_record(rank, steps=steps, peak_gb=peak, launches=launches)


# full_mesh's denoises: (mesh shape, Ulysses)
FULL_MESH_RUNS = (((1, 1, 2), False), ((1, 2, 1), True))


def full_mesh_refs_rank(rank, seed):
    """full_mesh's one-process runs, on the one rank of a world of its own
    (``phase_meshes_start``): the denoise at ``MESH_DEPTH`` (its checked
    outputs and the LoRA steps' gradients saved under the job's tag), the
    LoRA steps and the pipeline step (``full_pipe_reference``, its
    gradients at FULL_PIPE_REF); their seconds and peaks recorded."""
    import torch
    dev = rank_setup()
    cfg = mesh_fusion_config(MESH_DEPTH)
    lat, pred, steps, peak, _ = mesh_denoise(dev, cfg, seed)
    outputs = {k: v.float().cpu() for k, v in check_outputs(
        cfg, lat, pred, *MESH_GEOMETRY).items()}
    del lat, pred
    gc.collect()
    torch.cuda.empty_cache()
    losses, grads, seconds, train_peak, _ = mesh_lora_steps(dev, cfg, seed)
    torch.save({"outputs": outputs,
                "grads": [{k: v.cpu() for k, v in g.items()}
                          for g in grads]}, mesh_path("refs.pt"))
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    rank_record(rank, steps=steps, peak_gb=peak,
                train={"losses": losses, "seconds": seconds,
                       "peak": train_peak},
                pipe=full_pipe_reference(dev, seed))


def full_mesh_jobs(seed):
    """full_mesh's jobs on its 2 ranks, in order."""
    return ([("attention_", mesh_attention_rank, (3,))]
            + [(mesh_tag(shape), full_mesh_rank,
                (shape, uly, MESH_DEPTH, seed))
               for shape, uly in FULL_MESH_RUNS]
            + [("full_train" + mesh_tag(shape), full_mesh_train_rank,
                (shape, uly, MESH_DEPTH, seed))
               for shape, uly in FULL_MESH_RUNS]
            + [("train_cli_", train_cli_rank, ()),
               ("pipe_full_", full_pipe_rank, (seed,)),
               ("train_cli_pipe_", train_cli_pipe_rank, ())])


def phase_full_mesh(device, meshes, seed=1024):
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
    --pipe_stages 2`` saved and resumed (``train_cli_pipe``). The one
    process's runs are a job of a 1-rank world, the rest jobs of the
    2-rank world, all started by ``phase_meshes_start`` (``meshes``); this
    phase waits for them and checks. Returns (the denoise runs' launches,
    the mesh training runs', the pipeline's), all ranks summed."""
    import shutil

    import torch
    t0 = time.perf_counter()
    height, width, frames = MESH_GEOMETRY
    fhw = ((frames - 1) // 4 + 1, height // 16, width // 16)
    cfg = mesh_fusion_config(MESH_DEPTH)
    refs_records, refs_s = meshes["full_refs"].result()
    records, mesh_s = meshes["full"].result()
    close_worlds(1)
    one = refs_records["refs_"][0]
    refs = torch.load(mesh_path("refs.pt", "refs_"))
    ref, ref_steps, ref_peak = refs["outputs"], one["steps"], one["peak_gb"]
    train_ref = dict(one["train"], grads=refs["grads"])
    pipe_ref = one["pipe"]
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
        errs = rel_l2({k: got[k] for k in ref}, ref)
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
            rank0_launches=nonzero(runs[0]["launches"]))
        bad = {k: v for k, v in errs.items() if not v <= SLICE_TOL}
        if bad:
            raise AssertionError(f"full_mesh {shape}: beyond {SLICE_TOL} of "
                                 f"the one-process run: {bad}")
        if launch_err:
            raise AssertionError(
                f"full_mesh {shape}: ranks {launch_err} launched "
                f"{[runs[r]['launches'] for r in launch_err]}")
        for r in runs:
            total = add_counts(total, r["launches"])
    train = add_counts(check_full_mesh_train(cfg, train_ref, records),
                       check_train_cli_mesh(records["train_cli_"]))
    pipe = add_counts(check_full_pipe(pipe_ref, records["pipe_full_"]),
                      check_train_cli_pipe(records["train_cli_pipe_"]))
    shutil.rmtree(TRAIN_CLI_MESH_DIR, ignore_errors=True)
    shutil.rmtree(TRAIN_CLI_PIPE_DIR, ignore_errors=True)
    os.remove(FULL_PIPE_REF)
    say("full_mesh_phase", seconds=f"{time.perf_counter() - t0:.2f}",
        one_process_seconds=f"{refs_s:.2f}", mesh_seconds=f"{mesh_s:.2f}")
    return total, train, pipe


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
            loss = train_on(model, trainable, to_device(setup[3][B], dev))
            grads, params = whole_trainable(model, trainable)
            out[f"{mode}{B}"] = {"loss": loss, "grads": grads,
                                 "params": params}
    return out


def small_mesh_train_rank(rank, shape, ulysses, modes):
    """small_mesh_train on this rank: one step of each mode, its loss,
    seconds and launches; rank 0 saves the gradients and the updated
    values, gathered whole."""
    import torch
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.parallel import sharding
    dev = rank_setup()
    mesh = sharding.make_mesh(*shape)
    setup = small_train_setup()
    batch = to_device(setup[3][2 if shape[0] > 1 else 1], dev)
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
    rank_record(rank, **record)


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
                  "grads": rel_l2([got["grads"][n] for n in names],
                                  [ref["grads"][n] for n in names]),
                  "params": rel_l2([got["params"][n] for n in names],
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
            rank0_launches=nonzero(records[0][mode]["launches"]))
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
            total = add_counts(total, r[mode]["launches"])
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
    batches = [to_device(b, device) for b in train_batches(
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


def full_mesh_train_rank(rank, shape, ulysses, depth, seed):
    import torch
    from fantasy_world_tpu_torch.parallel import sharding
    dev = rank_setup()
    losses, grads, seconds, peak, launches = mesh_lora_steps(
        dev, mesh_fusion_config(depth), seed, sharding.make_mesh(*shape),
        ulysses)
    if rank == 0:
        torch.save(grads, mesh_path("train_grads.pt"))
    rank_record(rank, losses=losses, steps=seconds, peak_gb=peak,
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
        runs = records["full_train" + mesh_tag(shape)]
        grads = torch.load(mesh_path("train_grads.pt",
                                     "full_train" + mesh_tag(shape)))
        names = sorted(ref["grads"][0])
        errs = {}
        for i in range(FULL_TRAIN_STEPS):
            errs[f"loss{i}"] = (abs(runs[0]["losses"][i] - ref["losses"][i])
                                / abs(ref["losses"][i]))
            errs[f"lora_grads{i}"] = rel_l2(
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
            rank0_launches=nonzero(runs[0]["launches"]))
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
            total = add_counts(total, r["launches"])
    return total


# the trainer CLI on a 1x1x2 mesh: the demo at dim 256 (2 DiT heads, so
# the model splits), LoRA rank 4
MESH_TRAIN_CLI_ARGS = ["--synthetic", "--mesh_model", "2", "--lora_rank",
                       "4", "--demo_dim", "256", "--warmup", "1", "--lr",
                       "1e-3", "--log_every", "1", "--device", "cuda"]


def train_cli_rank(rank):
    """``cli.train``'s ``run`` on this rank of a 1x1x2 mesh (the process
    group open already, as ``distributed.spawn`` leaves it): 2 steps saved
    into TRAIN_CLI_MESH_DIR, then resumed to step 3; each run's final loss
    and launches."""
    from fantasy_world_tpu_torch.cli.train import main as train_main
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    rank_setup()
    ckpt = TRAIN_CLI_MESH_DIR
    runs = []
    for steps in (2, 3):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss = train_main(MESH_TRAIN_CLI_ARGS + [
            "--steps", str(steps), "--checkpoint_dir", ckpt])
        runs.append({"loss": loss, "seconds": time.perf_counter() - t0,
                     "launches": dict(fa.LAUNCHES)})
    rank_record(rank, runs=runs,
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
        rank0_launches="|".join(nonzero(run["launches"])
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
            total = add_counts(total, r["runs"][i]["launches"])
    if saved != ["step_00000002", "step_00000003"]:
        raise AssertionError(f"train CLI on a mesh: checkpoints {saved}")
    return total


def small_mesh_jobs(seed):
    """small_meshes' jobs by world size, each in order; full_pipe_seq, the
    one of full width, apart (``phase_meshes_start`` runs it first)."""
    jobs = {}
    for shape, uly in SMALL_MESH_RUNS:
        jobs.setdefault(int(np.prod(shape)), []).append(
            ("mesh" + mesh_tag(shape), small_mesh_rank,
             (shape, uly, shape == (1, 2, 1))))
    for shape, uly, modes in SMALL_MESH_TRAIN_RUNS:
        jobs.setdefault(int(np.prod(shape)), []).append(
            ("train" + mesh_tag(shape), small_mesh_train_rank,
             (shape, uly, modes)))
    jobs[PIPE_STAGES].append(("pipe_small_", small_pipe_rank, ()))
    for uly in SMALL_PIPE_SEQ_RUNS:
        jobs[PIPE_STAGES * PIPE_SEQ].append((small_pipe_tag(PIPE_SEQ, uly),
                                             small_pipe_rank, (PIPE_SEQ, uly)))
    # the 2-rank server case last: it stops the ranks' serving loop
    for shape, (uly, cases) in sorted(SMALL_SERVING_CASES.items(),
                                      key=lambda kv: "server" in kv[1][1]):
        jobs.setdefault(int(np.prod(shape)), []).append(
            ("serving" + mesh_tag(shape), small_serving_rank,
             (shape, uly, cases)))
    seq_full = ("pipe_seq_full_", full_pipe_rank,
                (seed, FULL_PIPE_SEQ_DEPTH, PIPE_SEQ, True, FULL_PIPE_SEQ_REF))
    return jobs, seq_full


def phase_meshes_start(device, plan, seed=1024):
    """Starts the mesh phases' ranks and jobs in the background, so that
    they run beside the reduced single-card phases (the ranks are
    host-bound and leave most of the card and some cores free), for
    ``phase_small_meshes`` and ``phase_full_mesh`` to wait for and check
    (those of ``plan``, the run's phases). The card's memory bounds what
    runs together: full_pipe_seq's one-process step first, here; then
    full_pipe_seq itself (4 ranks, ~56 GB) beside the reduced jobs of the
    2-, 4- and 8-rank worlds; once it has ended, full_mesh's one-process
    runs (``full_mesh_refs_rank``, ~29 GB) on a rank of their own; once
    those have ended, full_mesh's jobs on the 2 ranks (up to ~50 GB), after
    their reduced jobs. Returns the pending runs' futures ({name: future
    of (records, seconds)}) and full_pipe_seq's one-process step."""
    import shutil
    small, full = "small_meshes" in plan, "full_mesh" in plan
    for size in sorted(({1, 2} if full else set())
                       | ({2, 4, 8} if small else set())):
        world(size)
    meshes = {}
    seq_full = None
    if small:
        meshes["pipe_seq_ref"] = full_pipe_reference(
            device, seed, FULL_PIPE_SEQ_DEPTH, FULL_PIPE_SEQ_REF)
        small_serving_write()
        jobs, seq_job = small_mesh_jobs(seed)
        seq_full = meshes["pipe_seq_full"] = world(4).submit([seq_job])
        for size, size_jobs in sorted(jobs.items()):
            meshes[f"small{size}"] = (size_jobs,
                                      world(size).submit(size_jobs))
    if full:
        shutil.rmtree(TRAIN_CLI_MESH_DIR, ignore_errors=True)
        shutil.rmtree(TRAIN_CLI_PIPE_DIR, ignore_errors=True)
        meshes["full_refs"] = world(1).submit(
            [("refs_", full_mesh_refs_rank, (seed,))], after=seq_full)
        meshes["full"] = world(2).submit(full_mesh_jobs(seed),
                                         after=meshes["full_refs"])
    return meshes


def phase_small_meshes(device, cpu_outs, meshes):
    """small_mesh and small_mesh_serving at reduced widths, on meshes of
    ranks sharing this card, one world of ranks per size running each
    mesh of that size as a job, the worlds at once (``phase_meshes_start``
    started them; ``meshes``); this phase waits for them and checks.

    small_mesh: the reduced slice's denoise (``SMALL_MESH_RUNS``) against
    the CPU's one-process run (``cpu_outs``, small_slice's).

    small_mesh_serving: the serving options, each against the CPU's
    one-process run of the same case (f32, the kernels' plain versions)
    within SLICE_TOL, with exact launches on every rank: int8 and fp8
    (quantized whole, then split) at 1x1x2 and 2x1x2; TeaCache at 1x2x1
    with Ulysses, the plan skipping a step, cut after a segment and resumed
    from rank 0's partial state; the windowed denoise at 1x2x1 with
    Ulysses on windows split 2 | 1; the Wan2.2 dual-expert denoise at 1x1x2
    across the boundary; the server at 1x1x2 (the last job of its list):
    two jobs over HTTP batched as one B = 2 run on both ranks, the files
    written, the ranks stopped through rank 0's shutdown.

    small_mesh_train: one step of the train step with per-block recompute
    (``SMALL_MESH_TRAIN_RUNS``: LoRA rank 4 and full fine-tuning at 1x1x2,
    LoRA at 1x2x1 with Ulysses, at 1x4x1 with the ring and at 2x2x2 on a
    batch of 2), each against the CPU's one-process f32 step of the same
    seeded model and batch (the background process's) within TRAIN_TOL,
    with exact launches on every rank, the backward's included.

    small_pipe (a job of the 2-rank world): one GPipe step of the reduced
    plain DiT over 2 stages, M = 2, against the CPU's one-process f32 step
    (``check_small_pipe``); small_pipe_seq (jobs of the 4-rank world): the
    same step over 2 stages x 2 seq ranks, the self-attention gathered and
    through Ulysses, against the same CPU step.

    full_pipe_seq (the 4-rank world's first job): one GPipe step of
    ``WanDiTConfig()`` cut to 2 blocks over 2 stages x 2 seq ranks with
    Ulysses (M = 2, Bm = 1 at 480x832x81, full fine-tuning), against the
    same step in this process, run first (``check_full_pipe``).

    Returns (small_mesh's launches, small_mesh_serving's,
    small_mesh_train's, small_pipe's, small_pipe_seq's and
    full_pipe_seq's), all ranks summed."""
    import shutil
    t_phase = time.perf_counter()
    # the serving cases' CPU runs while the ranks may still be at work
    cpu = small_serving_cpu()
    mesh, serving, train, pipe, pipe_seq = {}, {}, {}, {}, {}
    seq_records, seq_s = meshes["pipe_seq_full"].result()
    say("small_mesh_world", ranks=PIPE_STAGES * PIPE_SEQ,
        meshes="pipe_seq_full", seconds=f"{seq_s:.2f}")
    pipe_seq = check_full_pipe(meshes["pipe_seq_ref"],
                               seq_records["pipe_seq_full_"],
                               FULL_PIPE_SEQ_DEPTH, PIPE_SEQ, True)
    os.remove(FULL_PIPE_SEQ_REF)
    train_cpu = None
    for size in (2, 4, 8):
        size_jobs, pending = meshes[f"small{size}"]
        records, seconds = pending.result()
        for tag, fn, args in size_jobs:
            if fn is small_pipe_rank:
                got = check_small_pipe(records[tag], cpu_side("small_pipe"),
                                       *args)
                if args:
                    pipe_seq = add_counts(pipe_seq, got)
                else:
                    pipe = got
                continue
            shape, uly, third = args
            if tag.startswith("mesh"):
                mesh = add_counts(mesh, check_small_mesh(
                    shape, uly, records[tag], cpu_outs))
            elif tag.startswith("train"):
                train_cpu = train_cpu or cpu_side("small_mesh_train")
                train = add_counts(train, check_small_mesh_train(
                    shape, uly, third, records[tag], train_cpu))
            else:
                serving = add_counts(serving, check_small_serving(
                    shape, uly, third, records[tag], cpu))
        say("small_mesh_world", ranks=size,
            meshes="|".join(tag.rstrip("_") for tag, _, _ in size_jobs),
            seconds=f"{seconds:.2f}")
    # the 2 ranks stay for full_mesh's jobs
    close_worlds(4, 8)
    shutil.rmtree(SERVING_DIR, ignore_errors=True)
    say("small_meshes_phase", seconds=f"{time.perf_counter() - t_phase:.2f}")
    return mesh, serving, train, pipe, pipe_seq
