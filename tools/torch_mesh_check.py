#!/usr/bin/env python3
"""The multi-GPU path over NCCL, one rank per card, against one process.

    torchrun --standalone --nproc_per_node 4 tools/torch_mesh_check.py [--json FILE] [--sections 4,5,6,7]

For a host with four cards (``chip_smoke.py``'s mesh phases run their
ranks on its one card over gloo instead). Every rank, on its own card:

  1. the reduced slice's 2-step denoise (``chip_smoke.small_mesh_denoise``)
     on 4-rank meshes -- (1, 4, 1) with Ulysses (2 heads over 4 ranks: the
     ring), (2, 1, 2), (1, 2, 2) with Ulysses, (4, 1, 1) -- each against
     the one-process run on rank 0's card within SLICE_TOL, with exact
     launches on every rank;
  2. Ulysses and the ring as direct calls at the full width's DiT self,
     bicross and VGGT global shapes (the 21 frames over 4 ranks) against
     the one-process kernel on the same inputs, timed;
  3. the full-width 2-step denoise with the heads at (1, 1, 4), all 40
     blocks, and at (1, 4, 1) with Ulysses, against the same seeded model
     run in one process on rank 0's card: seconds per step, peak GB;
  4. the serving options at reduced widths (``chip_smoke.serving_case``):
     int8 and fp8 at (2, 1, 2), TeaCache (a skipped step, cut after a
     segment and resumed from rank 0's partial state) and the windowed
     denoise at (1, 2, 2) with Ulysses, the Wan2.2 dual denoise at
     (2, 1, 2), each against the one-process run on rank 0's card within
     SLICE_TOL, with exact launches on every rank;
  5. the Wan2.2 dual-expert denoise at full width and depth at (1, 1, 4),
     480x832x81, 2 steps: each rank's parts of both experts on its card
     (``DualModelDenoiser.place``: no swap), against the same seeded
     experts in one process on rank 0's card (the low one pinned on the
     host, one swap);
  6. the mesh trainer at full width and depth: one LoRA rank-16 step with
     per-block recompute (``chip_smoke.mesh_lora_steps``: 336x592x81,
     batch 1) at (1, 1, 4) and at (1, 4, 1) with Ulysses, against the same
     seeded model and batch stepped in one process on rank 0's card: the
     loss and the LoRA gradients gathered whole within TRAIN_TOL, exact
     launches on every rank, seconds and peak GB per rank;
  7. the pipeline trainer at full width (``WanDiTConfig()``), one step
     of ``chip_smoke.pipe_step`` on the same batch of 4 samples at
     480x832x81: at PIPE_REF_DEPTH = 8 blocks as 4 stages of 2 (M = 4)
     against the same step in one process on rank 0's card; then cut to
     PIPE_DEPTH = 24 blocks, whose weights, gradients and AdamW moments
     (~80 GB) one card does not hold, as 4 stages of 6 blocks (M = 4) and
     as 2 stages of 12 blocks x 2 data ranks (M = 2), the second against
     the first; and 'seq' inside a stage: at PIPE_REF_DEPTH as 2 stages
     of 4 blocks x 2 seq ranks (M = 4; the 21 latent frames 11 | 10) with
     Ulysses (20 of the 40 heads a rank), against the same one-process
     step. Each: the loss, every gradient's relative L2 within TRAIN_TOL
     (each block's between the ranks that hold it), lite the same on
     every rank, exact launches, seconds and peak GB per rank.

``--sections`` runs only the numbered checks. Rank 0 prints one line per
check, the cards' names and power limits, and a JSON line last (also
written to ``--json``); a failed check raises.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_MESHES = (((1, 4, 1), True), ((2, 1, 2), False), ((1, 2, 2), True),
                ((4, 1, 1), False))
SERVING_MESHES = (((2, 1, 2), False, ("int8", "fp8", "wan22")),
                  ((1, 2, 2), True, ("tea", "window")))
FULL_MESHES = (((1, 1, 4), False), ((1, 4, 1), True))
# section 7: the pipeline trainer's depth and its two layouts of 4 ranks,
# (stages, data ranks, seq ranks, microbatches), each on a batch of 4
# samples; the depth at which one process on a card steps the same batch,
# held against the first layout and against 2 stages x 2 seq ranks with
# Ulysses
PIPE_DEPTH = 24
PIPE_LAYOUTS = ((4, 1, 1, 4), (2, 2, 1, 2))
PIPE_REF_DEPTH = 8
PIPE_SEQ_LAYOUT = (2, 1, 2, 4)


def rel_l2(got, ref):
    return {k: ((got[k] - r).norm() / r.norm().clamp_min(1e-12)).item()
            for k, r in ref.items()}


def check(name, errs, launches, want, lead, out, tol=None):
    """Rank 0's errors within ``tol`` (SLICE_TOL) and every rank's launches
    exact."""
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    ok = torch.tensor([int(launches == want)], device="cuda")
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    if not lead:
        return
    row = {"check": name, "rel_l2": errs, "launches_exact": bool(ok.item()),
           "rank0_launches": {k: v for k, v in launches.items() if v}}
    out.append(row)
    cs.say("mesh_check", **{k: json.dumps(v).replace(" ", "")
                            if isinstance(v, dict) else v
                            for k, v in row.items()})
    bad = {k: v for k, v in errs.items()
           if not v <= (cs.SLICE_TOL if tol is None else tol)}
    if bad or not ok.item():
        raise AssertionError(f"{name}: {bad or 'launch counts differ'}")


def serving(dev, lead, out):
    """Section 4: every rank makes the same seeded inputs; rank 0 runs
    each case in one process on its card first."""
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.parallel import sharding
    os.makedirs(cs.SERVING_DIR, exist_ok=True)
    inputs = cs.small_serving_inputs()
    cpu_f = FusionModel(cs.small_configs()[0])
    cpu_f.load_state_dict(inputs["sds"]["fusion"])
    inputs["thresh"], _ = cs.tea_threshold(cpu_f.dit, 4)
    del cpu_f
    for shape, uly, cases in SERVING_MESHES:
        mesh = sharding.make_mesh(*shape)
        for case in cases:
            ref = (cs.serving_case(case, inputs, dev)[0] if lead else None)
            dist.barrier()
            got, launches = cs.serving_case(case, inputs, dev, mesh, uly)
            check(f"serving_{case}_{'x'.join(map(str, shape))}"
                  f"{'_ulysses' * uly}",
                  rel_l2(got, ref) if lead else None, launches,
                  cs.serving_launches(case, shape, uly, mesh.rank), lead,
                  out)
            gc.collect()
            torch.cuda.empty_cache()


def wan22_full(dev, lead, world, out, steps=2, seed=1024):
    """Section 5: the two experts of ``wan22_fusion_config()`` from one
    seed, 480x832x81, random conditioning (CPU-seeded, the same on every
    rank)."""
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from fantasy_world_tpu_torch.convert.checkpoint import wan22_fusion_config
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.parallel import sharding
    from fantasy_world_tpu_torch.pipelines.wan_video_22 import (
        DualModelDenoiser)
    cfg = wan22_fusion_config()
    h, w, n = 480, 832, 81
    f = (n - 1) // 4 + 1
    cg = torch.Generator("cpu").manual_seed(seed)
    ctx = [torch.randn((1, 512, cfg.dit.text_dim), generator=cg)
           for _ in range(2)]
    y = torch.randn((1, cfg.dit.in_dim - cfg.dit.out_dim, f, h // 8, w // 8),
                    generator=cg)
    ctrl = torch.randn((1, 24, f, h, w), generator=cg)

    def run(mesh=None):
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        experts = []
        for _ in range(2):
            m = build(lambda: FusionModel(cfg), device=dev,
                      dtype=torch.bfloat16, generator=g, mesh=mesh)
            cs.wake_zero_inits(m, g)
            experts.append(m)
        den = DualModelDenoiser(*experts)
        if mesh is None:
            den.place()
        else:
            den.shard(mesh)
        devices = "|".join(str(den._device_of(m)) for m in experts)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(steps + 1)]
        stages = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        events[0].record()
        lat, pred = den.denoise(
            ctx[0], ctx[1], y, h, w, num_frames=n, num_inference_steps=steps,
            seed=seed, control_camera_latents=ctrl,
            progress_callback=lambda i, _: events[i].record(),
            stage_callback=stages.append,
            **({} if mesh is None else {"mesh": mesh}))
        torch.cuda.synchronize()
        out = None
        if pred is not None:
            out = {k: v.float().cpu() for k, v in cs.check_outputs(
                cfg, lat, pred, h, w, n).items()}
        step_s = [events[i].elapsed_time(events[i + 1]) / 1e3
                  for i in range(steps)]
        return (out, step_s, torch.cuda.max_memory_allocated() / 1e9,
                dict(fa.LAUNCHES), devices, "|".join(stages))

    ref = None
    if lead:
        ref, step_s, peak, _, devices, stages = run()
        cs.say("mesh_check_wan22_one_process", step_seconds="|".join(
            f"{s:.3f}" for s in step_s), peak_gb=f"{peak:.2f}",
            devices=devices, stages=stages)
        out.append({"check": "wan22_one_process", "step_seconds": step_s,
                    "peak_gb": peak, "devices": devices})
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    shape = (1, 1, world)
    mesh = sharding.make_mesh(*shape)
    got, step_s, peak, launches, devices, stages = run(mesh)
    stats = torch.tensor([*step_s, peak], device="cuda")
    rows = [torch.empty_like(stats) for _ in range(world)]
    dist.all_gather(rows, stats)
    if lead:
        cs.say("mesh_check_wan22", mesh="x".join(map(str, shape)),
               devices=devices, stages=stages, rank_step_seconds="|".join(
                   "/".join(f"{s:.3f}" for s in r[:-1].tolist())
                   for r in rows),
               rank_peak_gb="|".join(f"{r[-1].item():.2f}" for r in rows))
    if "swap" in stages or "cpu" in devices:
        raise AssertionError(f"Wan2.2 on {shape}: devices {devices}, "
                             f"stages {stages}")
    fhw = (21, h // 16, w // 16)
    check(f"wan22_full_{'x'.join(map(str, shape))}",
          rel_l2(got, ref) if lead else None, launches,
          cs.mesh_launches(cfg, fhw, shape,
                           cs.MESH_MODES["full", (1, 1, 4), False], steps,
                           mesh.rank, 512), lead, out)
    if lead:
        out[-1].update(rank_step_seconds=[r[:-1].tolist() for r in rows],
                       rank_peak_gb=[r[-1].item() for r in rows])


def mesh_train(dev, lead, world, out, seed=1024):
    """Section 6: rank 0 steps the seeded model once in one process, then
    every rank its part of each mesh of ``FULL_MESHES``."""
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from fantasy_world_tpu_torch.parallel import sharding
    cfg = cs.mesh_fusion_config()
    height, width, frames = cs.MESH_GEOMETRY
    fhw = ((frames - 1) // 4 + 1, height // 16, width // 16)
    ref = None
    if lead:
        losses, grads, seconds, peak, _ = cs.mesh_lora_steps(dev, cfg, seed,
                                                             steps=1)
        ref = {"loss": losses[0], "grads": grads[0]}
        cs.say("mesh_check_train_one_process", loss=f"{losses[0]:.5f}",
               step_seconds=f"{seconds[0]:.3f}", peak_gb=f"{peak:.2f}")
        out.append({"check": "train_one_process", "loss": losses[0],
                    "step_seconds": seconds, "peak_gb": peak})
        del grads
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    for shape, uly in FULL_MESHES:
        mesh = sharding.make_mesh(*shape)
        losses, grads, seconds, peak, launches = cs.mesh_lora_steps(
            dev, cfg, seed, mesh, uly, steps=1)
        stats = torch.tensor([*seconds, peak], device="cuda")
        rows = [torch.empty_like(stats) for _ in range(world)]
        dist.all_gather(rows, stats)
        errs = None
        if lead:
            names = sorted(ref["grads"])
            errs = {"loss": abs(losses[0] - ref["loss"]) / abs(ref["loss"]),
                    "lora_grads": cs._rel_l2(
                        [grads[0][n] for n in names],
                        [ref["grads"][n] for n in names])}
            cs.say("mesh_check_train", mesh="x".join(map(str, shape)),
                   ulysses=uly, loss=f"{losses[0]:.5f}",
                   rank_step_seconds="|".join(f"{r[0].item():.3f}"
                                              for r in rows),
                   rank_peak_gb="|".join(f"{r[-1].item():.2f}"
                                         for r in rows))
        check(f"train_{'x'.join(map(str, shape))}{'_ulysses' * uly}", errs,
              launches, cs.mesh_train_launches(
                  cfg, fhw, shape, cs.MESH_MODES["full", shape, uly],
                  mesh.rank, 1, 512), lead, out, tol=cs.TRAIN_TOL)
        if lead:
            out[-1].update(rank_step_seconds=[r[0].item() for r in rows],
                           rank_peak_gb=[r[-1].item() for r in rows])
        del grads
        gc.collect()
        torch.cuda.empty_cache()


def _block_holder(block, layout, layers):
    """The rank of ``layout`` (stages, data, seq, _) that holds ``block``
    at data and seq index 0."""
    stages, data, seq, _ = layout
    return (block // (layers // stages)) * data * seq


def _grad_rel_l2(dev, ref, ref_layout, got, got_layout, layers,
                 joint=False):
    """The relative L2 of this rank's gradients ``got`` against ``ref``'s
    (this rank's; None where it ran no reference), by
    ``chip_smoke.pipe_grad_rel_l2`` (``joint``: a cross-attention key bias
    with its weight): lite's where the rank holds both, each block's sent
    from the rank that holds it in ``ref_layout`` to the one that holds it
    in ``got_layout``. Every rank calls it; {name: error} of this rank's
    comparisons."""
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    me = dist.get_rank()

    def rel(names, theirs):
        return cs.pipe_grad_rel_l2({n: got[n] for n in names}, theirs,
                                   "cpu", joint)[0]
    errs = ({} if ref is None else
            rel([n for n in got if not n.startswith("blocks.")], ref))
    suffixes = sorted({n.split(".", 2)[2] for n in got
                       if n.startswith("blocks.")})
    for i in range(layers):
        src = _block_holder(i, ref_layout, layers)
        dst = _block_holder(i, got_layout, layers)
        names = [f"blocks.{i}.{suffix}" for suffix in suffixes]
        if me == src == dst:
            errs.update(rel(names, ref))
        elif me == src:
            for n in names:
                dist.send(ref[n].to(dev), dst)
        elif me == dst:
            theirs = {}
            for n in names:
                theirs[n] = torch.empty_like(got[n], device=dev)
                dist.recv(theirs[n], src)
            errs.update(rel(names, theirs))
    return errs


def pipe_train(dev, lead, world, out, seed=1024):
    """Section 7 (module docstring)."""
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from fantasy_world_tpu_torch.parallel.pipeline import make_pipe_mesh
    geometry, text_len = cs.FULL_PIPE_GEOMETRY, 512

    def run(layers, layout, batch):
        """One step of ``layout`` at ``layers`` blocks on every rank, with
        Ulysses on seq ranks: {loss, grads, launches, want}."""
        S, D, Sq, M = layout
        cfg = cs.full_pipe_config(layers)
        loss, model, seconds, peak, launches = cs.pipe_step(
            dev, torch.bfloat16, cfg, seed, batch,
            make_pipe_mesh(S, data=D, seq=Sq), microbatches=M,
            ulysses=Sq > 1)
        grads = {n: p.grad.detach().cpu()
                 for n, p in model.named_parameters()}
        # lite is the same bits on every rank where its elementwise maximum
        # over the ranks is its minimum
        lite = torch.cat([p.detach().flatten() for n, p in
                          sorted(model.named_parameters())
                          if not n.startswith("blocks.")])
        hi, lo = lite.clone(), lite.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        same = bool(torch.equal(hi, lo))
        stats = torch.tensor([seconds, peak], device=dev)
        rows = [torch.empty_like(stats) for _ in range(world)]
        dist.all_gather(rows, stats)
        if lead:
            name = f"pipe_{S}x{D}x{Sq}_m{M}_{layers}"
            cs.say("mesh_check_pipe", layout=name, blocks=layers,
                   loss=f"{loss:.5f}", lite_bit_equal=same,
                   rank_step_seconds="|".join(f"{r[0].item():.3f}"
                                              for r in rows),
                   rank_peak_gb="|".join(f"{r[1].item():.2f}"
                                         for r in rows))
            out.append({"check": name, "loss": loss, "lite_bit_equal": same,
                        "rank_step_seconds": [r[0].item() for r in rows],
                        "rank_peak_gb": [r[1].item() for r in rows]})
            if not same:
                raise AssertionError(f"{name}: lite differs between ranks")
        want = cs.pipe_launches_of(cfg, geometry, text_len,
                                   dist.get_rank(), Sq, Sq > 1, stages=S,
                                   microbatches=M)
        del model, lite, hi, lo
        gc.collect()
        torch.cuda.empty_cache()
        return {"loss": loss, "grads": grads, "launches": launches,
                "want": want}

    def compare(name, ref, ref_layout, got, got_layout, layers):
        """``got`` against ``ref`` (None off the ranks that ran it; its
        loss broadcast from rank 0): the loss and every gradient within
        TRAIN_TOL, exact launches on every rank."""
        errs = _grad_rel_l2(dev, ref and ref["grads"], ref_layout,
                            got["grads"], got_layout, layers,
                            joint=got_layout[2] > 1)
        every = [None] * world
        dist.all_gather_object(every, errs)
        ok = torch.tensor([int(got["launches"] == got["want"])], device=dev)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        if not lead:
            return
        errs = {n: v for e in every for n, v in e.items()}
        worst = max(errs.items(), key=lambda kv: kv[1])
        loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        row = {"check": name, "blocks": layers, "grads_compared": len(errs),
               "worst_grad_rel_l2": list(worst), "loss_rel": loss_rel,
               "launches_exact": bool(ok.item()),
               "rank0_launches": {k: v for k, v in got["launches"].items()
                                  if v}}
        out.append(row)
        cs.say("mesh_check", **{k: json.dumps(v).replace(" ", "")
                                if isinstance(v, (dict, list)) else v
                                for k, v in row.items()})
        if not (worst[1] <= cs.TRAIN_TOL and loss_rel <= cs.TRAIN_TOL
                and ok.item()):
            raise AssertionError(f"{name}: {row}")

    batch = cs.pipe_batch(cs.full_pipe_config(), geometry, seed + 7,
                          text_len, n=4)
    # the first layout and 'seq' inside a stage at PIPE_REF_DEPTH against
    # one process on rank 0
    one = (1, 1, 1, PIPE_LAYOUTS[0][-1])
    ref = None
    if lead:
        cfg = cs.full_pipe_config(PIPE_REF_DEPTH)
        loss, model, seconds, peak, _ = cs.pipe_step(
            dev, torch.bfloat16, cfg, seed, batch, microbatches=one[-1])
        ref = {"loss": loss, "grads": {n: p.grad.detach().cpu()
                                       for n, p in model.named_parameters()}}
        cs.say("mesh_check_pipe_one_process", blocks=PIPE_REF_DEPTH,
               loss=f"{loss:.5f}", step_seconds=f"{seconds:.3f}",
               peak_gb=f"{peak:.2f}")
        out.append({"check": "pipe_one_process", "blocks": PIPE_REF_DEPTH,
                    "loss": loss, "step_seconds": seconds, "peak_gb": peak})
        del model
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    got = run(PIPE_REF_DEPTH, PIPE_LAYOUTS[0], batch)
    compare("pipe_one_process", ref, one, got, PIPE_LAYOUTS[0],
            PIPE_REF_DEPTH)
    del got
    got = run(PIPE_REF_DEPTH, PIPE_SEQ_LAYOUT, batch)
    compare("pipe_seq_one_process", ref, one, got, PIPE_SEQ_LAYOUT,
            PIPE_REF_DEPTH)
    del ref, got
    # both layouts at PIPE_DEPTH, the second against the first
    first, second = (run(PIPE_DEPTH, layout, batch)
                     for layout in PIPE_LAYOUTS)
    compare("pipe_layouts", first, PIPE_LAYOUTS[0], second, PIPE_LAYOUTS[1],
            PIPE_DEPTH)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None)
    p.add_argument("--sections", default="1,2,3,4,5,6,7",
                   help="the checks to run (comma-separated numbers)")
    args = p.parse_args(argv)
    sections = {int(x) for x in args.sections.split(",")}
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from fantasy_world_tpu_torch.parallel import distributed, sharding
    if not distributed.is_multiprocess_env():
        raise SystemExit("run under torchrun, one process per card")
    distributed.initialize("cuda")
    dev = distributed.rank_device("cuda")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    lead = dist.get_rank() == 0
    if lead:
        fa.build_kernels()
    dist.barrier()
    fa.build_kernels()
    world, out, t_all = dist.get_world_size(), [], time.perf_counter()
    if lead:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        cs.say("mesh_check_backend", backend=dist.get_backend(),
               world=world, torch=torch.__version__)

    # 1. the reduced slice on every mesh of the world
    if 1 in sections:
        ref = None
        if lead:
            ref, _, _ = cs.small_mesh_denoise(dev, sharding.single(), False)
        fcfg, _ = cs.small_configs()
        height, width, frames = cs.SMALL_GEOMETRY
        fhw = ((frames - 1) // 4 + 1, height // 16, width // 16)
        for shape, uly in SMALL_MESHES:
            mesh = sharding.make_mesh(*shape)
            got, launches, seconds = cs.small_mesh_denoise(dev, mesh, uly)
            check(f"small_{'x'.join(map(str, shape))}{'_ulysses' * uly}",
                  rel_l2(got, ref) if lead else None, launches,
                  cs.mesh_launches(fcfg, fhw, shape,
                                   cs.MESH_MODES["small", shape, uly],
                                   cs.SMALL_STEPS, mesh.rank, 16), lead, out)

    # 2. the sequence-parallel attentions at full width
    if 2 in sections:
        axis = sharding.Axis(dist.group.WORLD, world, dist.get_rank())
        for row in cs.mesh_attention_calls(dev, axis, 5):
            row = dict(row, ranks=world)
            out.append(row)
            cs.say("mesh_check_attention", **{
                k: (f"{v:.3e}" if k in ("max_abs_err", "err_bound") else
                    f"{v:.3f}" if isinstance(v, float) else v)
                for k, v in row.items()})
            if not row["max_abs_err"] <= row["err_bound"]:
                raise AssertionError(f"{row['shape']} {row['method']}")
        gc.collect()
        torch.cuda.empty_cache()

    # 3. the full-width denoise
    if 3 in sections:
        height, width, frames = cs.MESH_GEOMETRY
        fhw = ((frames - 1) // 4 + 1, height // 16, width // 16)
        cfg = cs.mesh_fusion_config()
        if lead:
            lat, pred, steps, peak, _ = cs.mesh_denoise(dev, cfg, 1024)
            ref = {k: v.float().cpu() for k, v in cs.check_outputs(
                cfg, lat, pred, height, width, frames).items()}
            cs.say("mesh_check_one_process", step_seconds="|".join(
                f"{s:.3f}" for s in steps), peak_gb=f"{peak:.2f}")
            out.append({"check": "full_one_process", "step_seconds": steps,
                        "peak_gb": peak})
            del lat, pred
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        for shape, uly in FULL_MESHES:
            mesh = sharding.make_mesh(*shape)
            lat, pred, steps, peak, launches = cs.mesh_denoise(dev, cfg, 1024,
                                                               mesh, uly)
            stats = torch.tensor([*steps, peak], device="cuda")
            rows = [torch.empty_like(stats) for _ in range(world)]
            dist.all_gather(rows, stats)
            errs = None
            if lead:
                got = {k: v.float().cpu() for k, v in cs.check_outputs(
                    cfg, lat, pred, height, width, frames).items()}
                errs = rel_l2(got, ref)
                cs.say("mesh_check_full", mesh="x".join(map(str, shape)),
                       ulysses=uly, rank_step_seconds="|".join(
                           "/".join(f"{s:.3f}" for s in r[:-1].tolist())
                           for r in rows),
                       rank_peak_gb="|".join(f"{r[-1].item():.2f}"
                                             for r in rows))
            check(f"full_{'x'.join(map(str, shape))}{'_ulysses' * uly}", errs,
                  launches, cs.mesh_launches(cfg, fhw, shape,
                                             cs.MESH_MODES["full", shape, uly],
                                             cs.MESH_STEPS, mesh.rank, 512),
                  lead, out)
            if lead:
                out[-1].update(
                    rank_step_seconds=[r[:-1].tolist() for r in rows],
                    rank_peak_gb=[r[-1].item() for r in rows])
            del lat, pred
            gc.collect()
            torch.cuda.empty_cache()

    # 4. the serving options at reduced widths
    if 4 in sections:
        serving(dev, lead, out)
        gc.collect()
        torch.cuda.empty_cache()

    # 5. the Wan2.2 dual denoise at full width, both experts resident
    if 5 in sections:
        wan22_full(dev, lead, world, out)
        gc.collect()
        torch.cuda.empty_cache()

    # 6. the mesh trainer at full width and depth
    if 6 in sections:
        mesh_train(dev, lead, world, out)
        gc.collect()
        torch.cuda.empty_cache()

    # 7. the pipeline trainer at full width, more blocks than one card holds
    if 7 in sections:
        pipe_train(dev, lead, world, out)

    if lead:
        cs.say("mesh_check_done",
               seconds=f"{time.perf_counter() - t_all:.1f}")
        line = json.dumps({"mesh_check": out})
        print(line, flush=True)
        if args.json:
            with open(args.json, "w") as fh:
                fh.write(line + "\n")
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
