"""The pipeline trainer's jobs: one GPipe step of the reduced plain DiT over
2 stages (and 2 seq ranks a stage) against the CPU's one-process step, the
full-width step cut in depth against the same step in one process on the
card, and ``cli.train --pipe_stages 2`` saved and resumed. They run in the
mesh phases' spawns (``mesh.py``).
"""
from __future__ import annotations

import gc
import json
import math
import os
import time

from .common import (FULL_PIPE_REF, SOFTMAX_CANCELLED, TRAIN_CLI_PIPE_DIR,
                     TRAIN_TOL, add_counts, nonzero, rel_l2, say, to_device)
from .inputs import (PIPE_MICROBATCHES, PIPE_STAGES, SMALL_GEOMETRY,
                     small_configs, stack_batches, train_batches)
from .launches import pipe_launches_of
from .jobs import mesh_path, rank_record, rank_setup


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
# 'seq' inside a stage, jobs of small_meshes' 4-rank spawn, 2 stages x 2
# seq ranks: small_pipe_seq, small_pipe's model and batch (6 latent frames,
# 3 | 3) with the self-attention gathered and through Ulysses (1 of 2
# heads a rank); full_pipe_seq, WanDiTConfig() cut to 2 blocks (1 a
# stage) at full_pipe's geometry (21 latent frames, 11 | 10: 17,160 |
# 15,600 tokens), Ulysses (20 of 40 heads a rank)
PIPE_SEQ = 2
SMALL_PIPE_SEQ_RUNS = (False, True)
FULL_PIPE_SEQ_DEPTH = 2


def small_pipe_config():
    import dataclasses
    fcfg, _ = small_configs()
    return dataclasses.replace(fcfg.dit, num_layers=4, camera_adapter_end=0)


def full_pipe_config(depth=FULL_PIPE_DEPTH):
    from fantasy_world_tpu_torch.models.wan.dit import WanDiTConfig
    return WanDiTConfig(num_layers=depth)


def pipe_batch(cfg, geometry, seed, text_len, n=PIPE_MICROBATCHES):
    """``n`` seeded samples at ``geometry`` as one batch (numpy), a sigma
    each; no Plucker features (the plain DiT takes none)."""
    batch = stack_batches(train_batches(cfg, *geometry, n, seed=seed,
                                        text_len=text_len))
    batch.pop("plucker_fea")
    return batch


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
    batch = to_device(batch, device)
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


def small_pipe_rank(rank, seq=1, ulysses=False):
    """small_pipe on this rank (its stage, and its frames on ``seq``
    ranks): the step's loss, seconds, peak and launches; its gradients and
    updated values saved for the parent."""
    import torch
    from fantasy_world_tpu_torch.parallel.pipeline import make_pipe_mesh
    dev = rank_setup()
    cfg = small_pipe_config()
    loss, model, seconds, peak, launches = pipe_step(
        dev, getattr(torch, SMALL_PIPE_DTYPE), cfg, SMALL_PIPE_SEED,
        pipe_batch(cfg, SMALL_GEOMETRY, SMALL_PIPE_SEED + 2, 16),
        make_pipe_mesh(PIPE_STAGES, seq=seq), host_init=True,
        ulysses=ulysses)
    grads, params = _grads_values(model)
    torch.save({"grads": grads, "params": params},
               mesh_path(f"pipe{rank}.pt"))
    rank_record(rank, loss=loss, seconds=seconds, peak_gb=peak,
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
              "lite_grads": rel_l2([saved[0]["grads"][n] for n in lite],
                                   [cpu["grads"][n] for n in lite]),
              "lite_params": rel_l2([saved[0]["params"][n] for n in lite],
                                    [cpu["params"][n] for n in lite])}
    for r, s in enumerate(saved):
        blocks = sorted(n for n in s["grads"] if n.startswith("blocks."))
        checks[f"rank{r}_block_grads"] = rel_l2(
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
        rank0_launches=nonzero(records[0]["launches"]))
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
    return add_counts(*(r["launches"] for r in records))


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


def full_pipe_rank(rank, seed, depth=FULL_PIPE_DEPTH, seq=1,
                   ulysses=False, path=FULL_PIPE_REF):
    """full_pipe (or full_pipe_seq: ``seq`` ranks a stage) on this rank:
    the step, then the relative L2 of each of its gradients against the
    one-process run's (saved at ``path``)."""
    import torch
    from fantasy_world_tpu_torch.parallel.pipeline import make_pipe_mesh
    dev = rank_setup()
    cfg = full_pipe_config(depth)
    loss, model, seconds, peak, launches = pipe_step(
        dev, torch.bfloat16, cfg, seed,
        pipe_batch(cfg, FULL_PIPE_GEOMETRY, seed + 7, 512),
        make_pipe_mesh(PIPE_STAGES, seq=seq), ulysses=ulysses)
    ref = torch.load(path, mmap=True, weights_only=True)
    grads = {n: p.grad for n, p in model.named_parameters()}
    errs = rel_l2(grads, ref, joint=seq > 1)
    # the softmax-cancelled biases alone: printed, not gated
    alone = {} if seq == 1 else rel_l2(
        {n: g for n, g in grads.items() if SOFTMAX_CANCELLED.match(n)}, ref)
    rank_record(rank, loss=loss, seconds=seconds, peak_gb=peak,
                launches=launches, grad_rel_l2=errs, cancelled=alone,
                blocks=sorted({n.split(".")[1] for n in errs
                               if n.startswith("blocks.")}, key=int))


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
        rank0_launches=nonzero(records[0]["launches"]))
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
    return add_counts(*(r["launches"] for r in records))


# the trainer CLI's pipeline mode on 2 stages: the JAX trainer's demo DiT at
# dim 256 (8 heads of 32 -> d64, D zero-padded to 64), 4 blocks
PIPE_TRAIN_CLI_ARGS = ["--synthetic", "--pipe_stages", "2", "--demo_dim",
                       "256", "--demo_layers", "4", "--warmup", "1", "--lr",
                       "1e-3", "--log_every", "1", "--device", "cuda"]


def train_cli_pipe_rank(rank):
    """``cli.train``'s ``run`` on this stage of a 2-stage pipeline (the
    process group open already): 2 steps saved into TRAIN_CLI_PIPE_DIR,
    then resumed to step 3; each run's final loss, seconds and
    launches."""
    from fantasy_world_tpu_torch.cli.train import main as train_main
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    rank_setup()
    runs = []
    for steps in (2, 3):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss = train_main(PIPE_TRAIN_CLI_ARGS + [
            "--steps", str(steps), "--checkpoint_dir", TRAIN_CLI_PIPE_DIR])
        runs.append({"loss": loss, "seconds": time.perf_counter() - t0,
                     "launches": dict(fa.LAUNCHES)})
    rank_record(rank, runs=runs,
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
        rank0_launches="|".join(nonzero(run["launches"])
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
            total = add_counts(total, r["runs"][i]["launches"])
    if saved != ["step_00000002", "step_00000003"]:
        raise AssertionError(f"train CLI on a pipeline: checkpoints {saved}")
    return total
