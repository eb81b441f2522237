"""Flow-matching fine-tuning of the fusion model (``cli/train.py``).

    python -m fantasy_world_tpu_torch.cli.train --data_root CLIPS \
        --wan_ckpt_path DIR --model_ckpt model.pth --tokenizer_path TOK \
        --lora_rank 16 --steps N [--checkpoint_dir D] [--device cpu]
    python -m fantasy_world_tpu_torch.cli.train --synthetic --steps 2 \
        --demo_dim 64 --demo_layers 2 [--lora_rank 4] [--checkpoint_dir D] \
        [--device cpu]

The loop of the JAX trainer on one device: full fine-tuning
(``training/step.py``) or, with ``--lora_rank N``, rank-N adapters on the
DiT projections over a frozen base (``training/lora.py``); per-block
recompute unless ``--no_remat``; AdamW with a linear warm-up from 0;
save/resume of (trainable parameters, optimizer, schedule, step) with
``torch.save`` into ``step_%08d`` directories; a non-finite-loss guard;
metrics and an optional ``torch.profiler`` trace. It runs on the card
(``--device cuda``, the default: bf16, through the kernels) and on the CPU
only when asked (``--device cpu``: f32, the plain versions); without a
card and without ``--device cpu`` it exits.

Two data modes:
  * ``--data_root DIR`` with the reference checkpoints (``--wan_ckpt_path``,
    ``--model_ckpt``, loaded by ``convert/checkpoint.py:load_pipeline``):
    each subdirectory of DIR is a clip, ``video.mp4`` (imageio) or
    ``frames/*.png|jpg``, ``prompt.txt`` and optionally ``poses.txt``
    (RealEstate10K rows, for the Plucker conditioning). Step i takes clip
    i mod the clip count: its first ``--frames`` frames (or all, when it
    has fewer; not rounded to 4k + 1), centre-cropped and resized to
    ``--height`` x ``--width``, through ``training/data.py:
    build_train_batch``. The noise of step i comes from a generator seeded
    by (``--seed``, i), so a resumed run continues as an unbroken one.
  * ``--synthetic``: random batches at a reduced demo config, from the
    same numpy stream as the JAX trainer, so both see identical batches;
    a resumed run continues the stream where the checkpoint left it.

The encoders stay on the card beside the fusion model. LoRA is what fits
one 80 GB card at full width: full fine-tuning of the 18.5B model holds
~37 GB of bf16 weights, as much again in gradients and ~148 GB of f32
AdamW moments, and runs out of memory.

Multi-GPU: ``--mesh_data D --mesh_seq S --mesh_model M`` under torchrun,
one process per rank (NCCL, a card each; gloo with ``--device cpu``):

    torchrun --nproc_per_node 2 -m fantasy_world_tpu_torch.cli.train \
        --synthetic --mesh_model 2 --lora_rank 4 ...

Each rank builds its part of the model (``FusionModel.shard``: the DiT's
megatron splits; LoRA factors follow their layers), takes the whole batch
and runs its rows ('data'), frames ('seq', the long attentions gathering
their keys) and columns ('model') of the step (``training/step.py``);
every rank sees the same loss. With ``--data_root`` and ``--mesh_data`` >
1 a step stacks that many clips with a sigma each
(``_stacked_data_batches``). Rank 0 saves the whole trainable tensors and
AdamW moments under the one-process names, gathered over the model group;
every rank resumes its part, so a checkpoint moves between a mesh and one
process. ``--pipe_stages`` exits: the pipeline-parallel trainer is a later
multi-GPU slice (ROADMAP queue A item 5(c)).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="fantasy-world-tpu trainer "
                                            "(PyTorch port)")
    p.add_argument("--data_root", type=str, default=None,
                   help="directory of clip subdirs (video.mp4 | frames/ + "
                        "prompt.txt [+ poses.txt]); needs --wan_ckpt_path "
                        "and --model_ckpt")
    p.add_argument("--synthetic", action="store_true",
                   help="random batches at a reduced config (no ckpts/data)")
    p.add_argument("--wan_ckpt_path", type=str, default=None)
    p.add_argument("--model_ckpt", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: bf16 through the kernels; cpu: f32 through "
                        "the plain versions")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--height", type=int, default=336)
    p.add_argument("--width", type=int, default=592)
    p.add_argument("--frames", type=int, default=81)
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_seq", type=int, default=1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--no_remat", action="store_true")
    p.add_argument("--lora_rank", type=int, default=0,
                   help="train rank-N LoRA factors on the DiT projections "
                        "instead of full fine-tuning (base stays frozen); "
                        "at full width LoRA is what fits one H100")
    p.add_argument("--lora_alpha", type=float, default=1.0)
    p.add_argument("--lora_targets", type=str,
                   default="self_attn,cross_attn,ffn",
                   help="comma-separated DiT block components to adapt")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="state dir; resumes if it already has a step")
    p.add_argument("--save_every", type=int, default=200)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the train "
                        "loop into this directory")
    p.add_argument("--pipe_stages", type=int, default=0,
                   help="GPipe stages (not in the port yet: multi-GPU)")
    p.add_argument("--pipe_microbatches", type=int, default=2)
    # synthetic-mode model scale (kept tiny so CPU smoke tests are cheap)
    p.add_argument("--demo_dim", type=int, default=128)
    p.add_argument("--demo_layers", type=int, default=2)
    p.add_argument("--demo_start_index", type=int, default=1)
    return p.parse_args(argv)


def _optimizer(args, params):
    """AdamW(lr, weight_decay, eps 1e-8) with a linear warm-up 0 -> lr over
    ``warmup`` steps, then constant: lr * min(c, warmup) / warmup at step c
    (optax's join of linear_schedule(0, lr, warmup) and a constant)."""
    warmup = max(1, args.warmup)
    opt = torch.optim.AdamW(params, lr=args.lr,
                            weight_decay=args.weight_decay, eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda c: min(c, warmup) / warmup)
    return opt, sched


def _latest_step(root):
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(root)
             if d.startswith("step_") and d.split("_")[1].isdigit()]
    return max(steps) if steps else None


class _Run:
    """What the loop saves and resumes: the trainable tensors by name, the
    optimizer and schedule, and on a mesh the model (whose
    ``param_parts`` say which tensors are split) and the mesh."""

    def __init__(self, trainable, opt, sched, model=None, mesh=None):
        self.trainable, self.opt, self.sched = trainable, opt, sched
        self.model, self.mesh = model, mesh
        self.device = next(iter(trainable.values())).device

    def _moments(self, state, fn):
        """``state`` (an optimizer state dict) with ``fn(name, t)`` applied
        to every per-parameter tensor of its parameters' shapes."""
        names = list(self.trainable)
        # new dicts: an optimizer's state_dict() shares its live entries
        return dict(state, state={
            i: {key: (fn(names[int(i)], t)
                      if torch.is_tensor(t) and t.dim() > 0 else t)
                for key, t in entry.items()}
            for i, entry in state["state"].items()})

    def whole(self):
        """(trainable, optimizer state) as one process holds them, gathered
        over the model group on a mesh (every rank calls it)."""
        from ..parallel.sharding import whole_tensor
        if self.mesh is None:
            return ({n: p.detach() for n, p in self.trainable.items()},
                    self.opt.state_dict())

        def gather(name, t):
            return whole_tensor(t, name, self.model, self.mesh)
        return ({n: gather(n, p) for n, p in self.trainable.items()},
                self._moments(self.opt.state_dict(), gather))

    def load(self, trainable, optimizer):
        """Take this rank's part of the whole tensors of a checkpoint."""
        from ..parallel.sharding import part_of_whole

        def part(name, t):
            return (t if self.model is None
                    else part_of_whole(t, name, self.model))
        for name, p in self.trainable.items():
            p.copy_(part(name, trainable[name]))
        self.opt.load_state_dict(self._moments(optimizer, part))


def _save_state(root, step, run: _Run, extra=None):
    """Rank 0 writes ``step_%08d/state.pt`` (every rank calls it: the
    whole tensors are gathered first); returns its path."""
    trainable, optimizer = run.whole()
    path = os.path.join(root, f"step_{step:08d}")
    if run.mesh is None or run.mesh.rank == 0:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "state.pt.tmp")
        torch.save({"trainable": trainable, "optimizer": optimizer,
                    "scheduler": run.sched.state_dict(), "step": step,
                    **(extra or {})}, tmp)
        os.replace(tmp, os.path.join(path, "state.pt"))
    if run.mesh is not None:
        from ..parallel.distributed import barrier
        barrier()
    return path


@torch.no_grad()
def _resume_state(args, run: _Run, log):
    """Restore the latest ``step_*`` of --checkpoint_dir into the trainable
    parameters, the optimizer and the schedule (each rank its parts);
    returns (the step to start from, the checkpoint's entries)."""
    if not args.checkpoint_dir:
        return 0, {}
    root = os.path.abspath(args.checkpoint_dir)
    latest = _latest_step(root)
    if latest is None:
        return 0, {}
    state = torch.load(os.path.join(root, f"step_{latest:08d}", "state.pt"),
                       map_location=run.device, weights_only=True)
    if set(state["trainable"]) != set(run.trainable):
        raise SystemExit(f"checkpoint {root} holds other parameters than "
                         f"this run trains")
    run.load(state["trainable"], state["optimizer"])
    run.sched.load_state_dict(state["scheduler"])
    log.info("resumed from %s at step %d", root, state["step"])
    return int(state["step"]), state


def _nonfinite(loss_val: float, mesh, device) -> bool:
    """Whether the loss is not finite on any rank: every rank stops
    alike."""
    bad = not np.isfinite(loss_val)
    if mesh is None:
        return bad
    import torch.distributed as dist

    from ..parallel.distributed import all_reduce_max
    flag = torch.tensor([float(bad)], device=device)
    return bool(all_reduce_max(flag, dist.group.WORLD).item())


def _train_loop(args, step_fn, batches, run: _Run, start, log) -> float:
    """Step, host loss fetch (the barrier), metrics, non-finite guard,
    periodic save. Returns the final loss."""
    from ..utils.observability import Metrics, profile_trace

    root = (os.path.abspath(args.checkpoint_dir) if args.checkpoint_dir
            else None)
    metrics = Metrics()
    loss_val = float("nan")
    with profile_trace(args.profile_dir):
        for step in range(start, args.steps):
            batch = next(batches)
            t0 = time.perf_counter()
            loss_val = float(step_fn(batch))
            dt = time.perf_counter() - t0
            metrics.gauge("loss", loss_val)
            metrics.observe("step", dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                log.info("step %d  loss %.5f  %.2fs", step, loss_val, dt)
            if _nonfinite(loss_val, run.mesh, run.device):
                raise SystemExit(f"non-finite loss at step {step}")
            if root and ((step + 1) % args.save_every == 0
                         or step == args.steps - 1):
                position = getattr(batches, "position", None)
                path = _save_state(
                    root, step + 1, run,
                    None if position is None else {"data_position": position})
                log.info("saved %s", path)
    metrics.log_summary(log)
    return loss_val


def _synthetic_batches(args, device):
    """Infinite random flow-matching batches at the demo geometry: the JAX
    trainer's numpy stream (``default_rng(seed)``), f32 on ``device``."""
    from ..schedulers.flow_match import FlowMatchScheduler

    B = max(1, args.mesh_data)
    f, h2, w2 = 2, 8, 8
    sched = FlowMatchScheduler().set_timesteps(1000)
    rng = np.random.default_rng(args.seed)
    while True:
        idx = int(rng.integers(0, len(sched.sigmas)))
        batch = {
            "clean_latents": rng.standard_normal((B, 16, f, h2, w2)),
            "noise": rng.standard_normal((B, 16, f, h2, w2)),
            "sigma": np.float32(sched.sigmas[idx]),
            "timestep": np.full((B,), float(sched.timesteps[idx]),
                                np.float32),
            "context": rng.standard_normal((B, 64, 4096)) * 0.02,
            "clip_feature": rng.standard_normal((B, 257, 1280)) * 0.02,
            "y": rng.standard_normal((B, 20, f, h2, w2)),
            "plucker_fea": rng.standard_normal(
                (B, f * (h2 // 2) * (w2 // 2), 2048)) * 0.02,
        }
        yield {k: (torch.as_tensor(np.asarray(v, np.float32), device=device)
                   if np.ndim(v) > 0 else float(v))
               for k, v in batch.items()}


def _clip_dirs(root):
    return sorted(d for d in (os.path.join(root, n) for n in os.listdir(root))
                  if os.path.isdir(d))


def read_clip(clip: str, height: int, width: int, frames: int):
    """One clip directory -> (frames (n, height, width, 3) uint8, prompt,
    Plucker rays (1, n, height, width, 6) or None), n = min(its frames,
    ``frames``); the rays are first-frame-relative with frame 0 at the
    origin, one per frame, from ``poses.txt``."""
    from ..data.re10k import re10k_plucker
    from ..data.video import VideoData
    src = os.path.join(clip, "video.mp4")
    if os.path.exists(src):
        video = VideoData(src, height=height, width=width)
    else:
        video = VideoData(image_folder=os.path.join(clip, "frames"),
                          height=height, width=width)
    n = min(len(video), frames)
    clip_frames = np.stack([np.asarray(video[j]) for j in range(n)])
    with open(os.path.join(clip, "prompt.txt")) as fh:
        prompt = fh.read().strip()
    pose_file = os.path.join(clip, "poses.txt")
    plucker = (re10k_plucker(pose_file, n, (height, width))
               if os.path.exists(pose_file) else None)
    return clip_frames, prompt, plucker


def _data_batches(pipe, args, start: int = 0, stage_callback=None):
    """Step ``start``, ``start`` + 1, ... -> ``build_train_batch`` of clip
    step mod the clip count, its noise drawn from a generator seeded by
    (--seed, step); ``stage_callback(name)`` runs after the clip is read
("read_clip") and after each stage of the build."""
    from ..training.data import build_train_batch

    clips = _clip_dirs(args.data_root)
    step = start
    while True:
        frames, prompt, plucker = read_clip(clips[step % len(clips)],
                                            args.height, args.width,
                                            args.frames)
        if stage_callback is not None:
            stage_callback("read_clip")
        gen = torch.Generator(pipe.device).manual_seed(int(
            np.random.SeedSequence([args.seed, step]).generate_state(1)[0]))
        yield build_train_batch(pipe, frames, prompt, gen,
                                plucker_embedding=plucker,
                                stage_callback=stage_callback)
        step += 1


class _stacked_data_batches:
    """``B`` clips of ``_data_batches`` a step, stacked into one batch with
    a sigma per clip, (B, 1, 1, 1, 1) (JAX ``cli/train.py:
    _stacked_data_batches``, for ``--mesh_data`` > 1: the batch splits
    over the data ranks). A clip whose latent shape is not the one of
    --frames/--height/--width (shorter than --frames) is skipped, and a
    whole cycle of clips without a match exits. ``start``: the position in
    ``_data_batches``' stream to begin at; ``position`` is where the next
    batch begins, which a checkpoint keeps (``data_position``), so a
    resumed run continues as an unbroken one."""

    KEYS = ("clean_latents", "noise", "context", "clip_feature", "y",
            "plucker_fea")

    def __init__(self, pipe, args, B: int, start: int = 0):
        from ..utils.observability import get_logger
        self.log = get_logger("train.batch")
        self.B, self.position = B, start
        self.inner = _data_batches(pipe, args, start)
        self.ref_shape = (1, pipe.vae_cfg.z_dim, (args.frames - 1) // 4 + 1,
                          args.height // 8, args.width // 8)
        self.n_clips = len(_clip_dirs(args.data_root))
        self.skipped = 0

    def _next_uniform(self):
        misses = 0
        while True:
            part = next(self.inner)
            self.position += 1
            shape = tuple(part["clean_latents"].shape)
            if shape == self.ref_shape:
                return part
            self.skipped += 1
            misses += 1
            if self.skipped in (1, 10) or self.skipped % 100 == 0:
                self.log.warning(
                    "skipped %d clip(s) with latent shape %s != %s "
                    "(shorter than --frames?)", self.skipped, shape,
                    self.ref_shape)
            if misses > self.n_clips:       # a whole cycle without a match
                raise SystemExit(
                    f"no clip under --data_root matches the --frames/"
                    f"--height/--width latent shape {self.ref_shape} "
                    f"(last seen {shape})")

    def __iter__(self):
        return self

    def __next__(self):
        parts = [self._next_uniform() for _ in range(self.B)]
        batch = {}
        for k in self.KEYS:
            vals = [p.get(k) for p in parts]
            if any(v is None for v in vals):
                continue
            batch[k] = torch.cat(vals, dim=0)
        batch["timestep"] = torch.cat([p["timestep"] for p in parts])
        batch["sigma"] = torch.tensor(
            [float(p["sigma"]) for p in parts], dtype=torch.float32,
            device=batch["clean_latents"].device).reshape(self.B, 1, 1, 1, 1)
        return batch


def _check_args(args) -> None:
    """SystemExit for the mode that a later multi-GPU slice brings, for a
    mesh without its processes, and for a real-data run without its paths
    or clips."""
    from .infer_wan21 import check_mesh
    if args.pipe_stages > 0:
        raise SystemExit("--pipe_stages: the pipeline-parallel trainer is a "
                         "later multi-GPU slice of the port (ROADMAP queue "
                         "A item 5(c))")
    check_mesh(args)
    if args.synthetic:
        return
    if not (args.wan_ckpt_path and args.model_ckpt and args.data_root):
        raise SystemExit("real-data mode needs --wan_ckpt_path, "
                         "--model_ckpt and --data_root (or --synthetic)")
    if not (os.path.isdir(args.data_root) and _clip_dirs(args.data_root)):
        raise SystemExit(f"no clip subdirectories under {args.data_root}")


def _model(args, device, dtype, log, mesh=None):
    """(fusion model, pipeline or None): the demo config from the seed
    (--synthetic), else the reference checkpoints with their encoders; on
    a ``mesh``, this rank's part of the model."""
    from ..core.params import build
    from ..models.fusion.model import FusionModel
    from ..utils.demo import demo_config

    if args.synthetic:
        cfg = demo_config(dim=args.demo_dim, layers=args.demo_layers,
                          start_index=args.demo_start_index,
                          agg_dim=max(32, args.demo_dim // 4))
        gen = torch.Generator(device).manual_seed(args.seed)
        return build(lambda: FusionModel(cfg), device=device, dtype=dtype,
                     generator=gen, mesh=mesh), None
    from ..convert.checkpoint import load_pipeline, missing_files
    missing = missing_files(args.wan_ckpt_path, args.model_ckpt)
    if missing:
        raise SystemExit("checkpoint files missing: " + ", ".join(missing))
    t0 = time.perf_counter()
    pipe = load_pipeline(args.wan_ckpt_path, args.model_ckpt, device=device,
                         dtype=dtype, tokenizer_path=args.tokenizer_path)
    log.info("loaded %s + %s in %.1fs", args.wan_ckpt_path, args.model_ckpt,
             time.perf_counter() - t0)
    if mesh is not None:
        pipe.shard(mesh)
    return pipe.fusion, pipe


def run(args) -> Optional[float]:
    """Train; returns the final loss (None when the checkpoint is already
    at --steps)."""
    from ..utils.observability import get_logger

    from .infer_wan21 import start_mesh

    _check_args(args)
    log = get_logger("train")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the trainer runs on the card; "
                         "pass --device cpu to train on the CPU")
    import torch.distributed as dist
    # a caller that opened the process group (ranks spawned by
    # ``distributed.spawn``) closes it; torchrun's ranks close it here
    opened = not dist.is_initialized()
    device, mesh = start_mesh(args)
    try:
        return _run(args, device, mesh, log)
    finally:
        if mesh is not None and opened:
            from ..parallel import distributed
            distributed.shutdown()


def _run(args, device, mesh, log) -> Optional[float]:
    from ..training.lora import init_lora, lora_state, make_lora_train_step
    from ..training.step import make_train_step

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, pipe = _model(args, device, dtype, log, mesh)
    if args.lora_rank > 0:
        targets = tuple(t for t in args.lora_targets.split(",") if t)
        factors = init_lora(model, args.lora_rank,
                            generator=torch.Generator(device).manual_seed(
                                args.seed + 1),
                            alpha=args.lora_alpha, targets=targets)
        trainable = lora_state(model)
        log.info("LoRA mode: rank %d over %d linears (%s)", args.lora_rank,
                 len(factors) // 2, args.lora_targets)
    else:
        trainable = dict(model.named_parameters())
    opt, sched = _optimizer(args, list(trainable.values()))
    run = _Run(trainable, opt, sched, model, mesh)
    start, saved = _resume_state(args, run, log)
    if start >= args.steps:
        print(f"train done: checkpoint already at step {start} "
              f">= --steps {args.steps}")
        return None
    make = make_lora_train_step if args.lora_rank > 0 else make_train_step
    step_fn = make(model, opt, sched, remat=not args.no_remat, mesh=mesh)
    if pipe is None:
        batches = _synthetic_batches(args, device)
        for _ in range(start):          # a resumed run continues the stream
            next(batches)
    elif args.mesh_data > 1:
        batches = _stacked_data_batches(
            pipe, args, args.mesh_data,
            int(saved.get("data_position", start * args.mesh_data)))
    else:
        batches = _data_batches(pipe, args, start)
    loss_val = _train_loop(args, step_fn, batches, run, start, log)
    where = ("" if mesh is None else
             f" on {mesh.world} ranks ({'x'.join(map(str, mesh.shape))})")
    print(f"train done: {args.steps - start} step(s){where}, final loss "
          f"{loss_val:.5f}")
    return loss_val


def main(argv=None) -> Optional[float]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
