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
process.

Pipeline parallelism: ``--pipe_stages S [--pipe_microbatches M]
[--mesh_data D]`` fine-tunes the PLAIN Wan video DiT (a homogeneous block
stack, unlike the fusion model's PCB/IRG mix) with the blocks split over
S stages of a ('pipe', 'data') mesh, S * D processes under torchrun
(one process for S = D = 1):

    torchrun --nproc_per_node 2 -m fantasy_world_tpu_torch.cli.train \
        --synthetic --pipe_stages 2 --pipe_microbatches 2 ...

Each rank builds the whole embeddings and head and only its stage's
blocks, with their gradients and AdamW moments (``training/pp.py``), and
M microbatches of a batch of M * D march through the stages
(``parallel/pipeline.py``; bubble (S - 1) / (M + S - 1)). At full width
(5120 wide, 40 heads, FFN 13824) a block is 403.8M parameters, ~3.2 GB
with bf16 weights, gradients and AdamW moments (8 bytes a parameter:
torch keeps a bf16 parameter's moments in bf16), the embeddings and head
241M (~1.9 GB), so 2 blocks a stage hold ~8.4 GB of state a rank before
the step's activations. ``--synthetic``
runs the JAX trainer's demo DiT (``--demo_dim``, ``--demo_layers``) on
its numpy stream; with ``--data_root`` the plain DiT loads from the
shards of ``--wan_ckpt_path`` (each rank reads its blocks) beside umT5,
CLIP and the VAE (no fusion model, no pose encoder: no Plucker
conditioning), M * D clips a step with a sigma each. Rank 0 saves the
whole tensors under the plain DiT's one-process names, gathered over the
stages, and every rank resumes its part, so a checkpoint moves between
stage counts. ``--pipe_stages`` does not combine with ``--lora_rank``,
``--mesh_seq`` or ``--mesh_model`` on the command line (the JAX trainer's
exits); as a library, ``training/pp.py`` composes both inside a stage:
the megatron splits over 'model' and the latent frames over 'seq', with
the gather, Ulysses or the ring for the self-attention.
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
                   help="GPipe pipeline-parallel stages for plain video-DiT "
                        "training (training/pp.py): the block stack splits "
                        "over the stages, dividing its weights, gradients "
                        "and optimizer state by the stage count. 0 (the "
                        "default) = the fusion trainer")
    p.add_argument("--pipe_microbatches", type=int, default=2,
                   help="microbatches marching through the pipeline per "
                        "step (bubble fraction = (S-1)/(M+S-1))")
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
        # where a checkpoint's whole tensors are read to, and whether they
        # are mapped from the file rather than read whole
        self.map_location, self.mmap = self.device, False

    def accepts(self, names) -> bool:
        """Whether a checkpoint of the trainable tensors ``names`` is this
        run's."""
        return set(names) == set(self.trainable)

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
                       map_location=run.map_location, mmap=run.mmap,
                       weights_only=True)
    if not run.accepts(state["trainable"]):
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


def read_clip(clip: str, height: int, width: int, frames: int,
              with_plucker: bool = True):
    """One clip directory -> (frames (n, height, width, 3) uint8, prompt,
    Plucker rays (1, n, height, width, 6) or None), n = min(its frames,
    ``frames``). The rays come from ``poses.txt`` (not read without
    ``with_plucker``) through ``data/re10k.py:RealEstate10KPoseProcessor``
    as the JAX trainer sets it up: stride 1 (the first n cameras, one per
    frame, in order), poses relative to the first, which sits at the
    origin; a file with fewer than n cameras raises ValueError."""
    from ..data.re10k import RealEstate10KPoseProcessor
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
    plucker = None
    if with_plucker and os.path.exists(pose_file):
        plucker = RealEstate10KPoseProcessor(
            sample_stride=1, sample_n_frames=n, sample_size=(height, width),
            relative_pose=True, zero_t_first_frame=True,
            is_i2v=True).get_plucker_embedding(pose_file)
    return clip_frames, prompt, plucker


def _data_batches(pipe, args, start: int = 0, stage_callback=None,
                  with_plucker: bool = True):
    """Step ``start``, ``start`` + 1, ... -> ``build_train_batch`` of clip
    step mod the clip count, its noise drawn from a generator seeded by
    (--seed, step); ``stage_callback(name)`` runs after the clip is read
("read_clip") and after each stage of the build. ``with_plucker=False``
    skips the camera poses (the pipeline trainer's plain DiT takes none,
    and its encoders have no pose encoder)."""
    from ..training.data import build_train_batch

    clips = _clip_dirs(args.data_root)
    step = start
    while True:
        frames, prompt, plucker = read_clip(clips[step % len(clips)],
                                            args.height, args.width,
                                            args.frames, with_plucker)
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
    resumed run continues as an unbroken one. ``with_plucker=False``: no
    Plucker features (the pipeline trainer's batches)."""

    KEYS = ("clean_latents", "noise", "context", "clip_feature", "y",
            "plucker_fea")

    def __init__(self, pipe, args, B: int, start: int = 0,
                 with_plucker: bool = True):
        from ..utils.observability import get_logger
        self.log = get_logger("train.batch")
        self.B, self.position = B, start
        self.keys = self.KEYS if with_plucker else self.KEYS[:-1]
        self.inner = _data_batches(pipe, args, start,
                                   with_plucker=with_plucker)
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
        for k in self.keys:
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
    """SystemExit for a mesh without its processes, for a real-data run
    without its paths or clips and, with --pipe_stages, for what the
    pipeline trainer does not run (``_check_pipe``)."""
    from .infer_wan21 import check_mesh
    if args.pipe_stages > 0:
        _check_pipe(args)
    else:
        check_mesh(args)
    if args.synthetic:
        return
    if not (args.wan_ckpt_path and args.model_ckpt and args.data_root):
        need = ("real-data PP mode needs --wan_ckpt_path (DiT shards; the "
                "conditioning encoders load from the same bundle), "
                if args.pipe_stages > 0 else
                "real-data mode needs --wan_ckpt_path, ")
        raise SystemExit(need + "--model_ckpt and --data_root (or "
                                "--synthetic)")
    if not (os.path.isdir(args.data_root) and _clip_dirs(args.data_root)):
        raise SystemExit(f"no clip subdirectories under {args.data_root}")


def _pipe_config(args):
    """The plain DiT the pipeline trainer fine-tunes: the JAX trainer's
    demo config (--synthetic), else ``WanDiTConfig()`` -- or the DiT of a
    ``configs.json`` beside the checkpoints, without camera adapters."""
    import dataclasses

    from ..models.wan.dit import WanDiTConfig
    if args.synthetic:
        dim = args.demo_dim
        return WanDiTConfig(dim=dim, in_dim=16, ffn_dim=dim * 2, out_dim=16,
                            text_dim=4096, freq_dim=128, patch_size=(1, 2, 2),
                            num_heads=max(2, dim // 32),
                            num_layers=args.demo_layers,
                            has_image_input=False)
    if not args.wan_ckpt_path:
        return WanDiTConfig()
    from ..convert.checkpoint import read_configs
    return dataclasses.replace(read_configs(args.wan_ckpt_path)["fusion"].dit,
                               camera_adapter_end=0)


def _check_pipe(args) -> None:
    """The JAX trainer's exits for --pipe_stages, in its order, all before
    any checkpoint is read: LoRA, a seq or model axis, a process count
    other than pipe x data, and a block count the stages do not divide."""
    if args.lora_rank:
        raise SystemExit("--pipe_stages does not compose with --lora_rank")
    if args.mesh_seq != 1 or args.mesh_model != 1:
        raise SystemExit("the PP trainer wires a ('pipe','data') mesh; "
                         "seq/model axes compose at the library level "
                         "(parallel/pipeline.py) but are not CLI-wired")
    S, D = args.pipe_stages, max(1, args.mesh_data)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != S * D:
        raise SystemExit(f"--pipe_stages: pipe={S} x data={D} needs "
                         f"{S * D} processes, one per rank (multi-GPU runs "
                         f"under torchrun): launch with torchrun "
                         f"--nproc_per_node {S * D} (WORLD_SIZE is {world})")
    layers = _pipe_config(args).num_layers
    if layers % S:
        raise SystemExit(f"{layers} blocks not divisible by {S} stages")


def _pp_batches(cfg, args, device):
    """Infinite random DiT flow-matching batches of M x D samples: the JAX
    trainer's numpy stream (``default_rng(seed)``), f32 on ``device``;
    every rank takes the whole batch, the data ranks their rows of it."""
    from ..schedulers.flow_match import FlowMatchScheduler

    B = args.pipe_microbatches * max(1, args.mesh_data)
    f, h2, w2 = 2, 8, 8
    sched = FlowMatchScheduler().set_timesteps(1000)
    rng = np.random.default_rng(args.seed)
    while True:
        idx = int(rng.integers(0, len(sched.sigmas)))
        batch = {
            "clean_latents": rng.standard_normal((B, cfg.in_dim, f, h2, w2)),
            "noise": rng.standard_normal((B, cfg.in_dim, f, h2, w2)),
            "sigma": np.float32(sched.sigmas[idx]),
            "timestep": np.full((B,), float(sched.timesteps[idx]),
                                np.float32),
            "context": rng.standard_normal((B, 64, cfg.text_dim)) * 0.02,
        }
        yield {k: (torch.as_tensor(np.asarray(v, np.float32), device=device)
                   if np.ndim(v) > 0 else float(v))
               for k, v in batch.items()}


def _pp_data_batches(pipe, args, start: int = 0):
    """Real-clip pipeline batches: M x D clips a step, a sigma each, no
    Plucker features (``_stacked_data_batches``)."""
    return _stacked_data_batches(
        pipe, args, args.pipe_microbatches * max(1, args.mesh_data), start,
        with_plucker=False)


class _PipeRun(_Run):
    """What the pipeline trainer saves and resumes: a checkpoint holds the
    plain DiT's whole tensors and AdamW moments under its one-process
    names, in its order; a rank holds its stage's blocks and lite (its
    part of them on a model split)."""

    def __init__(self, trainable, opt, sched, model, pipe):
        super().__init__(trainable, opt, sched, model,
                         pipe if pipe.world > 1 else None)
        from ..core.params import build
        from ..models.wan.dit import WanDiT
        self.pipe = pipe
        self.names = [n for n, _ in build(
            lambda: WanDiT(model.cfg), device="meta",
            dtype=torch.float32).named_parameters()]
        # mapped: a rank pages in only its stage's tensors of the file
        self.map_location, self.mmap = torch.device("cpu"), True

    def accepts(self, names) -> bool:
        return set(names) == set(self.names)

    def whole(self):
        """Every rank calls it; the whole tensors on rank 0 (empty dicts
        elsewhere): gathered over the model group, then over the stages."""
        from ..parallel.pipeline import gather_stages
        from ..parallel.sharding import whole_tensor
        inner = self.pipe.inner
        state = self.opt.state_dict()
        own = list(self.trainable)
        entries = {}
        for i, name in enumerate(own):
            entries[f"param/{name}"] = whole_tensor(
                self.trainable[name].detach(), name, self.model, inner)
            for key, t in state["state"].get(i, {}).items():
                if torch.is_tensor(t) and t.dim() > 0:
                    t = whole_tensor(t, name, self.model, inner)
                # AdamW's step count lives on the host: it crosses on the
                # device, as NCCL takes only device tensors
                entries[f"{key}/{name}"] = torch.as_tensor(t).to(
                    self.device)
        if inner.rank != 0:
            return {}, {}
        got = gather_stages(entries, self.pipe, self.device)
        if got is None:
            return {}, {}
        trainable = {n: got[f"param/{n}"] for n in self.names}
        keys = sorted({k.split("/", 1)[0] for k in got} - {"param"})
        group = {k: v for k, v in state["param_groups"][0].items()
                 if k != "params"}
        return trainable, {
            "state": {i: {k: got[f"{k}/{n}"] for k in keys
                          if f"{k}/{n}" in got}
                      for i, n in enumerate(self.names)},
            "param_groups": [dict(group, params=list(range(
                len(self.names))))]}

    def load(self, trainable, optimizer):
        from ..parallel.sharding import part_of_whole
        index = {n: i for i, n in enumerate(trainable)}
        own = list(self.trainable)

        def part(name, t):
            if not (torch.is_tensor(t) and t.dim() > 0):
                return t
            return part_of_whole(t, name, self.model).to(self.device)
        for name, p in self.trainable.items():
            p.copy_(part(name, trainable[name]))
        group = {k: v for k, v in optimizer["param_groups"][0].items()
                 if k != "params"}
        self.opt.load_state_dict({
            "state": {j: {k: part(n, t) for k, t in
                          optimizer["state"][index[n]].items()}
                      for j, n in enumerate(own)
                      if index[n] in optimizer["state"]},
            "param_groups": [dict(group, params=list(range(len(own))))]})


def _start_pipe(args):
    """(this rank's device, its pipe mesh): the process group opened from
    torchrun's environment (or by the caller) for pipe x data > 1."""
    from ..parallel import distributed
    from ..parallel.pipeline import make_pipe_mesh, single_pipe
    device = torch.device(args.device)
    S, D = args.pipe_stages, max(1, args.mesh_data)
    if S * D == 1:
        return device, single_pipe()
    distributed.initialize(device)
    device = distributed.rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device, make_pipe_mesh(S, data=D)


def _pipe_model(args, cfg, pipe, device, dtype, log):
    """(this rank's ``StageDiT``, the encoder pipeline or None): seeded
    (--synthetic), else the plain DiT's blocks of this stage from the
    shards and umT5, CLIP and the VAE of the same checkpoint directory."""
    from ..training.pp import build_stage_dit
    if args.synthetic:
        return build_stage_dit(cfg, pipe, device=device, dtype=dtype,
                               seed=args.seed), None
    from ..convert.checkpoint import (dit_shards, load_into, load_pipeline,
                                      missing_files, plain_dit_state_dict)
    if not dit_shards(args.wan_ckpt_path):
        raise SystemExit(f"no DiT shards under {args.wan_ckpt_path}")
    encoders = ("t5", "clip", "vae")
    missing = missing_files(args.wan_ckpt_path, None, encoders)
    if missing:
        raise SystemExit("checkpoint files missing: " + ", ".join(missing))
    t0 = time.perf_counter()
    enc = load_pipeline(args.wan_ckpt_path, None, device=device, dtype=dtype,
                        tokenizer_path=args.tokenizer_path,
                        components=encoders)
    model = build_stage_dit(cfg, pipe, device=device, dtype=dtype)
    load_into(model, plain_dit_state_dict(args.wan_ckpt_path, cfg,
                                          model.state_dict()), "dit")
    log.info("loaded the encoders and blocks %s of %s in %.1fs",
             ",".join(model.blocks), args.wan_ckpt_path,
             time.perf_counter() - t0)
    return model, enc


def _run_pipe(args, device, pipe, log) -> Optional[float]:
    """--pipe_stages S: the GPipe trainer of the plain video DiT
    (``training/pp.py``) on this rank's stage."""
    from ..training.pp import make_pp_train_step

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = _pipe_config(args)
    model, enc = _pipe_model(args, cfg, pipe, device, dtype, log)
    S, D, M = pipe.stages, pipe.inner.size("data"), args.pipe_microbatches
    log.info("PP trainer: %d blocks over %d stages x data=%d, "
             "M=%d microbatches (bubble %.0f%%), batch %d",
             cfg.num_layers, S, D, M, 100 * (S - 1) / (M + S - 1), M * D)
    trainable = dict(model.named_parameters())
    opt, sched = _optimizer(args, list(trainable.values()))
    run = _PipeRun(trainable, opt, sched, model, pipe)
    start, saved = _resume_state(args, run, log)
    if start >= args.steps:
        print(f"train done: checkpoint already at step {start} "
              f">= --steps {args.steps}")
        return None
    step_fn = make_pp_train_step(model, opt, sched, pipe=pipe,
                                 microbatches=M, remat=not args.no_remat)
    if enc is None:
        batches = _pp_batches(cfg, args, device)
        for _ in range(start):          # a resumed run continues the stream
            next(batches)
    else:
        batches = _pp_data_batches(
            enc, args, int(saved.get("data_position", start * M * D)))
    loss_val = _train_loop(args, step_fn, batches, run, start, log)
    where = "" if pipe.world == 1 else (
        f" on {pipe.world} ranks (pipe {S} x data {D})")
    print(f"train done: {args.steps - start} step(s){where}, final loss "
          f"{loss_val:.5f}")
    return loss_val


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
    if args.pipe_stages > 0:
        device, pipe = _start_pipe(args)
        ranks = pipe.world
    else:
        device, mesh = start_mesh(args)
        ranks = 1 if mesh is None else mesh.world
    try:
        if args.pipe_stages > 0:
            return _run_pipe(args, device, pipe, log)
        return _run(args, device, mesh, log)
    finally:
        if ranks > 1 and opened:
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
