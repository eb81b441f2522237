"""GPipe pipeline parallelism over a 'pipe' axis (``parallel/pipeline.py``).

The JAX package runs the pipeline as one SPMD program: a ``shard_map`` over
'pipe' holds each stage's L/S blocks, a ``lax.scan`` runs T = M + S - 1
ticks, every stage's output hops to the next stage with one ``ppermute``
a tick, and ``jax.grad`` transposes the schedule. Here each rank is one
stage of one process group, and the schedule is written out:

  * ``make_pipe_mesh(stages, data, seq, model)``: the ranks as a (pipe,
    data, seq, model) grid, 'pipe' the outer axis (JAX's ``devs.reshape(S,
    D)``), so stage s holds ranks s * n .. s * n + n - 1 of n = data * seq
    * model. A rank gets its pipe group (the ranks of every stage with its
    inner coordinates) and the ``sharding.Mesh`` of its stage's ranks.
    Every rank builds every stage's groups, in one order;
  * ``pipeline_apply``: at tick t stage 0 injects microbatch t while
    t < M, stage s runs microbatch t - s, stage S - 1 keeps its result once
    t >= S - 1, and every rank takes part in the tick's hop to the next
    stage (``distributed.RingShift(to="next")``): on ranks that share a
    card each hop is an exchange of the whole group, as JAX's ``ppermute``
    is, so a rank outside its window sends zeros and runs nothing -- the
    bubble computes no garbage. Each stage's work on a microbatch is a graph
    of its own, from a detached input: the backward runs the T ticks in
    reverse, each stage backpropagating a microbatch's output gradient
    (the last stage's from the caller, the others' from the next stage) and
    hopping its input's gradient to the previous stage (the mirror hop,
    ``RingShift(to="previous")``). The stage's parameter gradients
    accumulate in ``.grad``; the input's and the per-microbatch arguments'
    gradients go back through autograd. With per-block recompute inside
    the stage (``pipeline_dit_blocks``) the activations kept between the
    passes are M x (L/S) block inputs. JAX replicates the result over the
    stages with a psum; here it stays on the last stage, where the
    trainer's head and loss run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from .distributed import RingShift, broadcast_object, broadcast_tensors
from .sharding import Axis, Mesh, single


@dataclasses.dataclass(frozen=True)
class PipeMesh:
    """This rank's view of a pipe x (data x seq x model) mesh: the pipe
    axis (its group holds this rank's counterparts in every stage), the
    mesh of its stage's ranks, and its rank in the default group."""
    pipe: Axis
    inner: Mesh
    rank: int

    @property
    def stages(self) -> int:
        return self.pipe.size

    @property
    def stage(self) -> int:
        return self.pipe.index

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1

    @property
    def world(self) -> int:
        return self.stages * self.inner.world


def single_pipe() -> PipeMesh:
    """One stage in one process."""
    return PipeMesh(Axis(None, 1, 0), single(), 0)


def _groups(grid: np.ndarray, axis: int, me: int):
    """One process group per line of ``grid`` along ``axis`` (made by every
    rank, in one order); this rank's, or None when the axis has one
    rank."""
    size = grid.shape[axis]
    if size == 1:
        return None
    mine = None
    for ranks in np.moveaxis(grid, axis, -1).reshape(-1, size):
        group = dist.new_group([int(r) for r in ranks])
        if me in ranks:
            mine = group
    return mine


def make_pipe_mesh(stages: int, data: int = 1, seq: int = 1,
                   model: int = 1) -> PipeMesh:
    """The pipe mesh over the default process group, whose world size must
    be stages * data * seq * model (1 needs no process group). Every rank
    calls it."""
    shape = (stages, data, seq, model)
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"a pipe {stages} x {data}x{seq}x{model} mesh needs "
                         f"{n} ranks; the process group has {world}")
    me = dist.get_rank() if dist.is_initialized() else 0
    grid = np.arange(n).reshape(shape)
    coords = np.unravel_index(me, shape)
    inner_axes = tuple(Axis(_groups(grid, a, me), shape[a], int(coords[a]))
                       for a in (1, 2, 3))
    inner = Mesh(shape[1:], int(np.ravel_multi_index(coords[1:], shape[1:])),
                 inner_axes)
    pipe = Axis(_groups(grid, 0, me), stages, int(coords[0]))
    return PipeMesh(pipe, inner, me)


def stage_range(num_layers: int, pipe: PipeMesh) -> range:
    """The blocks of this rank's stage: the contiguous L/S of them."""
    if num_layers % pipe.stages:
        raise ValueError(f"stack of {num_layers} blocks not divisible by "
                         f"{pipe.stages} stages")
    per = num_layers // pipe.stages
    return range(pipe.stage * per, (pipe.stage + 1) * per)


class _Pipeline(torch.autograd.Function):
    """The GPipe forward over T ticks and its backward over T ticks in
    reverse (module docstring). ``anchor`` is an empty tensor that
    requires grad where the stage's parameters do, so that the backward
    runs even when no other input needs a gradient."""

    @staticmethod
    def forward(ctx, stage_fn, modules, static_args, pipe, M, anchor, x,
                *per_mb):
        S, s = pipe.stages, pipe.stage
        if x.shape[0] % M:
            raise ValueError(f"batch {x.shape[0]} does not split into {M} "
                             f"microbatches")
        Bm = x.shape[0] // M
        train = any(ctx.needs_input_grad)
        xs = x.split(Bm)
        args = [a.split(Bm) for a in per_mb]
        saved, outs = [None] * M, [None] * M
        zeros = xs[0].new_zeros(xs[0].shape)
        recv = None
        for t in range(M + S - 1):
            m = t - s
            send = zeros
            if 0 <= m < M:
                inp = (xs[m] if s == 0 else recv).detach()
                mb = [a[m].detach() for a in args]
                if train:
                    inp.requires_grad_(x.requires_grad or s > 0)
                    for a, whole in zip(mb, per_mb):
                        a.requires_grad_(whole.requires_grad)
                with torch.set_grad_enabled(train):
                    y = stage_fn(modules, inp, *mb, *static_args)
                if y.shape != inp.shape or y.dtype != inp.dtype:
                    raise ValueError(f"a stage must keep its input's shape "
                                     f"and dtype: {tuple(inp.shape)} "
                                     f"{inp.dtype} -> {tuple(y.shape)} "
                                     f"{y.dtype}")
                if train:
                    saved[m] = (inp, mb, y)
                send = y.detach()
                if s == S - 1:
                    outs[m] = send
            if S > 1 and t < M + S - 2:
                recv = RingShift(send, pipe.pipe.group, "next").wait()
        ctx.pipe, ctx.M, ctx.saved, ctx.Bm = pipe, M, saved, Bm
        ctx.act = (tuple(zeros.shape), zeros.dtype, zeros.device)
        ctx.x_grad = x.requires_grad
        ctx.arg_grads = [a.requires_grad for a in per_mb]
        return torch.cat(outs) if s == S - 1 else x.new_zeros(0)

    @staticmethod
    def backward(ctx, grad_out):
        pipe, M, Bm, saved = ctx.pipe, ctx.M, ctx.Bm, ctx.saved
        S, s = pipe.stages, pipe.stage
        g_out = grad_out.split(Bm) if s == S - 1 else None
        x_grads = [None] * M
        arg_grads = [[None] * M for _ in ctx.arg_grads]
        shape, dtype, device = ctx.act
        zeros = torch.zeros(shape, dtype=dtype, device=device)
        pending = None
        for t in reversed(range(M + S - 1)):
            m = t - s
            send = zeros
            if 0 <= m < M:
                inp, mb, y = saved[m]
                saved[m] = None
                g = g_out[m] if s == S - 1 else pending
                with torch.enable_grad():
                    torch.autograd.backward(y, g.contiguous())
                if inp.grad is not None:
                    send = x_grads[m] = inp.grad
                for j, a in enumerate(mb):
                    if ctx.arg_grads[j]:
                        arg_grads[j][m] = (a.grad if a.grad is not None
                                           else torch.zeros_like(a))
            if S > 1 and t > 0:
                pending = RingShift(send, pipe.pipe.group, "previous").wait()
        ctx.saved = None
        dx = None
        if ctx.x_grad and s == 0:
            dx = torch.cat(x_grads)
        dargs = [torch.cat(g) if need else None
                 for g, need in zip(arg_grads, ctx.arg_grads)]
        return (None, None, None, None, None, None, dx, *dargs)


def pipeline_apply(stage_fn: Callable, stage_modules: nn.Module,
                   x: torch.Tensor, per_mb_args: Sequence = (),
                   static_args: Sequence = (), *, pipe: PipeMesh,
                   microbatches: int) -> torch.Tensor:
    """Run ``x`` through the blocks of every stage, this rank's being
    ``stage_modules`` (JAX ``pipeline_apply``).

    ``stage_fn(stage_modules, h, *per_mb, *static) -> h`` applies this
    stage's blocks to one microbatch and keeps h's shape and dtype. ``x``
    (B, ...) with B % microbatches == 0, the same on every stage (stage 0
    reads it). ``per_mb_args``: tensors with leading batch dim B, sliced
    with each microbatch (context, t_mod); ``static_args`` are passed whole
    (the RoPE tables). Every rank of the pipe group calls it.

    Returns the output (B, ...) on the last stage and an empty tensor on
    the others. Differentiable: every rank of the pipe group backpropagates
    from its result (the empty one too: that starts its part of the
    backward schedule); x's gradient arrives on stage 0 (zeros elsewhere),
    the per-microbatch arguments' on every stage (each its own blocks'
    part), and the stage's parameters accumulate theirs."""
    params = [p for p in stage_modules.parameters() if p.requires_grad]
    anchor = x.new_empty(0).requires_grad_(
        torch.is_grad_enabled() and bool(params))
    return _Pipeline.apply(stage_fn, stage_modules, tuple(static_args), pipe,
                           int(microbatches), anchor, x, *per_mb_args)


def pipeline_dit_blocks(blocks: nn.Module, x: torch.Tensor,
                        context: torch.Tensor, t_mod: torch.Tensor,
                        rope_cos: torch.Tensor, rope_sin: torch.Tensor, *,
                        pipe: PipeMesh, microbatches: int,
                        remat: bool = False, seq=None) -> torch.Tensor:
    """The Wan DiT block stack as a GPipe pipeline (JAX
    ``pipeline_dit_blocks``): ``blocks`` are this stage's ``DiTBlock``s in
    order, each run on a microbatch of tokens with its context and t_mod;
    the RoPE tables of x's tokens go whole to every block. ``seq``: x's
    token split over the stage's seq group (``sharding.TokenSplit``),
    which each block's self-attention takes -- the Ulysses context the
    call runs in goes with it, into the recompute too. ``remat``: each
    block is recomputed on the backward, so a stage keeps only its blocks'
    inputs (with the checkpoint's early stop off where the blocks are
    split over the model or the seq group: every rank of the group then
    reissues each collective)."""
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

    from .ulysses import current_ulysses, ulysses_context
    uly = current_ulysses()

    def run(blk, h, ctx_mb, tmod_mb):
        with ulysses_context(uly):
            return blk(h, ctx_mb, tmod_mb, rope_cos, rope_sin, seq=seq)

    def stage(mods, h, ctx_mb, tmod_mb):
        split = (seq is not None and seq.n > 1) or any(
            getattr(b, "tp", None) is not None for b in mods)
        with set_checkpoint_early_stop(not split):
            for blk in mods:
                if remat:
                    h = checkpoint(run, blk, h, ctx_mb, tmod_mb,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    h = run(blk, h, ctx_mb, tmod_mb)
        return h

    mods = nn.ModuleList(list(blocks.values()) if isinstance(
        blocks, nn.ModuleDict) else list(blocks))
    return pipeline_apply(stage, mods, x, (context, t_mod), pipe=pipe,
                          microbatches=microbatches)


def gather_stages(entries: dict, pipe: PipeMesh, device) -> Optional[dict]:
    """Every stage's ``entries`` ({name: tensor}, each stage its own
    names), in stage order, as CPU tensors on stage 0; None on the other
    stages. Every rank of the pipe group calls it; one tensor crosses at a
    time."""
    if pipe.stages == 1:
        return {n: t.cpu() for n, t in entries.items()}
    group = pipe.pipe.group
    out = {}
    for s in range(pipe.stages):
        src = dist.get_global_rank(group, s)
        mine = pipe.stage == s
        names = broadcast_object(list(entries) if mine else None, src=src,
                                 group=group)
        for name in names:
            (t,) = broadcast_tensors([entries[name] if mine else None],
                                     src=src, group=group, device=device)
            if pipe.stage == 0:
                out[name] = t.cpu()
    return out if pipe.stage == 0 else None
