"""Pipeline-parallel flow-matching training of the plain Wan video DiT
(``training/pp.py``).

The plain DiT is a homogeneous block stack (the fusion model's PCB/IRG mix
is not), so the blocks themselves split over a 'pipe' axis: each rank
builds the whole embeddings and head (``lite``) and only its stage's
contiguous L/S blocks (``StageDiT``), and microbatches march through the
stages (``parallel/pipeline.py``). That divides the blocks' weights,
gradients and AdamW moments by the stage count: at full width a block
holds 403.8M parameters, lite 241M.

The step (``make_pp_train_step``): every rank runs the embeddings on its
rows of the whole batch, the pipeline runs the blocks, the last stage runs
the head and the f32 MSE, and the loss reaches every rank. Lite's gradient
comes from every stage -- the patch embedding's through stage 0's input,
the text and time embeddings' through each stage's context and t_mod, the
time embedding's also through the head on the last stage -- so after the
backward the stage's gradients are summed over its data ranks (each took
its rows, a 1/D share of the loss) and lite's over the pipe group; every
stage then takes the same AdamW step on lite, which stays bit-equal
everywhere. On a ('pipe', 'model') mesh a stage's blocks take the
megatron splits of ``parallel/sharding.py`` (``StageDiT.shard``). On a
stage mesh with seq ranks the latent frames split over 'seq' as in the
fusion forward (``sharding.frame_split``): a rank's microbatches enter the
pipeline as its frames' tokens (a hop joins ranks of one seq index, so
every hop carries one shape even where the frames split unevenly), the
self-attention goes through ``parallel/ulysses.py`` (the gather, or
Ulysses / the ring under ``ulysses``), the cross-attentions keep the whole
text and CLIP keys, and the last stage runs the head on the rank's tokens
before it gathers the prediction. Each rank's gradients are then its
frames' share, which ``sharding.reduce_gradients`` sums over 'seq'.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.params import build, init_params_
from ..models.wan.dit import WanDiT, WanDiTConfig
from ..ops import rope as rope_ops
from ..parallel import sharding
from ..parallel.distributed import all_reduce_sum
from ..parallel.pipeline import PipeMesh, pipeline_dit_blocks, stage_range

HETEROGENEOUS = ("pipeline training needs a homogeneous block stack; this "
                 "config has per-layer structural differences (e.g. camera "
                 "adapters)")


class StageDiT(WanDiT):
    """The ``WanDiT`` of one pipeline stage: the whole lite and the blocks
    ``blocks`` (a range of layer indices), kept under their one-process
    names (``blocks.{i}.*``, an ``nn.ModuleDict``), so its state dict is
    the part of the plain DiT's that the stage holds."""

    def __init__(self, cfg: WanDiTConfig, blocks: range):
        super().__init__(cfg)
        self.blocks = nn.ModuleDict({str(i): self.blocks[i] for i in blocks})

    def shard(self, mesh) -> "StageDiT":
        """Keep this rank's column / row parts of the blocks' projections
        (``sharding.PARAM_RULES``; lite matches no rule and stays whole)
        and give the blocks the model group; in place, once."""
        axis = mesh.axis("model")
        blocks = list(self.blocks.values())
        if axis.size == 1 or blocks[0].tp is not None:
            return self
        if self.cfg.num_heads % axis.size or self.cfg.ffn_dim % axis.size:
            raise ValueError(f"{self.cfg.num_heads} heads and an FFN of "
                             f"{self.cfg.ffn_dim} do not split over "
                             f"{axis.size} model ranks")
        sharding.shard_module_(self, mesh)
        for blk in blocks:
            blk.set_tensor_parallel(axis)
        return self


def _generator(device, seed: int, index: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(int(
        np.random.SeedSequence([seed, index]).generate_state(1)[0]))


@torch.no_grad()
def init_stage_(model: StageDiT, seed: int) -> StageDiT:
    """The seeded init of a stage: lite drawn from (seed, 0), block i from
    (seed, i + 1), so the values do not depend on the stage count (nor, as
    ``core.params`` draws a split tensor whole, on the model split)."""
    device = model.patch_embedding.weight.device
    lite = _generator(device, seed, 0)
    for name, child in model.named_children():
        if name != "blocks":
            init_params_(child, lite)
    for i, blk in model.blocks.items():
        init_params_(blk, _generator(device, seed, int(i) + 1))
    return model


def build_stage_dit(cfg: WanDiTConfig, pipe: PipeMesh, *, device,
                    dtype: torch.dtype, seed=None) -> StageDiT:
    """This rank's ``StageDiT`` built on ``device`` (meta first: a rank
    allocates only its stage, and only its part of it on a model split);
    seeded by ``init_stage_`` when ``seed`` is given, else uninitialised
    for a ``load_state_dict``."""
    inner = pipe.inner
    model = build(lambda: StageDiT(cfg, stage_range(cfg.num_layers, pipe)),
                  device=device, dtype=dtype,
                  mesh=inner if inner.size("model") > 1 else None)
    return model if seed is None else init_stage_(model, seed)


def split_dit_trainable(model: WanDiT) -> Tuple[Dict[str, nn.Parameter],
                                                List[nn.Module]]:
    """(lite, blocks): {name: parameter} of everything but the blocks, and
    the blocks the pipeline stage runs (JAX ``split_dit_trainable``). The
    stack must be homogeneous: a configuration whose blocks differ (the
    camera adapters on the first ``camera_adapter_end`` of them), or blocks
    of different parameters, raise ValueError."""
    cfg = model.cfg
    blocks = list(model.blocks.values() if isinstance(
        model.blocks, nn.ModuleDict) else model.blocks)
    shapes = [[(n, tuple(p.shape)) for n, p in b.named_parameters()]
              for b in blocks]
    if (len({cfg.has_adapter(i) for i in range(cfg.num_layers)}) > 1
            or any(s != shapes[0] for s in shapes[1:])):
        raise ValueError(HETEROGENEOUS)
    lite = {n: p for n, p in model.named_parameters()
            if not n.startswith("blocks.")}
    return lite, blocks


def pp_flow_match_loss(model: WanDiT, clean_latents: torch.Tensor,
                       noise: torch.Tensor, sigma, timestep: torch.Tensor,
                       context: torch.Tensor, clip_feature=None, y=None, *,
                       pipe: PipeMesh, microbatches: int,
                       remat: bool = False,
                       ulysses: bool = False) -> torch.Tensor:
    """The rectified-flow MSE of ``training/step.py`` with the DiT's blocks
    run as a GPipe pipeline (JAX ``pp_flow_match_loss``): noisy = (1 -
    sigma) clean + sigma noise, the embeddings, the pipelined blocks, the
    head, unpatchify, the f32 MSE against noise - clean. ``sigma`` is a
    scalar or a per-sample (B, 1, 1, 1, 1) tensor; ``clip_feature`` and
    ``y`` carry the i2v conditioning. Every rank passes the whole batch and
    runs its data rows of it, split into ``microbatches``, and its seq
    rank's latent frames; returns the whole batch's loss on every rank (the
    head and the MSE run on the last stage). ``remat``: per-block
    recompute inside the stage. ``ulysses``: on seq ranks, the
    self-attention re-shards heads (Ulysses, or the ring where the heads
    do not divide) instead of gathering the keys."""
    from ..parallel.ulysses import ulysses_context
    cfg = model.cfg
    dtype = model.patch_embedding.weight.dtype
    B = clean_latents.shape[0]
    data = pipe.inner.axis("data")
    rows = sharding.batch_rows(B, pipe.inner)
    if data.size > 1 and rows is None:
        raise ValueError(f"a batch of {B} does not split over {data.size} "
                         f"data ranks")

    def mine(t):
        return None if t is None else sharding.take_rows(t, rows)

    clean, noise = mine(clean_latents).float(), mine(noise).float()
    if isinstance(sigma, torch.Tensor):
        sigma = (mine(sigma) if sigma.dim() else sigma).float()
    x = ((1 - sigma) * clean + sigma * noise).to(dtype)
    t, t_mod = model.time_embed(mine(timestep).float())
    ctx = model.text_embed(mine(context).to(dtype))
    if y is not None and cfg.require_vae_embedding:
        x = torch.cat([x, mine(y).to(dtype)], dim=1)
    if clip_feature is not None and cfg.has_image_input:
        ctx = torch.cat([model.img_emb(mine(clip_feature).to(dtype)), ctx],
                        dim=1)
    tokens, grid = model.patchify(x)
    f, h, w = grid
    split = sharding.frame_split(f, pipe.inner).scaled(h * w)
    cos, sin = (split.take(r, 0) for r in rope_ops.cos_sin_half_from_angles(
        rope_ops.build_angles_3d(cfg.head_dim, f, h, w), tokens.device))
    with ulysses_context(pipe.inner if ulysses else None):
        out = pipeline_dit_blocks(model.blocks, split.take(tokens), ctx,
                                  t_mod, cos, sin, pipe=pipe,
                                  microbatches=microbatches, remat=remat,
                                  seq=split)
    if pipe.last:
        # the head on this rank's tokens: gathering first would give every
        # seq rank the whole head gradient, which the 'seq' sum multiplies
        pred = model.unpatchify(split.gather(model.head(out, t),
                                             grad="slice"), grid)
        # each data rank's rows are a 1/D share of the batch's mean; every
        # rank goes on from the sum, so its backward passes 1 to each share
        mse = torch.mean(torch.square(pred.float() - (noise - clean)))
        part = all_reduce_sum(mse / data.size, data.group, grad="identity")
    else:
        # an empty tensor: 0, and where this stage's backward starts
        part = out.float().sum()
    return all_reduce_sum(part, pipe.pipe.group, grad="identity")


def make_pp_train_step(model: WanDiT, optimizer: torch.optim.Optimizer,
                       lr_schedule=None, *, pipe: PipeMesh,
                       microbatches: int, remat: bool = True,
                       ulysses: bool = False
                       ) -> Callable[[Dict], torch.Tensor]:
    """Returns ``step(batch) -> loss`` (JAX ``make_pp_train_step``): the
    pipelined loss and its backward, the gradients reduced (the module
    docstring), one update of the parameters ``optimizer`` holds, one step
    of ``lr_schedule``. ``batch`` holds ``pp_flow_match_loss``'s keyword
    arguments, the whole batch on every rank; the loss returned is the
    whole batch's, the same on every rank. A parameter the rank's graph
    does not reach gets a zero gradient, so AdamW's weight decay still
    applies to it. ``ulysses``: as ``pp_flow_match_loss`` takes it."""
    lite, _ = split_dit_trainable(model)
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    named = {n: p for n, p in model.named_parameters() if id(p) in held}
    if len(named) != len(held):
        raise ValueError("the optimizer holds parameters that are not the "
                         "model's")
    lite_params = [p for n, p in sorted(named.items()) if n in lite]

    def train_step(batch: Dict) -> torch.Tensor:
        for p in named.values():
            p.grad = None
        loss = pp_flow_match_loss(model, pipe=pipe,
                                  microbatches=microbatches, remat=remat,
                                  ulysses=ulysses, **batch)
        loss.backward()
        for p in named.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        sharding.reduce_gradients(named, pipe.inner,
                                  batch["clean_latents"].shape[0])
        # last, so that every stage steps lite from the same bits
        sharding.flat_reduce([p.grad for p in lite_params], pipe.pipe.group)
        optimizer.step()
        if lr_schedule is not None:
            lr_schedule.step()
        return loss.detach()

    return train_step
