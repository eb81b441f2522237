"""FantasyWorld fusion model (``models/fusion/model.py``): the Wan DiT and
the VGGT geometry stream denoised jointly.

Blocks 0..start_index-1 of the DiT are preconditioning blocks (PCB); each
later block is paired with a VGGT frame + global block in an IRG block,
coupled by bidirectional cross-modal attention. The JAX package scans
leaf-stacked block trees; here the per-layer ``nn.ModuleList``s are walked
in a Python loop. CFG runs as one batch of two.

``remat`` recomputes each PCB block, and each IRG body as one unit (frame
block, both attention halves, bicross, both FFN halves), on the backward
pass -- the granularity of the JAX package's per-block ``jax.checkpoint``
-- so training keeps only the block inputs alive between the forward and
the backward.

State-dict layout: ``dit.*`` (WanModel names), ``vggt.*`` (VGGT names, the
IRG global blocks in ``vggt.aggregator.global_blocks``), ``bicross.{i}.*``.

On a mesh (``parallel/sharding.py``; ``shard`` splits the DiT over the
model axis) ``joint_forward(mesh=...)`` takes the whole inputs on every
rank and returns the whole noise prediction on every rank: each rank runs
its rows of the batch ('data', where it divides) and its latent frames
('seq') of both token streams through the prologue's output, the block
stack and the DiT head; the long attentions gather or re-shard their keys
(``ulysses``), and the head's tokens and the intermediates the geometry
heads read are gathered after. The geometry heads run on rank 0 alone,
which gets the prediction (None elsewhere).

Training on a mesh differentiates ``joint_forward`` end to end: every rank
computes the same loss on the whole gathered noise prediction, so the
head's gathers pass each rank's part of that gradient back, and the
collectives inside the blocks have the backwards of
``parallel/distributed.py``; ``parallel.sharding.reduce_gradients`` then
sums each rank's parameter gradients over the mesh. The block stack has
no rank-dependent branch, so a block recomputed on the backward reissues
the same collectives on every rank.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ...ops import rope as rope_ops
from ...parallel import sharding
from ..vggt.model import VGGT, VGGTConfig
from ..wan.dit import WanDiT, WanDiTConfig
from .bicross import Bicross, BicrossConfig


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    dit: WanDiTConfig = WanDiTConfig(camera_adapter_end=25)
    vggt: VGGTConfig = VGGTConfig()
    bicross: BicrossConfig = BicrossConfig()
    start_index: int = 16
    camera_control: bool = True
    cross_attention_list: Optional[Tuple[int, ...]] = None

    @property
    def num_irg(self) -> int:
        return self.dit.num_layers - self.start_index

    def xattn_set(self) -> frozenset:
        if self.cross_attention_list is None:
            return frozenset(range(self.num_irg))
        return frozenset(self.cross_attention_list)


def _run(fn, *args, remat: bool):
    """fn(*args), recomputed on the backward pass under ``remat``. The
    blocks draw no random numbers, so no RNG state is kept. The recompute
    re-enters the Ulysses context the block ran in (the backward runs
    outside it, on another thread on the card) and, on a mesh, runs the
    whole block: it reissues the block's collectives, and every rank must
    reissue all of them, in the same order."""
    if not remat:
        return fn(*args)
    from ...parallel.ulysses import current_ulysses, ulysses_context
    ctx = current_ulysses()

    def again(*a):
        with ulysses_context(ctx):
            return fn(*a)

    return checkpoint(again, *args, use_reentrant=False,
                      preserve_rng_state=False)


class FusionModel(nn.Module):
    def __init__(self, cfg: FusionConfig):
        super().__init__()
        self.cfg = cfg
        self.dit = WanDiT(cfg.dit)
        self.vggt = VGGT(cfg.vggt)
        self.bicross = nn.ModuleList([Bicross(cfg.bicross)
                                      for _ in range(cfg.num_irg)])

    def shard(self, mesh) -> "FusionModel":
        """Keep this rank's column / row parts of the DiT's projections
        (``sharding.PARAM_RULES``) and give the blocks the model group; in
        place, on any device (the meta device included), once (a model
        built sharded, ``core.params.build(mesh=...)``, is left as it is).
        The heads and the FFN width must divide by the model axis."""
        axis = mesh.axis("model")
        if axis.size == 1 or self.dit.blocks[0].tp is not None:
            return self
        dcfg = self.cfg.dit
        if dcfg.num_heads % axis.size or dcfg.ffn_dim % axis.size:
            raise ValueError(f"{dcfg.num_heads} heads and an FFN of "
                             f"{dcfg.ffn_dim} do not split over "
                             f"{axis.size} model ranks")
        sharding.shard_module_(self, mesh)
        for blk in self.dit.blocks:
            blk.set_tensor_parallel(axis)
        return self

    def forward_prologue(self, latents, timestep, context, clip_feature, y,
                         control_tokens=None):
        """Embeddings, patchify (plus the control-camera tokens) and the
        three RoPE tables."""
        cfg, dit = self.cfg, self.dit
        t, t_mod = dit.time_embed(timestep)
        ctx = dit.text_embed(context)
        x_in = latents
        if cfg.dit.require_vae_embedding and y is not None:
            x_in = torch.cat([latents, y], dim=1)
        if cfg.dit.has_image_input and clip_feature is not None:
            ctx = torch.cat([dit.img_emb(clip_feature), ctx], dim=1)
        x, (f, h, w) = dit.patchify(x_in, control_tokens)
        dev = x.device
        ropes = rope_ops.cos_sin_half_from_angles(
            rope_ops.build_angles_3d(cfg.dit.head_dim, f, h, w), dev)
        rope_bi_dit = rope_ops.cos_sin_half_from_angles(
            rope_ops.build_angles_3d(cfg.bicross.head_dim, f, h, w), dev)
        rope_bi_agg = rope_ops.cos_sin_half_from_angles(
            rope_ops.build_angles_3d(
                cfg.bicross.head_dim, f, h, w,
                n_extra_per_frame=cfg.vggt.aggregator.patch_start_idx), dev)
        return x, ctx, t, t_mod, (f, h, w), ropes, rope_bi_dit, rope_bi_agg

    def run_stack(self, x, ctx, t_mod, timestep, ropes, rope_bi_dit,
                  rope_bi_agg, fhw, plucker_fea, collect_inters: bool,
                  remat: bool = False, camera_token=None,
                  uncond: bool = False, frames=None, inter_layers=None):
        """PCB prefix, geometry branch input, interleaved IRG loop. Returns
        (x, per-layer (B, S, P, 2C) intermediates | None).
        ``camera_token``: pose encodings for the geometry stream's camera
        slots; ``uncond``: the IRG blocks skip their bicross coupling.
        ``frames``: the latent frames' split over the seq group (x, the
        tables and the Plucker features then hold this rank's frames, and
        fhw its frame count); ``inter_layers``: the layers whose
        intermediates are kept (all when None; the others are None)."""
        cfg = self.cfg
        f, h, w = fhw
        B = x.shape[0]
        cos_d, sin_d = ropes
        apply_pose = cfg.camera_control and plucker_fea is not None
        if (apply_pose and cfg.dit.camera_adapter_end > 0
                and cfg.dit.pose_inject_method == "latent_split"):
            # the stack passes no latent frame count to its blocks, as in
            # the JAX package, whose latent_split reshape fails there
            raise ValueError(
                "latent_split pose injection does not run in the fusion "
                "model: its blocks get no latent frame count (the JAX "
                "fusion stack fails the same way); use latent_overall, "
                "adaln, or the standalone WanDiT")
        blocks = self.dit.blocks
        si = cfg.start_index
        psi = cfg.vggt.aggregator.patch_start_idx
        s_dit = s_agg = None
        if frames is not None:
            s_dit, s_agg = frames.scaled(h * w), frames.scaled(h * w + psi)

        for i in range(si):
            x = _run(functools.partial(
                blocks[i], context=ctx, t_mod=t_mod, rope_cos=cos_d,
                rope_sin=sin_d, plucker_fea=plucker_fea,
                apply_pose=apply_pose and cfg.dit.has_adapter(i),
                seq=s_dit), x, remat=remat)

        agg = self.vggt.aggregator
        patch_tokens, e0 = self.vggt.process_wan_input(
            x.view(B, f, h, w, cfg.dit.dim), timestep)
        tokens, pos = agg.assemble_tokens(
            patch_tokens, camera_token,
            None if frames is None else (frames.start, frames.length))
        S = f
        P, C = tokens.shape[-2:]
        bcfg = cfg.vggt.aggregator.block_cfg
        rope_f = rope_g = None
        if bcfg.rope_frequency > 0:
            # positions are static: one table gather for the whole stack
            rope_f = rope_ops.rope2d_tables_from_positions(
                pos, bcfg.head_dim, frequency=bcfg.rope_frequency)
            rope_g = tuple(t.reshape(B, S * P, 1, t.shape[-1])
                           for t in rope_f)

        xattn = cfg.xattn_set()

        def irg_body(i, x, tokens):
            dblk, gblk = blocks[si + i], agg.global_blocks[i]
            has_ad = apply_pose and cfg.dit.has_adapter(si + i)
            tokens = agg.frame_blocks[i](tokens.view(B * S, P, C), rope_f, e0)
            frame_inter = tokens.view(B, S, P, C)
            x_agg = tokens.view(B, S * P, C)
            if i in xattn:
                x, mod_dit = dblk.attn_half(x, ctx, t_mod, cos_d, sin_d,
                                            plucker_fea=plucker_fea,
                                            apply_pose=has_ad, seq=s_dit)
                x_agg, mod_agg = gblk.attn_half(x_agg, rope_g, e0, s_agg)
                if not uncond:
                    x, x_agg = self.bicross[i](x, x_agg, rope_bi_dit,
                                               rope_bi_agg, (s_dit, s_agg))
                x = dblk.ffn_half(x, mod_dit)
                x_agg = gblk.ffn_half(x_agg, mod_agg)
            else:
                x = dblk(x, ctx, t_mod, cos_d, sin_d,
                         plucker_fea=plucker_fea, apply_pose=has_ad,
                         seq=s_dit)
                x_agg = gblk(x_agg, rope_g, e0, s_agg)
            keep = collect_inters and (inter_layers is None
                                       or i in inter_layers)
            inter = (torch.cat([frame_inter, x_agg.view(B, S, P, C)], dim=-1)
                     if keep else None)
            return x, x_agg, inter

        inters: List[torch.Tensor] = []
        for i in range(cfg.num_irg):
            x, tokens, inter = _run(functools.partial(irg_body, i), x,
                                    tokens, remat=remat)
            if collect_inters:
                inters.append(inter)
        return x, (inters if collect_inters else None)

    def joint_forward(self, latents, timestep, context, clip_feature=None,
                      y=None, plucker_fea=None, return_prediction=False,
                      remat=False, control_tokens=None, camera_token=None,
                      uncond: bool = False, mesh=None, ulysses: bool = False):
        """One denoise evaluation. latents (B, 16, f, h', w'); timestep
        (B,); context (B, 512, text_dim); clip_feature (B, 257, 1280);
        y (B, 20, f, h', w'); plucker_fea (B, L, plucker_dim);
        control_tokens (1 or B, L, dim), the Wan2.2 control-camera adapter's
        output (``WanDiT.control_adapter_tokens``); camera_token (B, 4f - 3,
        9) pose encodings, projected into the geometry stream's camera
        slots (``Aggregator.assemble_tokens``); ``uncond``: the IRG blocks
        run without their bicross coupling.
        Returns (noise_pred (B, 16, f, h', w'), prediction dict | None).
        ``remat``: recompute each block on the backward pass.

        ``mesh``: a ``parallel.sharding.Mesh`` over which the model is
        sharded (``shard``; None is one process): the whole inputs on every
        rank, the whole noise prediction on every rank, the prediction on
        rank 0 (None on the others). ``ulysses``: the attentions whose keys
        are split over the seq group re-shard through Ulysses (or the ring)
        instead of gathering their keys."""
        from torch.utils.checkpoint import set_checkpoint_early_stop

        from ...parallel.ulysses import ulysses_context
        mesh = mesh or sharding.single()
        p = self._mesh_prologue(latents, timestep, context, clip_feature, y,
                                plucker_fea, control_tokens, mesh)
        keep = self.head_layers() if return_prediction else None
        with ulysses_context(mesh if ulysses else None), \
                set_checkpoint_early_stop(mesh.trivial):
            x, inters = self.run_stack(
                p.x, p.ctx, p.t_mod, p.timestep, p.ropes, p.rope_bi_dit,
                p.rope_bi_agg, p.local_fhw, p.plucker_fea, return_prediction,
                remat, p.mine(camera_token), uncond, p.frames, keep)
        noise_pred = self._mesh_head(x, p, mesh)
        if not return_prediction:
            return noise_pred, None
        inters = [None if i not in keep else sharding.gather_rows(
            p.frames.gather(inter, 1), p.rows, mesh)
            for i, inter in enumerate(inters)]
        if mesh.rank != 0:
            return noise_pred, None
        _, h, w = p.fhw
        return noise_pred, self.vggt.head_prediction(
            inters, (h, w), self.cfg.vggt.aggregator.patch_start_idx)

    def _mesh_prologue(self, latents, timestep, context, clip_feature, y,
                       plucker_fea, control_tokens, mesh):
        """The prologue on this rank's rows ('data') and the DiT tokens, the
        RoPE tables and the Plucker features of its frames ('seq')."""
        rows = sharding.batch_rows(latents.shape[0], mesh)
        B = latents.shape[0]

        def mine(t):
            return (t if t is None or t.shape[0] != B
                    else sharding.take_rows(t, rows))

        (x, ctx, t, t_mod, (f, h, w), ropes, rope_bi_dit, rope_bi_agg) = \
            self.forward_prologue(mine(latents), mine(timestep),
                                  mine(context), mine(clip_feature), mine(y),
                                  mine(control_tokens))
        frames = sharding.frame_split(f, mesh)
        s_dit = frames.scaled(h * w)
        s_agg = frames.scaled(h * w + self.cfg.vggt.aggregator.patch_start_idx)
        return _Prologue(
            x=s_dit.take(x), ctx=ctx, t=t, t_mod=t_mod, fhw=(f, h, w),
            local_fhw=(frames.local, h, w),
            ropes=tuple(s_dit.take(r, 0) for r in ropes),
            rope_bi_dit=tuple(s_dit.take(r, 0) for r in rope_bi_dit),
            rope_bi_agg=tuple(s_agg.take(r, 0) for r in rope_bi_agg),
            plucker_fea=(None if plucker_fea is None
                         else s_dit.take(mine(plucker_fea))),
            timestep=mine(timestep), rows=rows, frames=frames, s_dit=s_dit,
            mine=mine)

    def _mesh_head(self, x, p, mesh):
        """The DiT head on this rank's tokens, the whole batch's tokens
        gathered, unpatchified. Every rank goes on alike from the whole
        prediction (a loss, a scheduler step), so each gather's backward
        keeps this rank's part of its gradient."""
        out = sharding.gather_rows(
            p.s_dit.gather(self.dit.head(x, p.t), grad="slice"), p.rows,
            mesh, grad="slice")
        return self.dit.unpatchify(out, p.fhw)

    def head_layers(self) -> frozenset:
        """The IRG layers whose intermediates the geometry heads read."""
        n, vcfg = self.cfg.num_irg, self.cfg.vggt
        return frozenset({0, n - 1} | {i % n for i in vcfg.dpt_layer_idx})

    def joint_forward_tea(self, latents, timestep, context, clip_feature=None,
                          y=None, plucker_fea=None, skip: bool = False,
                          residual=None, control_tokens=None, mesh=None,
                          ulysses: bool = False):
        """The TeaCache-gated evaluation (``joint_forward_tea``): ``skip``
        replaces the PCB + IRG stack by ``x + residual``; otherwise the
        stack runs and its output minus its input is the new residual.
        Returns (noise_pred, residual). The geometry heads do not run here:
        the last step always computes, through ``joint_forward``.

        ``mesh`` / ``ulysses`` as in ``joint_forward``: the whole noise
        prediction on every rank. The residual is this rank's part of the
        (B, f*h*w, dim) stack residual -- its rows and its frames' tokens
        (``parallel.sharding.token_split``) -- as both branches keep it
        where the tokens are, so the carried residual never moves."""
        from ...parallel.ulysses import ulysses_context
        mesh = mesh or sharding.single()
        p = self._mesh_prologue(latents, timestep, context, clip_feature, y,
                                plucker_fea, control_tokens, mesh)
        if skip:
            x = p.x + residual
        else:
            with ulysses_context(mesh if ulysses else None):
                x, _ = self.run_stack(
                    p.x, p.ctx, p.t_mod, p.timestep, p.ropes, p.rope_bi_dit,
                    p.rope_bi_agg, p.local_fhw, p.plucker_fea, False,
                    frames=p.frames)
            residual = x - p.x
        return self._mesh_head(x, p, mesh), residual


@dataclasses.dataclass
class _Prologue:
    """``FusionModel._mesh_prologue``'s output: this rank's part of the
    stack's inputs and where it lies."""
    x: torch.Tensor
    ctx: torch.Tensor
    t: torch.Tensor
    t_mod: torch.Tensor
    fhw: Tuple[int, int, int]
    local_fhw: Tuple[int, int, int]
    ropes: tuple
    rope_bi_dit: tuple
    rope_bi_agg: tuple
    plucker_fea: Optional[torch.Tensor]
    timestep: torch.Tensor
    rows: Optional[slice]
    frames: object
    s_dit: object
    mine: object
