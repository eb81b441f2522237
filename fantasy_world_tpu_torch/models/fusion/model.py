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
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ...ops import rope as rope_ops
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
    blocks draw no random numbers, so no RNG state is kept."""
    if not remat:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


class FusionModel(nn.Module):
    def __init__(self, cfg: FusionConfig):
        super().__init__()
        self.cfg = cfg
        self.dit = WanDiT(cfg.dit)
        self.vggt = VGGT(cfg.vggt)
        self.bicross = nn.ModuleList([Bicross(cfg.bicross)
                                      for _ in range(cfg.num_irg)])

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
                  remat: bool = False):
        """PCB prefix, geometry branch input, interleaved IRG loop. Returns
        (x, per-layer (B, S, P, 2C) intermediates | None)."""
        cfg = self.cfg
        f, h, w = fhw
        B = x.shape[0]
        cos_d, sin_d = ropes
        apply_pose = cfg.camera_control and plucker_fea is not None
        blocks = self.dit.blocks
        si = cfg.start_index

        for i in range(si):
            x = _run(functools.partial(
                blocks[i], context=ctx, t_mod=t_mod, rope_cos=cos_d,
                rope_sin=sin_d, plucker_fea=plucker_fea,
                apply_pose=apply_pose and cfg.dit.has_adapter(i)),
                x, remat=remat)

        agg = self.vggt.aggregator
        patch_tokens, e0 = self.vggt.process_wan_input(
            x.view(B, f, h, w, cfg.dit.dim), timestep)
        tokens, pos = agg.assemble_tokens(patch_tokens)
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
                                            apply_pose=has_ad)
                x_agg, mod_agg = gblk.attn_half(x_agg, rope_g, e0)
                x, x_agg = self.bicross[i](x, x_agg, rope_bi_dit, rope_bi_agg)
                x = dblk.ffn_half(x, mod_dit)
                x_agg = gblk.ffn_half(x_agg, mod_agg)
            else:
                x = dblk(x, ctx, t_mod, cos_d, sin_d,
                         plucker_fea=plucker_fea, apply_pose=has_ad)
                x_agg = gblk(x_agg, rope_g, e0)
            inter = (torch.cat([frame_inter, x_agg.view(B, S, P, C)], dim=-1)
                     if collect_inters else None)
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
                      remat=False, control_tokens=None):
        """One denoise evaluation. latents (B, 16, f, h', w'); timestep
        (B,); context (B, 512, text_dim); clip_feature (B, 257, 1280);
        y (B, 20, f, h', w'); plucker_fea (B, L, plucker_dim);
        control_tokens (1 or B, L, dim), the Wan2.2 control-camera adapter's
        output (``WanDiT.control_adapter_tokens``).
        Returns (noise_pred (B, 16, f, h', w'), prediction dict | None).
        ``remat``: recompute each block on the backward pass."""
        (x, ctx, t, t_mod, fhw, ropes, rope_bi_dit, rope_bi_agg) = \
            self.forward_prologue(latents, timestep, context, clip_feature, y,
                                  control_tokens)
        x, inters = self.run_stack(x, ctx, t_mod, timestep, ropes,
                                   rope_bi_dit, rope_bi_agg, fhw, plucker_fea,
                                   return_prediction, remat)
        f, h, w = fhw
        noise_pred = self.dit.unpatchify(self.dit.head(x, t), fhw)
        if not return_prediction:
            return noise_pred, None
        prediction = self.vggt.head_prediction(
            inters, (h, w), self.cfg.vggt.aggregator.patch_start_idx)
        return noise_pred, prediction
