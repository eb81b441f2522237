"""The MoGe-2 checkpoint -> the port's ``MoGe`` (the counterpart of
``convert/moge.py:convert_moge`` and the JAX sampler's ``_load_moge``).

The module's paths are the checkpoint's state-dict keys, so loading is
``torch.load(path)["model"]`` copied in; keys the port has no module for
(DINOv2's ``mask_token``) are not read. The architecture is read off the
tensors: the ViT's width, depth, patch and position grid (its heads are
64 wide, as in every DINOv2), the projected layers (evenly spaced, the
last one last), the conv-stack widths, residual blocks and resamplers, the
scale head, and whether there is a normal head.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Mapping

import torch

from ..core.params import build
from ..models.moge.model import DINOv2Config, MoGe, MoGeConfig
from .checkpoint import load_into, read_pth


def _count(sd: Mapping, pattern: str) -> int:
    return len({m.group(1) for k in sd for m in [re.match(pattern, k)] if m})


def moge_config_from_state_dict(sd: Mapping[str, torch.Tensor]
                                ) -> MoGeConfig:
    """The architecture of a MoGe-2 state dict (what its tensors do not
    show -- LayerScale's init, the interpolation offset, the output remap
    and the token range -- at ``MoGeConfig``'s defaults)."""
    base = MoGeConfig()
    pre = "encoder.backbone."
    pos = sd[pre + "pos_embed"].shape
    dim = pos[-1]
    depth = _count(sd, re.escape(pre) + r"blocks\.(\d+)\.")
    n_proj = _count(sd, r"encoder\.output_projections\.(\d+)\.")
    encoder = DINOv2Config(
        patch_size=sd[pre + "patch_embed.proj.weight"].shape[-1], dim=dim,
        depth=depth, num_heads=dim // 64,
        mlp_ratio=sd[pre + "blocks.0.mlp.fc1.weight"].shape[0] / dim,
        init_values=base.encoder.init_values,
        pos_grid=round((pos[1] - 1) ** 0.5),
        interpolate_offset=base.encoder.interpolate_offset)
    levels = _count(sd, r"points_head\.input_blocks\.(\d+)\.")

    def n_res(head):
        return tuple(_count(sd, rf"{head}\.res_blocks\.{i}\.(\d+)\.")
                     for i in range(levels))
    n_fc = _count(sd, r"scale_head\.(\d+)\.weight")
    return dataclasses.replace(
        base, encoder=encoder,
        intermediate_layers=tuple(depth * (i + 1) // n_proj - 1
                                  for i in range(n_proj)),
        dim_proj_out=sd["encoder.output_projections.0.weight"].shape[0],
        dim_res_blocks=tuple(
            sd[f"points_head.input_blocks.{i}.weight"].shape[0]
            for i in range(levels)),
        neck_num_res_blocks=n_res("neck"),
        head_num_res_blocks=n_res("points_head"),
        resamplers=tuple(
            "conv_transpose" if f"neck.resamplers.{i}.0.weight" in sd
            else "bilinear" for i in range(levels - 1)),
        scale_head_dims=(dim,) + tuple(
            sd[f"scale_head.{2 * i}.weight"].shape[0] for i in range(n_fc)),
        with_normal_head=any(k.startswith("normal_head.") for k in sd))


def load_moge(path: str, *, device,
              dtype: torch.dtype = torch.bfloat16) -> MoGe:
    """``path`` (a MoGe-2 ``.pt``: {"model": state dict, ...}) -> ``MoGe``
    built on ``device`` in ``dtype``."""
    sd = read_pth(path)
    cfg = moge_config_from_state_dict(sd)
    return load_into(build(lambda: MoGe(cfg), device=device, dtype=dtype),
                     sd, "moge")
