"""LoRA fine-tuning of the fusion model (``training/lora.py``): low-rank
adapters on the DiT projections, frozen base.

The JAX package rebuilds the scan tree every step with
``W_eff = W + (alpha / rank) * down @ up``. The port keeps the adapter
unmerged: an adapted ``nn.Linear`` carries a ``lora`` child, and
``core.params.linear`` -- which every DiT projection goes through -- adds

    (alpha / rank) * (x @ down^T) @ up^T

to the frozen layer's output. That equals the merged form up to rounding
and keeps the full-size dW_eff products and the merged weight copies out of
the step. ``merge_lora_`` bakes trained factors into the base weights for
inference.

Factors keep PyTorch's (out, in) layout: down (rank, d_in), up
(d_out, rank) -- the JAX package's (d_in, rank) / (rank, d_out) transposed
(``convert/from_jax.py:lora_state_dict``). down is drawn N(0, 1/sqrt(d_in)),
up starts at zero, so an adapter starts as the identity.

Targets are the JAX package's: the DiT block components ``self_attn``
(q, k, v, o), ``cross_attn`` (q, k, v, o, k_img, v_img) and ``ffn`` (fc1,
fc2 = ``ffn.0``, ``ffn.2``) -- 12 linears a block. The camera adapter, which
the port keeps under ``cross_attn.processor`` (JAX: ``camera``), is not a
target; nor are the VGGT, bicross, embedding and head linears.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .step import make_train_step

DEFAULT_TARGETS = ("self_attn", "cross_attn", "ffn")
# the linears each target component names in a DiT block
_TARGET_LAYERS = {"self_attn": ("q", "k", "v", "o"),
                  "cross_attn": ("q", "k", "v", "o", "k_img", "v_img"),
                  "ffn": ("0", "2")}


class LoRA(nn.Module):
    """The low-rank term of one adapted linear: (alpha/rank) (x down^T) up^T,
    computed in x's dtype (the f32 factors are cast to it)."""

    def __init__(self, d_in: int, d_out: int, rank: int, alpha: float,
                 device):
        super().__init__()
        self.scale = alpha / rank
        self.down = nn.Parameter(torch.empty((rank, d_in), device=device,
                                             dtype=torch.float32))
        self.up = nn.Parameter(torch.zeros((d_out, rank), device=device,
                                           dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.linear(x, self.down.to(x.dtype))
        return F.linear(h, (self.up * self.scale).to(x.dtype))


def target_layers(model: nn.Module,
                  targets: Tuple[str, ...] = DEFAULT_TARGETS
                  ) -> Iterator[Tuple[str, nn.Linear]]:
    """(state-dict prefix, layer) of every targeted DiT linear of a
    ``FusionModel``, block by block."""
    unknown = set(targets) - set(_TARGET_LAYERS)
    if unknown:
        raise ValueError(f"unknown LoRA targets {sorted(unknown)}; the DiT "
                         f"block components are {sorted(_TARGET_LAYERS)}")
    for i, blk in enumerate(model.dit.blocks):
        for comp in targets:
            parent = getattr(blk, comp)
            for name in _TARGET_LAYERS[comp]:
                layer = parent._modules.get(name)
                if layer is not None:
                    yield f"dit.blocks.{i}.{comp}.{name}", layer


def init_lora(model: nn.Module, rank: int = 16, *,
              generator: torch.Generator, alpha: float = 1.0,
              targets: Tuple[str, ...] = DEFAULT_TARGETS
              ) -> List[nn.Parameter]:
    """Freeze every parameter of ``model`` and attach a rank-``rank``
    adapter with f32 factors to each targeted linear, on the layer's
    device. Returns the factors (the trainable parameters), down before up,
    layer by layer.

    On a model split over a mesh (``FusionModel.shard``) a factor follows
    its layer's split (``parallel/sharding.py:PARAM_RULES``): a
    column-parallel layer keeps its rows of up, a row-parallel one its
    columns of down. down is drawn whole and this rank keeps its part, so a
    seeded init gives every rank the values of the unsplit one; the parts
    join ``model.param_parts``."""
    model.requires_grad_(False)
    parts = getattr(model, "param_parts", None)
    factors: List[nn.Parameter] = []
    for name, layer in target_layers(model, targets):
        if type(layer) is not nn.Linear:
            raise ValueError(f"{name} is a {type(layer).__name__}: LoRA "
                             f"attaches to float linears only")
        # the whole widths (a split layer keeps its nn.Linear attributes)
        lora = LoRA(layer.in_features, layer.out_features, rank, alpha,
                    layer.weight.device)
        with torch.no_grad():
            down = torch.randn(lora.down.shape, generator=generator,
                               device=generator.device)
            lora.down.copy_(down * layer.in_features ** -0.5)
        part = (parts or {}).get(f"{name}.weight")
        if part is not None:
            # a column split (dim 0 of the weight) splits up's rows, a row
            # split (dim 1) down's columns
            factor = "up" if part[0] == 0 else "down"
            whole = getattr(lora, factor)
            setattr(lora, factor, nn.Parameter(
                whole.detach().chunk(part[2], part[0])[part[1]].clone()))
            getattr(lora, factor).part_of = part
            parts[f"{name}.lora.{factor}"] = part
        layer.lora = lora
        factors += [lora.down, lora.up]
    if not factors:
        raise ValueError(f"no LoRA targets matched {targets}")
    return factors


def lora_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{state-dict name: factor} of every attached adapter."""
    return {n: p for n, p in model.named_parameters() if ".lora." in n}


@torch.no_grad()
def merge_lora_(model: nn.Module) -> nn.Module:
    """Bake every adapter into its layer in place -- W += (alpha/rank)
    up @ down, the delta formed in f32 and cast to W's dtype as
    ``merge_lora_into_scan`` does -- and remove the adapters."""
    for _, layer in target_layers(model, tuple(_TARGET_LAYERS)):
        lora = layer._modules.pop("lora", None)
        if lora is None:
            continue
        delta = lora.scale * (lora.up.float() @ lora.down.float())
        layer.weight.add_(delta.to(layer.weight.dtype))
    return model


def make_lora_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                         lr_schedule=None, *, remat: bool = True, mesh=None,
                         ulysses: bool = False
                         ) -> Callable[[Dict], torch.Tensor]:
    """``make_train_step`` over the adapters of ``model``: the optimizer
    holds the factors only, and the base must be frozen. ``mesh`` /
    ``ulysses``: as ``make_train_step`` takes them (the factors split with
    their layers, ``init_lora``)."""
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    live = [n for n, p in model.named_parameters()
            if p.requires_grad and id(p) not in held]
    if live:
        raise ValueError(f"the base is not frozen: {live[:4]} ... require "
                         f"grad but the optimizer does not hold them")
    return make_train_step(model, optimizer, lr_schedule, remat=remat,
                           mesh=mesh, ulysses=ulysses)
