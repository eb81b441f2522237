"""Parameter helpers: the f32-accumulating linear, the JAX package's random
init distributions, and building a model on its device without touching
the host.

Modules keep the reference checkpoint's state-dict names and PyTorch's
(out, in) weight layout; ``convert/from_jax.py`` carries a JAX parameter
tree across.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .quant import QuantLinear, qlinear


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """x @ W^T (+ b): product accumulated in f32, bias added in f32, result
    cast to x.dtype (``core/params.py:linear``). Same-dtype inputs go to
    F.linear, whose bias add is fused into the f32 epilogue of the matmul;
    an f32 layer under a lower-precision x computes in f32 and casts back.
    A layer carrying a ``lora`` adapter (``training/lora.py``) adds its
    low-rank term; a quantized layer (``core/quant.py``) takes ``qlinear``.
    """
    if isinstance(layer, QuantLinear):
        return qlinear(x, layer)
    if layer.weight.dtype == x.dtype:
        y = F.linear(x, layer.weight, layer.bias)
    else:
        b = None if layer.bias is None else layer.bias.float()
        y = F.linear(x.float(), layer.weight.float(), b).to(x.dtype)
    lora = layer._modules.get("lora")
    return y if lora is None else y + lora(x)


class RMSNorm(nn.Module):
    """Scale-only RMS norm parameters (``weight``); the math is
    ``ops.norms.rms_norm``."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))


# ---------------------------------------------------------------------------
# init: the distributions of core/params.py init_linear / np_normal and the
# model-specific inits of the JAX package
# ---------------------------------------------------------------------------

def _fill_whole(t: torch.Tensor, fill: Callable) -> None:
    """``fill(t)``; for a mesh rank's part of a tensor (``t.part_of`` =
    (dim, index, parts), ``parallel/sharding.py:shard_module_``) the whole
    tensor is drawn and the part kept, so a seeded sharded build draws what
    the unsharded one does."""
    part = getattr(t, "part_of", None)
    if part is None:
        fill(t)
        return
    dim, index, parts = part
    shape = list(t.shape)
    shape[dim] *= parts
    whole = t.new_empty(shape)
    fill(whole)
    t.copy_(whole.chunk(parts, dim)[index])


@torch.no_grad()
def uniform_fan_in_(weight: torch.Tensor, fan_in: int,
                    generator: torch.Generator) -> None:
    s = 1.0 / math.sqrt(fan_in)
    _fill_whole(weight, lambda t: t.uniform_(-s, s, generator=generator))


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    _fill_whole(t, lambda w: w.normal_(0.0, std, generator=generator))


@torch.no_grad()
def init_params_(root: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init with the JAX package's distributions: linears and
    convolutions U(+-1/sqrt(fan_in)) with zero bias, transposed convs
    N(0, 0.02), norms at identity. Then every module's ``init_extra_``
    (modulation tables, LayerScale, zero-init gates) runs, after the
    generic pass so it wins."""
    for m in root.modules():
        if isinstance(m, nn.Linear):
            uniform_fan_in_(m.weight, m.in_features, generator)
        elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            uniform_fan_in_(m.weight, m.weight[0].numel(), generator)
        elif isinstance(m, nn.ConvTranspose2d):
            normal_(m.weight, 0.02, generator)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, RMSNorm)):
            if m.weight is not None:
                m.weight.fill_(1.0)
        if getattr(m, "bias", None) is not None and isinstance(
                m.bias, torch.Tensor):
            m.bias.zero_()
    for m in root.modules():
        if hasattr(m, "init_extra_"):
            m.init_extra_(generator)
    return root


def build(make: Callable[[], nn.Module], *, device, dtype: torch.dtype,
          generator: Optional[torch.Generator] = None,
          mesh=None) -> nn.Module:
    """Construct ``make()`` on the meta device, cast it to ``dtype`` (the
    submodules a module lists in ``fp32_children`` stay float32), allocate
    it directly on ``device`` and, given a generator, initialise it there.
    Nothing is materialised on the host: the 14B model is built in place on
    the card. Without a generator the parameters are uninitialised, for a
    ``load_state_dict`` to fill. With a ``mesh`` the module's ``shard`` runs
    on the meta device first, so a rank allocates only its parts, and the
    seeded init gives each part the values of the unsharded build."""
    with torch.device("meta"):
        module = make()
    module = module.to(dtype)
    for m in module.modules():
        for name in getattr(m, "fp32_children", ()):
            getattr(m, name).float()
    if mesh is not None:
        module.shard(mesh)
    module = module.to_empty(device=device)
    for name, part in getattr(module, "param_parts", {}).items():
        module.get_parameter(name).part_of = part
    if generator is not None:
        init_params_(module, generator)
    return module
