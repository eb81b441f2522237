"""int8 / fp8 quantized inference for the dense hot path
(``core/quant.py``).

  * weights: symmetric per output channel, scale = absmax over the
    contraction axis / 127 (int8) or / 448 (fp8, float8_e4m3fn), clamped at
    1e-12, quantized once after load;
  * int8 (w8a8): symmetric per-token dynamic activation quant at call time
    (``x.float() / sx``, round half to even, clip +-127), the int8 x int8
    product accumulated in int32 (``torch._int_mm``), then ``(y * sx) *
    kscale`` and the bias in f32, cast to the activation dtype -- the JAX
    package's order of operations, so the two agree bit for bit on the CPU;
  * fp8: the weight dequantized to the activation dtype at use and the
    ordinary f32-accumulating product (storage halving, not compute).

A quantized layer is a ``QuantLinear``: an int8 or float8_e4m3fn ``weight``
(out, in), an f32 ``kscale`` (out,) and the float ``bias``, under the
``nn.Linear``'s name, so ``core.params.linear`` -- which every DiT, VGGT and
bicross projection goes through -- dispatches to ``qlinear`` and the models
need no edits. ``quantize_model`` rewrites every eligible ``nn.Linear`` of a
module in place: a weight of at least ``min_dim`` on both sides whose name
holds none of ``DEFAULT_EXCLUDE``'s tags, the JAX ``quantize_tree``'s rule.

On the card ``torch._int_mm`` wants more than 16 rows and K, N multiples of
8: fewer rows are zero-padded (every production width is a multiple of 8).
The activation quant and the rescale run as PyTorch ops; under a running
profiler they sit in the ranges ``qlinear_act_quant``, ``qlinear_int_mm``
and ``qlinear_rescale``.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# layers whose numerics or structure stay untouched: the patch embeddings
# feed the pipelines' dtype and device probes, "projection_head" is the VGGT
# f32 island; the heads, the time MLPs and the conditioning embeddings are
# few FLOPs but carry the delicate ends of the network
DEFAULT_EXCLUDE = ("patch_embedding", "projection_head", "head",
                   "time_embedding", "time_projection", "text_embedding",
                   "camera_pose_encoder", "img_emb")
QMAX = {"int8": 127.0, "fp8": 448.0}
QDTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
# torch._int_mm on CUDA takes more than this many rows
_INT_MM_MIN_ROWS = 17


def quantize_weight(weight: torch.Tensor, mode: str = "int8", group=None):
    """(out, in) float weight -> (quantized weight, f32 kscale (out,)).
    ``group``: the process group over whose ranks the input features are
    split (a row-parallel part); the absmax is then the whole row's."""
    if mode not in QMAX:
        raise ValueError(f"unknown quant mode {mode!r}")
    k = weight.float()
    amax = k.abs().amax(dim=-1)
    if group is not None:
        from ..parallel.distributed import all_reduce_max
        amax = all_reduce_max(amax, group)
    s = (amax / QMAX[mode]).clamp_min(1e-12)
    scaled = k / s[..., None]
    if mode == "int8":
        q = torch.round(scaled).clamp(-127, 127).to(torch.int8)
    else:
        q = scaled.to(torch.float8_e4m3fn)
    return q, s


class QuantLinear(nn.Module):
    """A quantized ``nn.Linear``: ``weight`` int8 or float8_e4m3fn (out,
    in), ``kscale`` f32 (out,), ``bias`` as the float layer had it. The
    feature counts are read off the weight, so a mesh rank's part
    (``parallel/sharding.py:shard_module_``) reports its own."""

    def __init__(self, in_features: int, out_features: int, mode: str,
                 bias: Optional[torch.Tensor] = None, device=None):
        super().__init__()
        self.mode = mode
        self.register_buffer("weight", torch.empty(
            (out_features, in_features), dtype=QDTYPE[mode], device=device))
        self.register_buffer("kscale", torch.empty(
            (out_features,), dtype=torch.float32, device=device))
        self.bias = None if bias is None else nn.Parameter(
            bias, requires_grad=False)

    @property
    def in_features(self) -> int:
        return self.weight.shape[1]

    @property
    def out_features(self) -> int:
        return self.weight.shape[0]

    @classmethod
    @torch.no_grad()
    def from_linear(cls, layer: nn.Linear, mode: str,
                    work_device=None, group=None) -> "QuantLinear":
        """Quantize ``layer`` (on ``work_device`` when given, e.g. the card
        for a layer held in host memory); the result lives where the layer
        did. ``group``: as in ``quantize_weight``."""
        home = layer.weight.device
        w = layer.weight if work_device is None else layer.weight.to(
            work_device)
        q, s = quantize_weight(w, mode, group)
        out = cls(w.shape[1], w.shape[0], mode,
                  None if layer.bias is None else layer.bias.detach(),
                  device="meta")
        out.weight, out.kscale = q.to(home), s.to(home)
        return out

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, mode={self.mode}, "
                f"bias={self.bias is not None}")


def _span(name: str):
    """A profiler range while a profiler runs, else nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (out, K) -> int32 (M, out), the rows zero-padded
    to torch._int_mm's minimum on the card."""
    m = xq.shape[0]
    if xq.is_cuda and m < _INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    return torch._int_mm(xq, wq.t())[:m]


def quantize_activations(x2d: torch.Tensor, group=None):
    """(M, K) activations -> (int8 (M, K), f32 per-row scale (M, 1)).
    ``group``: the ranks over which K is split; each row's absmax is then
    the maximum over all of them, the whole row's."""
    xf = x2d.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        from ..parallel.distributed import all_reduce_max
        amax = all_reduce_max(amax, group)
    sx = (amax / 127.0).clamp_min(1e-12)
    return torch.round(xf / sx).clamp_(-127, 127).to(torch.int8), sx


def rescale(y: torch.Tensor, sx: torch.Tensor, layer: QuantLinear,
            dtype: torch.dtype) -> torch.Tensor:
    """int32 (M, out) products -> (y * sx) * kscale (+ bias), f32, cast to
    ``dtype``."""
    y = y.float().mul_(sx).mul_(layer.kscale)
    if layer.bias is not None:
        y.add_(layer.bias.float())
    return y.to(dtype)


def qlinear(x: torch.Tensor, layer: QuantLinear,
            group=None) -> torch.Tensor:
    """Quantized x @ W^T (+ b), cast to x.dtype.

    ``group``: a row-parallel part -- x and the weight hold this rank's
    share of the input features, ``kscale`` and the bias are whole. fp8:
    the part dequantized by the whole scale, the partial products summed
    over the group, the bias added once in f32. int8: the per-token absmax
    taken over the whole row (an all-reduce max) before quantizing, the
    int32 partials summed (exactly) and rescaled once -- the bits of the
    one-process layer."""
    from ..parallel.distributed import all_reduce_sum, group_size
    split = group_size(group) > 1
    if layer.mode == "fp8":
        w = (layer.weight.float() * layer.kscale[:, None]).to(x.dtype)
        bias = layer.bias
        if not split:
            return F.linear(x, w, None if bias is None else bias.to(x.dtype))
        y = all_reduce_sum(F.linear(x, w), group)
        return y if bias is None else (y.float() + bias.float()).to(x.dtype)
    with _span("qlinear_act_quant"):
        xq, sx = quantize_activations(x.reshape(-1, x.shape[-1]),
                                      group if split else None)
    with _span("qlinear_int_mm"):
        y = int_mm(xq, layer.weight)
        if split:
            y = all_reduce_sum(y, group)
    with _span("qlinear_rescale"):
        y = rescale(y, sx, layer, x.dtype)
    return y.reshape(*x.shape[:-1], layer.out_features)


def eligible(name: str, layer: nn.Module, min_dim: int = 1024,
             exclude=DEFAULT_EXCLUDE) -> bool:
    """A float ``nn.Linear`` at least ``min_dim`` wide on both sides whose
    name holds none of the ``exclude`` tags."""
    return (type(layer) is nn.Linear
            and not any(tag in name for tag in exclude)
            and min(layer.weight.shape) >= min_dim)


@torch.no_grad()
def quantize_model(module: nn.Module, mode: str = "int8", *,
                   min_dim: int = 1024, exclude=DEFAULT_EXCLUDE,
                   work_device=None, axis=None) -> int:
    """Rewrite every eligible ``nn.Linear`` of ``module`` into a
    ``QuantLinear`` in place, one layer at a time (the device holds at most
    one float layer more than the result). Returns how many were
    rewritten.

    A module sharded over a mesh (``module.param_parts``, from
    ``parallel/sharding.py:shard_module_``) quantizes its parts as the
    whole layer would be quantized and then split: a column-parallel part
    holds whole rows, a row-parallel part takes each row's absmax over the
    model ``axis`` (every rank of it calls this, in the same order). So
    shard-then-quantize equals quantize-then-shard, bit for bit. The
    sizes the eligibility rule reads are the whole layer's."""
    if mode not in QMAX:
        raise ValueError(f"unknown quant mode {mode!r}")
    parts = getattr(module, "param_parts", {})
    if parts and axis is None:
        raise ValueError("the module is sharded over a mesh: pass its model "
                         "axis (the row-parallel scales span its ranks)")

    def whole_shape(name, m):
        shape = list(m.weight.shape)
        part = parts.get(f"{name}.weight")
        if part is not None:
            shape[part[0]] *= part[2]
        return shape

    targets = [name for name, m in module.named_modules()
               if eligible(name, m, 0, exclude)
               and min(whole_shape(name, m)) >= min_dim]
    for name in targets:
        parent_name, _, child = name.rpartition(".")
        parent = module.get_submodule(parent_name)
        layer = parent._modules[child]
        if "lora" in layer._modules:
            raise ValueError(f"{name} carries a LoRA adapter: merge it "
                             f"(training.lora.merge_lora_) before "
                             f"quantizing")
        part = parts.get(f"{name}.weight")
        group = axis.group if part is not None and part[0] == 1 else None
        parent._modules[child] = QuantLinear.from_linear(layer, mode,
                                                         work_device, group)
    return len(targets)


def quantized_names(module: nn.Module):
    """Names of the ``QuantLinear`` layers of ``module``, in module order."""
    return [n for n, m in module.named_modules() if isinstance(m,
                                                               QuantLinear)]


def count_quantized(module: nn.Module) -> int:
    return len(quantized_names(module))
