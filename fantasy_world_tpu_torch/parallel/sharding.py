"""The ('data', 'seq', 'model') mesh over process groups
(``parallel/sharding.py``).

``make_mesh(data, seq, model)`` lays the ranks out as the JAX mesh lays out
its devices (``rank = (d * seq + s) * model + m``) and opens one process
group per slice of each axis. The fusion denoise shards over it:

  * ``model``: megatron column / row splits of the DiT's 5120-wide
    projections (``PARAM_RULES``). The rules are JAX ``PARAM_RULES``
    rewritten on the port's names, the checkpoint's state-dict keys: JAX's
    ``P(None, "model")`` on an (in, out) kernel is a split of dim 0 of
    torch's (out, in) weight, ``P("model", None)`` a split of dim 1;
    biases follow their kernel. A quantized layer (``core/quant.py``)
    keeps its int8 / fp8 ``weight`` under the float weight's name, so it
    splits the same way; its per-output-channel ``kscale`` follows the
    bias of a column-parallel layer and stays whole on a row-parallel one.
    Everything else is replicated -- the VGGT (1024) and bicross (1152)
    towers, norms, embeddings, heads;
  * ``data``: the CFG pair (the batch), where it divides;
  * ``seq``: the latent frames (``frame_split``), so both token streams --
    the DiT's f*h*w and the geometry stream's f*(h*w + 5) -- split at
    frame boundaries; frame attention then needs no collective, and the
    long attentions gather k/v (or re-shard through Ulysses or the ring,
    ``parallel/ulysses.py``, ``parallel/ring.py``).

A dimension that does not divide its axis stays replicated, as
``maybe_constrain`` leaves it in the JAX package. The umT5 rules of the
JAX table are not carried over: the encoders run on one rank.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

AXES = ("data", "seq", "model")

# (state-dict key regex, per-dimension axis names) -- first match wins
_ATTN = r"(.*\.)?(self_attn|cross_attn)\."
PARAM_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    # column-parallel: the output features of q/k/v and the FFN's first
    # layer, with their biases and (quantized) per-channel scales
    (_ATTN + r"(q|k|v|k_img|v_img)\.weight$", ("model", None)),
    (_ATTN + r"(q|k|v|k_img|v_img)\.(bias|kscale)$", ("model",)),
    (r"(.*\.)?ffn\.0\.weight$", ("model", None)),
    (r"(.*\.)?ffn\.0\.(bias|kscale)$", ("model",)),
    # row-parallel: the input features of the output projections (their
    # bias is added once, after the sum over the model group; their kscale
    # is over the whole output axis and falls through to replicated)
    (_ATTN + r"o\.weight$", (None, "model")),
    (r"(.*\.)?ffn\.2\.weight$", (None, "model")),
    # LoRA factors (``training/lora.py``: down (rank, in), up (out, rank))
    # follow their layer's split: a column-parallel layer's up over its
    # output features, a row-parallel layer's down over its input features;
    # the other factor stays whole
    (_ATTN + r"(q|k|v|k_img|v_img)\.lora\.up$", ("model", None)),
    (r"(.*\.)?ffn\.0\.lora\.up$", ("model", None)),
    (_ATTN + r"o\.lora\.down$", (None, "model")),
    (r"(.*\.)?ffn\.2\.lora\.down$", (None, "model")),
    (r".*", ()),
]

# The whole (replicated) parameters whose gradient on a model rank is only
# that rank's share, because each rank uses them on its own columns: the
# q/k norms' scales (``sharded_rms_norm`` takes this rank's columns of
# them), the pose adapters (they run on the whole width, and each rank
# keeps its columns of their output), a column-parallel layer's LoRA down
# (it feeds this rank's part of up) and a row-parallel layer's LoRA up (it
# reads this rank's partial sum). ``reduce_gradients`` sums them over the
# model group; every other whole parameter is used alike on every model
# rank and has its whole gradient there already.
MODEL_PARTIAL_RULES: List[str] = [
    _ATTN + r"norm_(q|k|k_img)\.weight$",
    r"(.*\.)?cross_attn\.processor\.",
    _ATTN + r"(q|k|v|k_img|v_img)\.lora\.down$",
    r"(.*\.)?ffn\.0\.lora\.down$",
    _ATTN + r"o\.lora\.up$",
    r"(.*\.)?ffn\.2\.lora\.up$",
]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: its process group (None
    when the axis has one rank), its size and this rank's index on it."""
    group: Optional[object]
    size: int
    index: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a data x seq x model mesh."""
    shape: Tuple[int, int, int]
    rank: int
    axes: Tuple[Axis, Axis, Axis]

    def axis(self, name: str) -> Axis:
        return self.axes[AXES.index(name)]

    def size(self, name: str) -> int:
        return self.shape[AXES.index(name)]

    @property
    def world(self) -> int:
        return int(np.prod(self.shape))

    @property
    def trivial(self) -> bool:
        return self.world == 1


def rank_of(coords: Sequence[int], shape: Sequence[int]) -> int:
    d, s, m = coords
    return (d * shape[1] + s) * shape[2] + m


def make_mesh(data: int = 1, seq: int = 1, model: int = 1) -> Mesh:
    """The mesh over the default process group, whose world size must be
    data * seq * model (1 needs no process group). Every rank must call it:
    it opens one group per slice of each axis of size > 1, in the same
    order on every rank."""
    shape = (data, seq, model)
    n = data * seq * model
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"a {data}x{seq}x{model} mesh needs {n} ranks; the "
                         f"process group has {world}")
    me = dist.get_rank() if dist.is_initialized() else 0
    coords = np.unravel_index(me, shape)
    axes = []
    for a, size in enumerate(shape):
        group = None
        if size > 1:
            others = [range(k) for i, k in enumerate(shape) if i != a]
            for rest in np.ndindex(*[len(r) for r in others]):
                ranks = []
                for j in range(size):
                    c = list(rest)
                    c.insert(a, j)
                    ranks.append(rank_of(c, shape))
                g = dist.new_group(ranks)
                if me in ranks:
                    group = g
        axes.append(Axis(group, size, int(coords[a])))
    return Mesh(shape, me, tuple(axes))


def single() -> Mesh:
    """The mesh of one process."""
    return Mesh((1, 1, 1), 0, tuple(Axis(None, 1, 0) for _ in AXES))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def spec_for_path(name: str, rules=None) -> Tuple[Optional[str], ...]:
    for pat, spec in (rules or PARAM_RULES):
        if re.match(pat, name):
            return spec
    return ()


def _fits(spec, shape, sizes: Mapping[str, int]) -> bool:
    for d, axis in enumerate(spec):
        size = sizes.get(axis, 1) if axis else 1
        if size > 1 and shape[d] % size:
            return False
    return True


def param_spec(name: str, shape, sizes: Mapping[str, int],
               rules=None) -> Tuple[Optional[str], ...]:
    """The split of one tensor: its rule's axes, or () (replicated) when
    the rule names more dimensions than the tensor has or a split
    dimension does not divide its axis (JAX ``param_specs``)."""
    spec = spec_for_path(name, rules)
    if len(spec) > len(shape) or not _fits(spec, shape, sizes):
        return ()
    return spec


def param_specs(shapes: Mapping[str, Sequence[int]],
                sizes: Mapping[str, int], rules=None
                ) -> Dict[str, Tuple[Optional[str], ...]]:
    """{state-dict key: axes} for {key: shape} on a mesh of ``sizes``."""
    return {k: param_spec(k, s, sizes, rules) for k, s in shapes.items()}


def sizes_of(mesh: Mesh) -> Dict[str, int]:
    return dict(zip(AXES, mesh.shape))


def split_of(spec, mesh: Mesh) -> Optional[Tuple[int, int, int]]:
    """(dim, index, parts) of this rank's part for a tensor of ``spec``, or
    None when it is replicated."""
    for d, axis in enumerate(spec):
        if axis and mesh.size(axis) > 1:
            return d, mesh.axis(axis).index, mesh.size(axis)
    return None


def shard_tensor(t: torch.Tensor, part) -> torch.Tensor:
    dim, index, parts = part
    return t.chunk(parts, dim)[index].clone()


def shard_state_dict(sd: Mapping[str, torch.Tensor], mesh: Mesh, rules=None
                     ) -> Dict[str, torch.Tensor]:
    """This rank's slice of every tensor (JAX ``shard_tree``)."""
    sizes = sizes_of(mesh)
    out = {}
    for k, t in sd.items():
        part = split_of(param_spec(k, t.shape, sizes, rules), mesh)
        out[k] = t if part is None else shard_tensor(t, part)
    return out


def shard_module_(module: nn.Module, mesh: Mesh, rules=None
                  ) -> Dict[str, Tuple[int, int, int]]:
    """Replace every parameter and buffer that the rules split by this
    rank's part, in place (on the meta device too): a quantized layer's
    int8 / fp8 weight and its scales are buffers. Returns {name: (dim,
    index, parts)}, also kept as ``module.param_parts``
    (``core/params.py:build`` fills a part from the seeded whole, so a
    seeded sharded build equals the unsharded one; ``core/quant.py:
    quantize_model`` reads which parts are row-parallel)."""
    sizes = sizes_of(mesh)
    parts = {}
    tensors = [(n, t, True) for n, t in module.named_parameters()] + \
        [(n, t, False) for n, t in module.named_buffers()]
    for name, t, is_param in tensors:
        part = split_of(param_spec(name, t.shape, sizes, rules), mesh)
        if part is None:
            continue
        owner = module.get_submodule(name.rsplit(".", 1)[0]) \
            if "." in name else module
        leaf = name.rsplit(".", 1)[-1]
        if is_param:
            setattr(owner, leaf, nn.Parameter(shard_tensor(t.data, part),
                                              requires_grad=t.requires_grad))
        else:
            owner._buffers[leaf] = shard_tensor(t, part)
        parts[name] = part
    module.param_parts = parts
    return parts


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TokenSplit:
    """A sequence split over the seq group: rank i holds ``sizes[i]``
    consecutive tokens, in rank order; this rank is ``index``."""
    group: Optional[object]
    sizes: Tuple[int, ...]
    index: int

    @property
    def n(self) -> int:
        return len(self.sizes)

    @property
    def length(self) -> int:
        return sum(self.sizes)

    @property
    def start(self) -> int:
        return sum(self.sizes[:self.index])

    @property
    def local(self) -> int:
        return self.sizes[self.index]

    def take(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's tokens of a whole sequence ``t``."""
        return t.narrow(dim, self.start, self.local)

    def gather(self, t: torch.Tensor, dim: int = 1,
               grad: Optional[str] = None) -> torch.Tensor:
        """The whole sequence from every rank's tokens ``t`` (``grad``: the
        backward, as ``distributed.all_gather_cat`` takes it)."""
        from .distributed import all_gather_cat
        return all_gather_cat(t, self.group, dim, self.sizes, grad=grad)

    def scaled(self, per_unit: int) -> "TokenSplit":
        """The same split counted in units of ``per_unit`` tokens."""
        return TokenSplit(self.group, tuple(s * per_unit for s in self.sizes),
                          self.index)


def even_split(length: int, axis: Axis) -> TokenSplit:
    """``length`` items over the axis, the first ranks one more where it
    does not divide (``np.array_split``)."""
    sizes = tuple(len(c) for c in np.array_split(np.arange(length),
                                                 axis.size))
    return TokenSplit(axis.group, sizes, axis.index)


def frame_split(frames: int, mesh: Mesh) -> TokenSplit:
    """The latent frames over the seq axis (whole frames per rank); a rank
    without a frame is refused."""
    axis = mesh.axis("seq")
    if frames < axis.size:
        raise ValueError(f"{frames} latent frames do not split over "
                         f"{axis.size} seq ranks")
    return even_split(frames, axis)


def batch_rows(batch: int, mesh: Mesh) -> Optional[slice]:
    """This rank's rows of a batch split over 'data', or None when the
    batch does not divide (then every data rank runs all of it)."""
    axis = mesh.axis("data")
    if axis.size == 1 or batch % axis.size:
        return None
    n = batch // axis.size
    return slice(axis.index * n, (axis.index + 1) * n)


def take_rows(t, rows: Optional[slice]):
    return t if (t is None or rows is None) else t[rows]


def gather_rows(t: torch.Tensor, rows: Optional[slice], mesh: Mesh,
                grad: Optional[str] = None) -> torch.Tensor:
    """The whole batch from this data rank's rows (``grad``: the backward,
    as ``distributed.all_gather_cat`` takes it)."""
    if rows is None:
        return t
    from .distributed import all_gather_cat
    return all_gather_cat(t, mesh.axis("data").group, 0, grad=grad)


def token_split(batch: int, fhw: Sequence[int], mesh: Mesh
                ) -> Tuple[Optional[slice], TokenSplit]:
    """Where this rank's part of a (batch, f*h*w, ...) token tensor lies, as
    ``FusionModel.joint_forward`` splits its DiT tokens: (its rows over
    'data', its frames' tokens over 'seq')."""
    f, h, w = fhw
    return (batch_rows(batch, mesh),
            frame_split(f, mesh).scaled(h * w))


def take_tokens(t: torch.Tensor, part) -> torch.Tensor:
    """This rank's part (``token_split``) of a whole token tensor."""
    rows, tokens = part
    return tokens.take(take_rows(t, rows))


def gather_tokens(t: torch.Tensor, part, mesh: Mesh) -> torch.Tensor:
    """The whole token tensor from every rank's part (``token_split``)."""
    rows, tokens = part
    return gather_rows(tokens.gather(t), rows, mesh)


# ---------------------------------------------------------------------------
# megatron pieces: a width split in column parts over the model axis
# ---------------------------------------------------------------------------

def sharded_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
                     axis: Axis) -> torch.Tensor:
    """``ops.norms.rms_norm`` over the whole width of ``x``, this rank's
    columns of it: the sums of squares are summed over the model group.
    ``weight`` is the whole (replicated) scale."""
    from .distributed import all_reduce_sum
    xf = x.float()
    # each rank scales its own columns by the sum: the backward sums
    ss = all_reduce_sum(xf.square().sum(dim=-1, keepdim=True), axis.group,
                        grad="sum")
    y = xf * torch.rsqrt(ss / (x.shape[-1] * axis.size) + eps)
    return (y.to(x.dtype) * local_columns(weight, axis)).to(x.dtype)


def row_linear(x: torch.Tensor, layer: nn.Linear,
               axis: Optional[Axis]) -> torch.Tensor:
    """``core.params.linear(x, layer)`` for a layer whose input features
    are split over ``axis`` (x holds this rank's): the partial products are
    summed over the model group and the bias is added once, in f32. A LoRA
    adapter's term, ``up (down_local x_local)`` with down split over the
    input features, joins the partial product before the sum. Every rank
    goes on from the same sum, so the sum's backward is the identity. A
    quantized layer takes ``core.quant.qlinear``'s row-parallel path (the
    int8 activation scale over the whole row, the int32 partials summed
    exactly)."""
    from ..core.params import linear
    if axis is None or axis.size == 1:
        return linear(x, layer)
    from ..core.quant import QuantLinear, qlinear
    if isinstance(layer, QuantLinear):
        return qlinear(x, layer, axis.group)
    from .distributed import all_reduce_sum
    w = layer.weight
    y = (torch.nn.functional.linear(x, w) if w.dtype == x.dtype else
         torch.nn.functional.linear(x.float(), w.float()).to(x.dtype))
    lora = layer._modules.get("lora")
    if lora is not None:
        y = y + lora(x)
    y = all_reduce_sum(y, axis.group, grad="identity")
    if layer.bias is None:
        return y
    return (y.float() + layer.bias.float()).to(x.dtype)


def gather_columns(x: torch.Tensor, axis: Optional[Axis],
                   grad: Optional[str] = None) -> torch.Tensor:
    """The whole width from every model rank's columns (``grad``: the
    backward, as ``distributed.all_gather_cat`` takes it)."""
    if axis is None or axis.size == 1:
        return x
    from .distributed import all_gather_cat
    return all_gather_cat(x, axis.group, -1, grad=grad)


def local_columns(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """This model rank's columns of a whole width (its backward gives the
    whole width, zeros outside them: a whole parameter read so is one of
    ``MODEL_PARTIAL_RULES``)."""
    if axis is None or axis.size == 1:
        return x
    return x.chunk(axis.size, dim=-1)[axis.index]


def column_input(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """``x``, a tensor every model rank holds whole, as the input of this
    rank's column-parallel layers: its gradient is summed over the model
    group on the backward (each rank's covers its own columns)."""
    if axis is None or axis.size == 1:
        return x
    from .distributed import sum_grad
    return sum_grad(x, axis.group)


# ---------------------------------------------------------------------------
# training: gradients and whole tensors of a split model
# ---------------------------------------------------------------------------

def model_partial(name: str) -> bool:
    """Whether a whole parameter's gradient on a model rank is that rank's
    share only (``MODEL_PARTIAL_RULES``)."""
    return any(re.match(pat, name) for pat in MODEL_PARTIAL_RULES)


def flat_reduce(grads: List[torch.Tensor], group, scale: float = 1.0,
                bucket: int = 1 << 26) -> None:
    """Sum ``grads`` over ``group`` in place (then times ``scale``), a few
    flat buckets of one dtype at a time, so a step makes a handful of
    collectives rather than one a parameter."""
    from .distributed import all_reduce_sum, group_size
    if group_size(group) == 1 or not grads:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        i = 0
        while i < len(same):
            j, n = i, 0
            while j < len(same) and (j == i or n + same[j].numel() <= bucket):
                n += same[j].numel()
                j += 1
            flat = torch.cat([g.reshape(-1) for g in same[i:j]])
            flat = all_reduce_sum(flat, group)
            if scale != 1.0:
                flat = flat * scale
            off = 0
            for g in same[i:j]:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
            i = j


@torch.no_grad()
def reduce_gradients(params: Mapping[str, torch.Tensor], mesh: Mesh,
                     batch: int) -> None:
    """After the backward of a loss every rank computed alike on the
    gathered prediction, make each rank's ``.grad`` the one-process
    gradient of the part it holds: summed over 'seq' (each rank ran its
    frames) and over 'data' (its rows; where the ``batch`` does not divide
    the data ranks, each ran all of it, and they are averaged instead), and
    over 'model' for the whole parameters of ``MODEL_PARTIAL_RULES``.
    ``params``: {state-dict name: parameter}, every one with a ``.grad``.
    Every rank calls it with the same names."""
    if mesh.trivial:
        return
    items = sorted(params.items())
    grads = [p.grad for _, p in items]
    flat_reduce([g for (n, _), g in zip(items, grads) if model_partial(n)],
                 mesh.axis("model").group)
    flat_reduce(grads, mesh.axis("seq").group)
    data = mesh.axis("data")
    flat_reduce(grads, data.group, 1.0 if batch_rows(batch, mesh)
                 else 1.0 / data.size)


def whole_tensor(t: torch.Tensor, name: str, module: nn.Module,
                 mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's part, when the
    parameter ``name`` of ``module`` is split (``module.param_parts``),
    gathered over the model group (every model rank calls it); else ``t``.
    ``t``: the parameter or a tensor of its shape (an AdamW moment)."""
    part = getattr(module, "param_parts", {}).get(name)
    if part is None:
        return t
    from .distributed import all_gather_cat
    return all_gather_cat(t.detach(), mesh.axis("model").group, part[0])


def part_of_whole(t: torch.Tensor, name: str, module: nn.Module
                  ) -> torch.Tensor:
    """This rank's part of the whole tensor ``t`` of the parameter ``name``
    of ``module`` (``t`` itself when the parameter is not split)."""
    part = getattr(module, "param_parts", {}).get(name)
    return t if part is None else shard_tensor(t, part)
