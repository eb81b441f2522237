"""Process-group bootstrap and the collectives of the mesh
(``parallel/distributed.py``).

One process per rank, as ``torchrun`` starts them: ``initialize()`` reads
torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``
(they take the place of the TPU pod variables) and opens the default
process group -- NCCL with one rank per card, gloo for ``--device cpu``.
A single process is a no-op, as in the JAX package.

    torchrun --nproc_per_node 2 -m fantasy_world_tpu_torch.cli.infer_wan21 \\
        --mesh_seq 2 --ulysses true ...

NCCL refuses two ranks on one device; ``initialize`` says so before NCCL
does. A caller that chooses its own transport passes ``backend=`` (ranks
that share one card use gloo).

The collectives below take a process group (``None``, or a group of one
rank, is no communication at all) and work on tensors of any device, by
the path the group's backend and the tensors' cards give (``_route``):
NCCL, or gloo over CPU tensors, directly; gloo over CUDA tensors whose
ranks share one card, through each rank's staging buffer mapped into the
others by CUDA IPC, gloo only meeting them at barriers (``_SharedCard``).
Gloo over CUDA tensors on different cards is refused: such ranks use NCCL.

Training differentiates through them on either route: each collective of
the mesh forward has an autograd Function whose backward is its conjugate
collective. Where one collective needs two backwards, by whether the
ranks go on alike from its result or each on work of its own, the caller
names it (``grad=``): the all-reduce's identity or sum, the gather's
slice or reduce-scatter. The all-to-all is its own inverse; ``sum_grad``
(identity forward, summing backward) marks a whole tensor entering each
rank's own part of the work.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def is_multiprocess_env() -> bool:
    """True when launched as one rank of several (``WORLD_SIZE`` > 1)."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def choose_backend(device) -> str:
    """NCCL for ranks on cards, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _check_cards_per_rank(backend: str) -> None:
    """NCCL needs a card of its own for every local rank."""
    if backend != "nccl":
        return
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ.get("WORLD_SIZE", "1")))
    cards = torch.cuda.device_count()
    if local > cards:
        raise RuntimeError(
            f"{local} local ranks but {cards} CUDA device(s): NCCL refuses "
            f"two ranks on one device. Start one rank per card, or pass "
            f"backend='gloo' to run ranks that share a card")


def initialize(device="cuda", backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               force: bool = False, timeout_s: float = 600.0) -> bool:
    """``dist.init_process_group`` with single-process no-op semantics.

    Under torchrun every argument comes from the environment; a single
    process (no ``WORLD_SIZE`` > 1) returns False unless ``force`` or an
    ``init_method`` is given. ``backend`` defaults to NCCL for a CUDA
    ``device`` and gloo for the CPU. Idempotent: True once the default
    group exists."""
    if dist.is_initialized():
        return True
    if not (force or init_method or is_multiprocess_env()):
        return False
    backend = backend or choose_backend(device)
    _check_cards_per_rank(backend)
    kw = {}
    if world_size is not None:
        kw.update(world_size=world_size, rank=rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return True


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (modulo the cards, for ranks
    that share one over gloo), or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def ranks_per_card() -> int:
    """How many of this host's ranks share each card (1 on the CPU and in
    one process): ``LOCAL_WORLD_SIZE`` over the cards, rounded up."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return max(1, -(-local // max(1, cards)))


def runtime_info() -> dict:
    """Process topology summary (for logs and sanity asserts)."""
    up = dist.is_initialized()
    return {"rank": dist.get_rank() if up else 0,
            "world_size": dist.get_world_size() if up else 1,
            "local_rank": int(os.environ.get("LOCAL_RANK", "0")),
            "backend": dist.get_backend() if up else None,
            "cuda_devices": torch.cuda.device_count(),
            "initialized": up}


def release_shared() -> None:
    """Free the staging buffers of the groups whose ranks share a card;
    the next collective over such a group maps new ones. A process that
    runs one job after another gives their memory back between them.
    Every rank of the default group calls it: they meet at a barrier."""
    # every rank unmaps the others' buffers before any is freed
    for card in _SHARED.values():
        card.unmap()
    if _SHARED:
        torch.cuda.synchronize()
    dist.barrier()
    _SHARED.clear()
    if torch.cuda.is_initialized():
        torch.cuda.ipc_collect()


def shutdown() -> None:
    """Release the shared staging buffers and close the default group;
    every rank calls it (the buffers are released at a barrier)."""
    if dist.is_initialized():
        if _SHARED:
            release_shared()
        _CONTROL.clear()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


# the staging buffers of each gloo group whose ranks share a card
_SHARED: Dict[object, "_SharedCard"] = {}


def _route(t: torch.Tensor, group) -> str:
    """"direct" (NCCL, or gloo on CPU tensors) or "card" (gloo, every rank
    on this card). Checked once per group, by every rank of it, from the
    cards' UUIDs; gloo over CUDA tensors on different cards raises."""
    if not t.is_cuda or dist.get_backend(group) != dist.Backend.GLOO:
        return "direct"
    if group not in _SHARED:
        uuids = [None] * dist.get_world_size(group)
        dist.all_gather_object(
            uuids, str(torch.cuda.get_device_properties(t.device).uuid),
            group=group)
        if len(set(uuids)) != 1:
            raise RuntimeError(
                "gloo carries CUDA tensors only between ranks that share "
                "one card; ranks on different cards use NCCL")
        _SHARED[group] = _SharedCard(group)
    return "card"


class _SharedCard:
    """The data path of a gloo group whose ranks share one card: each
    rank's staging buffer, mapped into every other rank through CUDA IPC.
    A collective copies this rank's tensor into its buffer, meets the
    others at a barrier, copies out what it needs of theirs, and meets them
    again before any buffer is written anew."""

    def __init__(self, group):
        self.group, self.me = group, dist.get_rank(group)
        self.bufs: Optional[List[torch.Tensor]] = None
        self.size = 0

    def _grow(self, nbytes: int, device) -> None:
        from torch.multiprocessing.reductions import reduce_tensor
        self.bufs = None
        own = torch.empty(nbytes, dtype=torch.uint8, device=device)
        shared = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(shared, reduce_tensor(own), group=self.group)
        self.bufs = [own if r == self.me else fn(*args)
                     for r, (fn, args) in enumerate(shared)]
        self.size = nbytes

    def exchange(self, t: torch.Tensor, take: Callable
                 ) -> List[Optional[torch.Tensor]]:
        """For every rank r, a copy of ``take(r, rank r's t)`` (None where
        it returns None). Every rank passes a ``t`` of one shape and
        dtype."""
        nbytes = t.numel() * t.element_size()
        if nbytes > self.size:
            self._grow(nbytes, t.device)
        stream = torch.cuda.current_stream(t.device)
        self.bufs[self.me][:nbytes].copy_(
            t.contiguous().view(-1).view(torch.uint8))
        stream.synchronize()
        dist.barrier(group=self.group)
        out = []
        for r, buf in enumerate(self.bufs):
            part = take(r, buf[:nbytes].view(t.dtype).view(t.shape))
            out.append(None if part is None else part.clone())
        stream.synchronize()
        dist.barrier(group=self.group)
        return out

    def unmap(self) -> None:
        """Drop the others' buffers (this one goes with the object)."""
        if self.bufs is not None:
            self.bufs = self.bufs[self.me:self.me + 1]


def _differentiable(t: torch.Tensor, grad: Optional[str], choices,
                    what: str) -> bool:
    """Whether a collective on ``t`` goes through its autograd Function:
    under grad mode, for a ``t`` that requires grad. Its caller must then
    say which backward it needs (``grad``, one of ``choices``): that
    depends on how the ranks use the result, which the collective cannot
    see."""
    if not (torch.is_grad_enabled() and t.requires_grad):
        return False
    if grad not in choices:
        raise ValueError(f"{what} under autograd needs grad= one of "
                         f"{choices}, got {grad!r}")
    return True


def all_reduce_sum(t: torch.Tensor, group, grad: Optional[str] = None
                   ) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (a new tensor where communication
    happens, ``t`` itself otherwise); the same bits on every rank.

    Differentiable when ``t`` requires grad, with the backward ``grad``
    names: "identity" where every rank's work on the sum is the same (a
    row-parallel layer's partial products: each rank's gradient is already
    the whole one, and summing would count it once per rank), "sum" where
    each rank uses the sum on work of its own (the sums of squares of a
    norm over column parts): the ranks' gradients are summed."""
    if group_size(group) == 1:
        return t
    if _differentiable(t, grad, ("identity", "sum"), "all_reduce_sum"):
        return _AllReduceSum.apply(t, group, grad)
    if _route(t, group) == "card":
        parts = _SHARED[group].exchange(t, lambda r, x: x)
        # integers (int8 products' int32 partials) sum exactly as they are
        wide = (lambda p: p.float()) if t.is_floating_point() else (
            lambda p: p)
        total = wide(parts[0])
        for p in parts[1:]:
            total = total + wide(p)
        return total.to(t.dtype)
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``t`` over ``group`` (``t`` itself when
    the group has one rank); the same bits on every rank."""
    if group_size(group) == 1:
        return t
    if _route(t, group) == "card":
        return torch.stack(_SHARED[group].exchange(t, lambda r, x: x)
                           ).amax(dim=0)
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def barrier() -> None:
    """Every rank of the default group meets here (nothing in one
    process)."""
    if dist.is_initialized():
        dist.barrier()


def broadcast_object(obj, src: int = 0, group=None):
    """Rank ``src``'s picklable ``obj`` on every rank of ``group`` (the
    default group when None); ``obj`` itself in a single process."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


# how long a message of ``control_group`` may be waited for: a served mesh's
# followers wait there for the next batch for as long as the server idles
CONTROL_TIMEOUT = datetime.timedelta(days=3650)
_CONTROL: Dict[str, object] = {}


def control_group():
    """A gloo group of every rank, whose collectives wait up to
    ``CONTROL_TIMEOUT`` (the default group's wait at most its ``timeout_s``,
    after which gloo raises and NCCL's watchdog ends the rank): for
    ``broadcast_object`` of messages that come when they come, such as the
    server's batches. Made once, by every rank in the same order as its
    other groups; None in one process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    if "group" not in _CONTROL:
        _CONTROL["group"] = dist.new_group(backend="gloo",
                                           timeout=CONTROL_TIMEOUT)
    return _CONTROL["group"]


def all_gather_cat(t: torch.Tensor, group, dim: int,
                   sizes: Optional[Sequence[int]] = None,
                   grad: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order.
    ``sizes``: each rank's extent along ``dim`` when they differ (each part
    is zero-padded to the largest for the collective and cut back).

    Differentiable when ``t`` requires grad, with the backward ``grad``
    names: "slice" where every rank computes the same from the whole (the
    loss on the gathered prediction): this rank's part of its own
    gradient; "reduce_scatter" where each rank uses the whole on work of
    its own (its queries against every rank's keys): the ranks' gradients
    summed, this rank's part of the sum."""
    n = group_size(group)
    if n == 1:
        return t
    dim = dim % t.dim()
    if _differentiable(t, grad, ("slice", "reduce_scatter"),
                       "all_gather_cat"):
        return _AllGatherCat.apply(t, group, dim, sizes, grad)
    big = t.shape[dim] if sizes is None else max(sizes)
    part = _pad_dim(t, dim, big)
    if sizes is None:
        sizes = [big] * n
    if _route(part, group) == "card":
        parts = _SHARED[group].exchange(
            part, lambda r, x: x.narrow(dim, 0, sizes[r]))
        return torch.cat(parts, dim=dim)
    parts = [torch.empty_like(part) for _ in range(n)]
    dist.all_gather(parts, part.contiguous(), group=group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                     dim=dim)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (n, ...) -> (n, ...): block j goes to rank j, and block j of
    the result came from rank j. Differentiable: the exchange is its own
    inverse, so the backward is the same all-to-all of the gradient."""
    if group_size(group) == 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllToAll.apply(t, group)
    if _route(t, group) == "card":
        me = dist.get_rank(group)
        return torch.stack(_SHARED[group].exchange(t, lambda r, x: x[me]))
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def sum_grad(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself, whose gradient is summed over ``group`` on the
    backward: where a tensor every rank holds whole enters work that each
    rank does on its own part (the input of a column-parallel layer), each
    rank's gradient is one part of the whole."""
    if group_size(group) == 1 or not (torch.is_grad_enabled()
                                      and t.requires_grad):
        return t
    return _SumGrad.apply(t, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, grad):
        ctx.group, ctx.grad = group, grad
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = all_reduce_sum(g, ctx.group)
        return g, None, None


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim, sizes, grad):
        n = group_size(group)
        ctx.group, ctx.dim, ctx.grad = group, dim, grad
        ctx.sizes = list(sizes) if sizes is not None else [t.shape[dim]] * n
        ctx.me = dist.get_rank(group)
        return all_gather_cat(t, group, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "reduce_scatter":
            g = all_reduce_sum(g, ctx.group)
        start = sum(ctx.sizes[:ctx.me])
        return (g.narrow(ctx.dim, start, ctx.sizes[ctx.me]).contiguous(),
                None, None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.group), None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class RingShift:
    """One hop of the ring: this rank's tensor goes to the previous rank of
    ``group`` and the next rank's arrives (``wait()`` returns it); with
    ``to="next"`` the mirror hop, to the next rank and from the previous
    one. Every rank of the group takes part, with a tensor of one shape and
    dtype. Started at construction, so that work queued before ``wait``
    overlaps it; on ranks that share one card the staging buffers are the
    hop, done by the time the constructor returns."""

    def __init__(self, t: torch.Tensor, group, to: str = "previous"):
        if to not in ("previous", "next"):
            raise ValueError(f"to= 'previous' or 'next', got {to!r}")
        n, r = group_size(group), dist.get_rank(group)
        step = -1 if to == "previous" else 1
        dst, src = (r + step) % n, (r - step) % n
        self.reqs = []
        if _route(t, group) == "card":
            self.out = _SHARED[group].exchange(
                t, lambda q, x: x if q == src else None)[src]
            return
        self.src = t.contiguous()
        self.out = torch.empty_like(self.src)
        self.reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, self.src,
                       dist.get_global_rank(group, dst), group),
            dist.P2POp(dist.irecv, self.out,
                       dist.get_global_rank(group, src), group)])

    def wait(self) -> torch.Tensor:
        for req in self.reqs:
            req.wait()
        return self.out


def broadcast_tensors(tensors: List[Optional[torch.Tensor]], src: int = 0,
                      group=None, device=None
                      ) -> List[Optional[torch.Tensor]]:
    """Rank ``src``'s list of tensors (entries may be None) on every rank
    of ``group`` (the default group when None): shapes and dtypes go first
    as one object, then each tensor. Non-source ranks pass a list of the
    same length (its entries are ignored) and get tensors on ``device``."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return tensors
    me = dist.get_rank()
    meta = [None if t is None else (tuple(t.shape), t.dtype)
            for t in tensors] if me == src else [None]
    box = [meta]
    dist.broadcast_object_list(box, src=src, group=group)
    out = []
    for i, m in enumerate(box[0]):
        if m is None:
            out.append(None)
            continue
        shape, dtype = m
        t = tensors[i] if me == src else torch.empty(
            shape, dtype=dtype, device=device)
        group = group or dist.group.WORLD
        if _route(t, group) == "card":
            root = dist.get_group_rank(group, src)
            out.append(_SHARED[group].exchange(
                t, lambda r, x: x if r == root else None)[root])
            continue
        buf = t.contiguous()
        dist.broadcast(buf, src=src, group=group)
        out.append(buf)
    return out


def _pad_dim(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``t`` zero-padded at the end of ``dim`` to ``size``."""
    if t.shape[dim] == size:
        return t
    shape = list(t.shape)
    shape[dim] = size - t.shape[dim]
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


# ---------------------------------------------------------------------------
# local launcher: ranks as spawned processes (tests, chip_smoke.py)
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, port: int, backend: str,
               device: str, timeout_s: float, args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device))
    initialize(device, backend=backend,
               init_method=f"tcp://127.0.0.1:{port}", world_size=world,
               rank=rank, timeout_s=timeout_s)
    fn(rank, *args)
    # not on a failure: the rank exits at once and the launcher ends the
    # others, which a barrier here would keep waiting
    shutdown()


def spawn(fn: Callable, world: int, *args, backend: str = "gloo",
          device: str = "cpu", timeout_s: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (the spawn start
    method: nothing of this process is inherited, CUDA included), each a
    rank of a process group on ``tcp://127.0.0.1:<free port>`` whose
    collectives time out after ``timeout_s``. ``fn`` must be importable by
    name. Raises if any rank fails."""
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main, args=(fn, world, free_port(), backend,
                                         device, timeout_s, args),
                       nprocs=world, join=True, start_method="spawn")
