"""Flash attention on the card: hand-written Hopper kernels, their plain
PyTorch versions, and the autograd Function that training differentiates.

The CUDA entry points in ``csrc/`` replace every Pallas kernel of
``fantasy_world_tpu/ops/flash_attention.py``. The forward routing copies
``_flash_forward``'s:

  * D <= 64 and H even  -> ``d64``     (``_fa_kernel_pair``)
  * else Lk <= 2048     -> ``onekv``   (``_fa_kernel_onekv``)
  * else                -> ``generic`` (``_fa_kernel``)

``generic`` and ``d64`` are one TMA and wgmma template
(``csrc/flash_attention_sm90.cu``); ``onekv`` is a TMA and wgmma kernel of
its own (``csrc/flash_attention_onekv.cu``) that finds the exact row max in
a first pass and rescales nothing. Each forward kernel can also store the
softmax statistics (m2, l) of its rows (the ``with_stats`` output of
``_fa_kernel``/``_fa_kernel_onekv``).
The backward is ``fa_bwd_dq`` then ``fa_bwd_dkv`` (``_fa_bwd_dq_kernel``,
``_fa_bwd_dkv_kernel``), built for head dims 64, 96 and 128 on the same TMA
and wgmma design (``csrc/flash_attention_bwd.cu``; both share
``csrc/sm90_common.cuh``).

``flash_attention`` differentiates like ``_flash_diff``: when grad mode is
on and an input requires grad it runs ``FlashAttention`` -- the stats
forward, saving (q, k, v, o, lse2 = m2 + log2 l), and the two backward
kernels -- and otherwise the plain forward kernel.

A tensor on the CPU takes the plain versions (``attention_plain``,
``attention_plain_stats``, ``attention_backward_plain``); a CUDA tensor
launches the kernels or raises. The kernels are compiled with nvcc for
sm_90a into ``build/kernels/`` at the repository root on first use, one
shared library per source, all sources at once (keyed by a hash of
``csrc/``), and loaded with ctypes.

Layout is (B, L, H, D). The kernels take bf16 only and read q/k/v (and o,
do) in place through their batch/row/head strides (unit stride on D);
outputs are new contiguous (B, L, H, D) tensors, statistics (B, Lq, H) f32.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

_LOG2E = 1.4426950408889634
# _flash_forward's default block_k: every key fits in one block below this
ONEKV_MAX_LK = 2048

ROUTES = ("generic", "onekv", "d64")
_SYMBOL = {"generic": "fa_fwd_generic", "onekv": "fa_fwd_onekv",
           "d64": "fa_fwd_d64"}
# head dims each kernel is built for; smaller D is zero-padded up (off the
# main path: a copy), as the TPU wrapper pads D to its lane width
_KERNEL_D = {"generic": (96, 128), "onekv": (128,), "d64": (64,)}
BWD_D = (64, 96, 128)
BWD_KERNELS = ("bwd_dq", "bwd_dkv")

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# Launches per kernel: each wrapper adds one where it launches its kernel.
# "<route>" is the plain forward, "<route>_stats" the forward that also
# stores (m2, l), "bwd_dq_<D>" / "bwd_dkv_<D>" the backward at head dim D.
LAUNCHES: Dict[str, int] = {
    k: 0 for k in (*ROUTES, *(f"{r}_stats" for r in ROUTES),
                   *(f"{b}_{d}" for b in BWD_KERNELS for d in BWD_D))}

# every entry point, {symbol: function}, once built and bound
_ENTRY_POINTS: Optional[Dict[str, Callable]] = None
_BUILD_LOG = ""
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def route(num_heads: int, head_dim: int, lk: int) -> str:
    """Which kernel a (H, D, Lk) attention takes (``_flash_forward``)."""
    if head_dim <= 64 and num_heads % 2 == 0:
        return "d64"
    if lk <= ONEKV_MAX_LK:
        return "onekv"
    return "generic"


def kernel_dim(num_heads: int, head_dim: int, lk: int) -> int:
    """The head dim the route's kernels run at: D, or D zero-padded up."""
    kernel = route(num_heads, head_dim, lk)
    dk = next((d for d in _KERNEL_D[kernel] if d >= head_dim), None)
    if dk is None:
        raise ValueError(f"head_dim {head_dim} exceeds the {kernel} "
                         f"kernel's {_KERNEL_D[kernel][-1]}")
    return dk


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _rows_per_chunk(B: int, H: int, Lk: int, chunk_elems: int) -> int:
    return max(1, chunk_elems // max(1, B * H * Lk))


def _acc(t: torch.Tensor) -> torch.Tensor:
    """t in its accumulation dtype: f32, or f64 for f64 inputs."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale * log2(e) in f32, rounded to q.dtype, as (B, H, L, D)."""
    return _acc(_acc(q).mul(scale * _LOG2E).to(q.dtype)).permute(0, 2, 1, 3)


def attention_plain_stats(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, scale: float, *,
                          chunk_elems: int = 1 << 27
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """What every forward kernel computes, in plain PyTorch: q multiplied by
    scale*log2(e) in f32 and rounded to q.dtype, f32 logits s2 in the exp2
    domain, exact max-shifted softmax with an f32 row sum, P rounded to
    v.dtype before an f32 P.V, divided by the sum, returned in q.dtype; and
    the statistics m2 = max_k s2 and l = sum_k exp2(s2 - m2) as (B, Lq, H)
    f32 (f64 for f64 inputs, as every product here).

    Chunked over query rows (at most ``chunk_elems`` f32 logits at a
    time), so it runs at the production shapes on the card, where the full
    DiT self-attention logits would take ~85 GB."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    kt = _acc(k.permute(0, 2, 3, 1))                 # (B, H, D, Lk)
    vt = _acc(v.permute(0, 2, 1, 3))                 # (B, H, Lk, D)
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    m2 = torch.empty((B, Lq, H), dtype=vt.dtype, device=q.device)
    l = torch.empty_like(m2)
    rows = _rows_per_chunk(B, H, Lk, chunk_elems)
    for i in range(0, Lq, rows):
        s = torch.matmul(_scaled_q(q[:, i:i + rows], scale), kt)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        sums = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(_acc(p.to(v.dtype)), vt) / sums
        out[:, i:i + rows] = o.permute(0, 2, 1, 3).to(q.dtype)
        m2[:, i:i + rows] = m[..., 0].transpose(1, 2)
        l[:, i:i + rows] = sums[..., 0].transpose(1, 2)
    return out, m2, l


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, *, chunk_elems: int = 1 << 27
                    ) -> torch.Tensor:
    """The forward output of ``attention_plain_stats``."""
    return attention_plain_stats(q, k, v, scale, chunk_elems=chunk_elems)[0]


def attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse2: torch.Tensor, do: torch.Tensor,
                             scale: float, *, chunk_elems: int = 1 << 27):
    """What the two backward kernels compute, in plain PyTorch, with their
    rounding points: s2 from q scaled and rounded as in the forward,
    p = exp2(s2 - lse2), dp = do.v^T, delta = rowsum(do * o) in f32,
    ds = p (dp - delta); dq = scale * bf16(ds).k, dk = scale * bf16(ds)^T.q
    with the unscaled q, dv = bf16(p)^T.do -- "bf16" being the inputs'
    dtype. Returns (dq, dk, dv) in the inputs' dtypes.

    Chunked over query rows like the forward, dk/dv accumulated in f32
    across chunks."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    kt = _acc(k.permute(0, 2, 1, 3))                 # (B, H, Lk, D)
    vt = _acc(v.permute(0, 2, 1, 3))
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.zeros((B, H, Lk, D), dtype=kt.dtype, device=q.device)
    dv = torch.zeros_like(dk)
    rows = _rows_per_chunk(B, H, Lk, chunk_elems)
    for i in range(0, Lq, rows):
        sl = slice(i, i + rows)
        qc = _acc(q[:, sl].permute(0, 2, 1, 3))      # (B, H, r, D)
        doc = _acc(do[:, sl].permute(0, 2, 1, 3))
        s = torch.matmul(_scaled_q(q[:, sl], scale), kt.transpose(-1, -2))
        p = torch.exp2(s - lse2[:, sl].transpose(1, 2)[..., None])
        dp = torch.matmul(doc, vt.transpose(-1, -2))
        delta = (doc * _acc(o[:, sl].permute(0, 2, 1, 3))).sum(
            dim=-1, keepdim=True)
        ds = _acc((p * (dp - delta)).to(q.dtype))
        dq[:, sl] = (torch.matmul(ds, kt) * scale).permute(
            0, 2, 1, 3).to(q.dtype)
        dk += torch.matmul(ds.transpose(-1, -2), qc)
        dv += torch.matmul(_acc(p.to(v.dtype)).transpose(-1, -2), doc)
    return (dq,
            (dk * scale).permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the attention kernels need it to build")
    return found


def _resolve(libs: Dict[str, ctypes.CDLL], sym: str) -> Callable:
    """The entry point ``sym`` of whichever library exports it (libraries
    by name, the first that has it), so a tree may move an entry point from
    one source to another."""
    for name in sorted(libs):
        fn = getattr(libs[name], sym, None)
        if fn is not None:
            return fn
    raise RuntimeError(f"no kernel library exports {sym} (searched "
                       f"{', '.join(sorted(libs)) or 'none'})")


def _bind(libs: Dict[str, ctypes.CDLL]) -> Dict[str, Callable]:
    """Every entry point, resolved across ``libs`` and typed: {symbol:
    function}."""
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    fwd = [vp] * 6 + [i32] * 5 + [i64] * 9 + [f32, vp]
    argtypes = {"fa_fwd_generic": fwd, "fa_fwd_onekv": fwd, "fa_fwd_d64": fwd,
                "fa_bwd_dq": [vp] * 8 + [i32] * 5 + [i64] * 15
                + [f32, f32, vp],
                "fa_bwd_dkv": [vp] * 8 + [i32] * 5 + [i64] * 12
                + [f32, f32, vp],
                "fa_error_string": [i32]}
    fns = {}
    for sym, args in argtypes.items():
        fn = fns[sym] = _resolve(libs, sym)
        fn.argtypes = args
        fn.restype = ctypes.c_char_p if sym == "fa_error_string" \
            else ctypes.c_int
    return fns


def build_kernels() -> Dict[str, Callable]:
    """Compile (once per hash of ``csrc/``) and load the kernel libraries:
    one nvcc per ``.cu`` source, all started together. Returns every entry
    point, {symbol: function}, from whichever library exports it."""
    global _ENTRY_POINTS, _BUILD_LOG
    with _LOCK:
        if _ENTRY_POINTS is not None:
            return _ENTRY_POINTS
        files = sorted(p for p in CSRC.iterdir()
                       if p.suffix in (".cu", ".cuh"))
        digest = hashlib.sha256()
        for f in files:
            digest.update(f.name.encode() + b"\0" + f.read_bytes())
        tag = digest.hexdigest()[:16]
        paths = {f.stem: BUILD_DIR / f"lib{f.stem}_{tag}.so"
                 for f in files if f.suffix == ".cu"}
        todo = {stem: path for stem, path in paths.items()
                if not path.exists()}
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = {}
            for stem, path in todo.items():
                tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                       "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v", "-o", str(tmp),
                       str(CSRC / f"{stem}.cu")]
                procs[stem] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            logs, failed = [], []
            for stem, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                logs.append(out)
                if proc.returncode != 0:
                    failed.append(f"{stem}.cu ({proc.returncode}):\n{out}")
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
            for stem, (tmp, _) in procs.items():
                os.replace(tmp, todo[stem])
            _BUILD_LOG = "".join(logs)
        _ENTRY_POINTS = _bind({stem: ctypes.CDLL(str(path))
                       for stem, path in paths.items()})
        return _ENTRY_POINTS


def build_log() -> str:
    """nvcc/ptxas output of the last build in this process ('' if the
    libraries were already built)."""
    return _BUILD_LOG


def _call(sym: str, *args) -> None:
    fns = build_kernels()
    rc = fns[sym](*args)
    if rc != 0:
        msg = fns["fa_error_string"](rc).decode()
        raise RuntimeError(f"{sym} failed: {msg} ({rc})")


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the attention kernels take bfloat16, "
                        f"got {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a unit stride on D, got "
                         f"{t.stride()}")
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"{name} must be 16-byte aligned with strides in "
                         f"multiples of 8 elements, got {t.stride()}")


def _check_stats(name: str, t: torch.Tensor, shape, device) -> None:
    if (t.device != device or t.dtype != torch.float32
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} f32 "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_qkv(kernel: str, q, k, v, dims) -> None:
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if k.shape != (B, Lk, H, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.device.type != "cuda":
        raise ValueError(f"the {kernel} kernel runs on CUDA tensors, got "
                         f"{q.device}")
    if D not in dims:
        raise ValueError(f"the {kernel} kernel is built for head_dim "
                         f"{dims}, got {D}")
    if Lk == 0:
        raise ValueError("attention over zero keys")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.device)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           scale: float, *, stats: bool = False):
    """Launch one forward kernel on CUDA tensors whose D is one it is built
    for. Returns o, or (o, m2, l) with ``stats``."""
    _check_qkv(kernel, q, k, v, _KERNEL_D[kernel])
    B, Lq, H, D = q.shape
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    m2 = l = None
    if stats:
        m2 = torch.empty((B, Lq, H), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m2)
    if Lq:
        with torch.cuda.device(q.device):
            _call(_SYMBOL[kernel], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), m2.data_ptr() if stats else None,
                  l.data_ptr() if stats else None, B, Lq, k.shape[1], H, D,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  float(scale * _LOG2E), _stream(q.device))
        LAUNCHES[f"{kernel}_stats" if stats else kernel] += 1
    return (out, m2, l) if stats else out


def _check_backward(q, k, v, o, lse2, do) -> None:
    _check_qkv("backward", q, k, v, BWD_D)
    B, Lq, H, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if t is None:
            continue
        if t.shape != q.shape:
            raise ValueError(f"{name}{tuple(t.shape)} != q{tuple(q.shape)}")
        _check(name, t, q.device)
    _check_stats("lse2", lse2, (B, Lq, H), q.device)


def launch_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse2: torch.Tensor, do: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``fa_bwd_dq`` on CUDA tensors whose D is 64, 96 or 128.
    Returns (dq, delta = rowsum(do * o) as (B, Lq, H) f32)."""
    _check_backward(q, k, v, o, lse2, do)
    B, Lq, H, D = q.shape
    dq = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, Lq, H), dtype=torch.float32, device=q.device)
    if Lq:
        with torch.cuda.device(q.device):
            _call("fa_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), do.data_ptr(), lse2.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), B, Lq, k.shape[1], H, D,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *o.stride()[:3], *do.stride()[:3], float(scale * _LOG2E),
                  float(scale), _stream(q.device))
        LAUNCHES[f"bwd_dq_{D}"] += 1
    return dq, delta


def launch_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lse2: torch.Tensor, do: torch.Tensor, delta: torch.Tensor,
                   scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``fa_bwd_dkv`` on CUDA tensors whose D is 64, 96 or 128, with
    the delta that ``launch_bwd_dq`` returned. Returns (dk, dv)."""
    _check_backward(q, k, v, None, lse2, do)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    _check_stats("delta", delta, (B, Lq, H), q.device)
    dk = torch.empty((B, Lk, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if Lq == 0:
        return dk.zero_(), dv.zero_()
    with torch.cuda.device(q.device):
        _call("fa_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
              do.data_ptr(), lse2.data_ptr(), delta.data_ptr(),
              dk.data_ptr(), dv.data_ptr(), B, Lq, Lk, H, D,
              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
              *do.stride()[:3], float(scale * _LOG2E), float(scale),
              _stream(q.device))
    LAUNCHES[f"bwd_dkv_{D}"] += 1
    return dk, dv


def launch_backward(q, k, v, o, lse2, do, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``fa_bwd_dq`` then ``fa_bwd_dkv`` on one stream: contiguous
    (dq, dk, dv)."""
    dq, delta = launch_bwd_dq(q, k, v, o, lse2, do, scale)
    return (dq, *launch_bwd_dkv(q, k, v, lse2, do, delta, scale))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _pad_d(ts, D: int, dk: int):
    return ts if dk == D else tuple(F.pad(t, (0, dk - D)) for t in ts)


def _forward(q, k, v, scale: float, stats: bool):
    if q.device.type == "cpu":
        return (attention_plain_stats(q, k, v, scale) if stats
                else attention_plain(q, k, v, scale))
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    H, D, Lk = q.shape[2], q.shape[3], k.shape[1]
    kernel, dk = route(H, D, Lk), kernel_dim(H, D, Lk)
    out = launch(kernel, *_pad_d((q, k, v), D, dk), scale, stats=stats)
    if dk == D:
        return out
    return (out[0][..., :D], *out[1:]) if stats else out[..., :D]


def flash_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Forward only: (o, m2, l) with m2/l (B, Lq, H) f32 in the base-2
    domain (``flash_attention(return_stats=True)``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _forward(q, k, v, scale, True)


def flash_attention_backward(q, k, v, o, lse2, do, scale: float):
    """(dq, dk, dv) of ``sum(o * do)`` (``_flash_backward``)."""
    return flash_attention_backward_part(q, k, v, o, lse2, do, scale)[:3]


def flash_attention_backward_part(q, k, v, o, lse2, do, scale: float,
                                  delta: Optional[torch.Tensor] = None):
    """(dq, dk, dv, delta) over the keys ``k``/``v`` of an attention whose
    output ``o`` and statistics ``lse2`` may span more keys (a ring's part:
    the parts' dq sum to the whole attention's); ``fa_bwd_dq`` then
    ``fa_bwd_dkv``. ``delta`` = rowsum(do * o), (B, Lq, H) f32: the one an
    earlier part's call returned goes to ``fa_bwd_dkv`` in place of this
    call's (the same values), and is returned; on the CPU (the plain
    version) it is None."""
    if q.device.type == "cpu":
        return (*attention_backward_plain(q, k, v, o, lse2, do, scale), None)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    H, D, Lk = q.shape[2], q.shape[3], k.shape[1]
    dk = kernel_dim(H, D, Lk)
    q, k, v, o, do = _pad_d((q, k, v, o, do.contiguous()), D, dk)
    dq, own = launch_bwd_dq(q, k, v, o, lse2, do, scale)
    delta = own if delta is None else delta
    grads = (dq, *launch_bwd_dkv(q, k, v, lse2, do, delta, scale))
    if dk != D:
        grads = tuple(g[..., :D] for g in grads)
    return (*grads, delta)


class FlashAttention(torch.autograd.Function):
    """``_flash_diff``: the forward runs the stats forward and saves
    (q, k, v, o, lse2 = m2 + log2 l); the backward runs dq and dk/dv.
    Gradients come back contiguous; autograd scatters them into strided
    inputs (VGGT's fused qkv views)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, m2, l = _forward(q, k, v, scale, True)
        ctx.save_for_backward(q, k, v, o, m2 + torch.log2(l))
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse2 = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, o, lse2, do, ctx.scale),
                None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Lq, H, D), k/v: (B, Lk, H, D) -> (B, Lq, H, D) in q.dtype.
    Differentiable through ``FlashAttention`` when grad mode is on and an
    input requires grad; otherwise the plain forward kernel."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale, False)
