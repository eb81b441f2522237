"""Flash-attention forward: hand-written Hopper kernels and their plain
PyTorch version.

The three CUDA entry points in ``csrc/flash_attention.cu`` replace the
three Pallas forward kernels of ``fantasy_world_tpu/ops/flash_attention.py``
on the denoise path; the routing below copies ``_flash_forward``'s:

  * D <= 64 and H even  -> ``d64``     (``_fa_kernel_pair``)
  * else Lk <= 2048     -> ``onekv``   (``_fa_kernel_onekv``)
  * else                -> ``generic`` (``_fa_kernel``)

A tensor on the CPU takes ``attention_plain``; a CUDA tensor launches the
route's kernel or raises. The kernels are compiled with nvcc for sm_90a
into ``build/kernels/`` at the repository root on first use (keyed by a hash
of the source) and loaded with ctypes.

Layout is (B, L, H, D). The kernels take bf16 only and read q/k/v in place
through their batch/row/head strides (unit stride on D); the output is a
new contiguous (B, Lq, H, D) tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

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

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# Launches per route: each wrapper adds one where it launches its kernel.
LAUNCHES: Dict[str, int] = {r: 0 for r in ROUTES}

_LIB: Optional[ctypes.CDLL] = None
_BUILD_LOG = ""
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for r in ROUTES:
        LAUNCHES[r] = 0


def route(num_heads: int, head_dim: int, lk: int) -> str:
    """Which kernel a (H, D, Lk) attention takes (``_flash_forward``)."""
    if head_dim <= 64 and num_heads % 2 == 0:
        return "d64"
    if lk <= ONEKV_MAX_LK:
        return "onekv"
    return "generic"


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, *, chunk_elems: int = 1 << 27
                    ) -> torch.Tensor:
    """What every kernel computes, in plain PyTorch: q multiplied by
    scale*log2(e) in f32 and rounded to q.dtype, f32 logits in the exp2
    domain, exact max-shifted softmax with an f32 row sum, P rounded to
    v.dtype before an f32 P.V, divided by the sum, returned in q.dtype.

    Chunked over query rows (at most ``chunk_elems`` f32 logits at a
    time), so it runs at the production shapes on the card, where the full
    DiT self-attention logits would take ~85 GB."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    kt = k.permute(0, 2, 3, 1).float()               # (B, H, D, Lk)
    vt = v.permute(0, 2, 1, 3).float()               # (B, H, Lk, D)
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    rows = max(1, chunk_elems // max(1, B * H * Lk))
    for i in range(0, Lq, rows):
        qc = (q[:, i:i + rows].float() * (scale * _LOG2E)).to(q.dtype)
        s = torch.matmul(qc.float().permute(0, 2, 1, 3), kt)
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        o = torch.matmul(p.to(v.dtype).float(), vt) / p.sum(dim=-1,
                                                            keepdim=True)
        out[:, i:i + rows] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


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


def build_kernels() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _LIB, _BUILD_LOG
    with _LOCK:
        if _LIB is not None:
            return _LIB
        tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        lib_path = BUILD_DIR / f"libfa_{tag}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{res.stdout}\n{res.stderr}")
            _BUILD_LOG = res.stdout + res.stderr
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                    + [ctypes.c_longlong] * 9 + [ctypes.c_float,
                                                 ctypes.c_void_p])
        for sym in _SYMBOL.values():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.fa_error_string.argtypes = [ctypes.c_int]
        lib.fa_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def build_log() -> str:
    """nvcc/ptxas output of the last build in this process ('' if the
    library was already built)."""
    return _BUILD_LOG


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


def launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           scale: float) -> torch.Tensor:
    """Launch one kernel on CUDA tensors whose D is one it is built for."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if k.shape != (B, Lk, H, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.device.type != "cuda":
        raise ValueError(f"the {kernel} kernel runs on CUDA tensors, got "
                         f"{q.device}")
    if D not in _KERNEL_D[kernel]:
        raise ValueError(f"the {kernel} kernel is built for head_dim "
                         f"{_KERNEL_D[kernel]}, got {D}")
    if Lk == 0:
        raise ValueError("attention over zero keys")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.device)
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    if Lq == 0:
        return out
    lib = build_kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, _SYMBOL[kernel])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Lq, Lk, H, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], float(scale * _LOG2E), stream)
    if rc != 0:
        raise RuntimeError(f"{_SYMBOL[kernel]} failed: "
                           f"{lib.fa_error_string(rc).decode()} ({rc})")
    LAUNCHES[kernel] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Lq, H, D), k/v: (B, Lk, H, D) -> (B, Lq, H, D) in q.dtype."""
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    kernel = route(q.shape[2], D, k.shape[1])
    dk = next((d for d in _KERNEL_D[kernel] if d >= D), None)
    if dk is None:
        raise ValueError(f"head_dim {D} exceeds the {kernel} kernel's "
                         f"{_KERNEL_D[kernel][-1]}")
    if dk != D:
        q, k, v = (F.pad(t, (0, dk - D)) for t in (q, k, v))
    out = launch(kernel, q, k, v, scale)
    return out[..., :D] if dk != D else out
