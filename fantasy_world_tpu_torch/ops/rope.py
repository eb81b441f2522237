"""Rotary position embeddings and the timestep embedding (``ops/rope.py``).

Angle tables are built on the host in float64 numpy, exactly as the JAX
package builds them, and cast once to f32 on the target device; the
rotations are f32 elementwise math returned in the input dtype.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _freqs_1d_f64(dim: int, end: int, theta: float) -> np.ndarray:
    inv = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float64)
                           / dim))
    return np.outer(np.arange(end, dtype=np.float64), inv)


@functools.lru_cache(maxsize=32)
def rope_table_3d(head_dim: int, end: int = 1024, theta: float = 10000.0):
    """Per-axis (f, h, w) angle tables: f gets head_dim - 4*(head_dim//6)
    channels, h and w 2*(head_dim//6) each."""
    d_f = head_dim - 4 * (head_dim // 6)
    d_hw = 2 * (head_dim // 6)
    return (_freqs_1d_f64(d_f, end, theta), _freqs_1d_f64(d_hw, end, theta),
            _freqs_1d_f64(d_hw, end, theta))


def build_angles_3d(head_dim: int, f: int, h: int, w: int,
                    n_extra_per_frame: int = 0) -> np.ndarray:
    """(seq, head_dim//2) float64 angle grid over an (f, h, w) lattice; with
    ``n_extra_per_frame`` each frame is prefixed by that many zero-angle
    tokens (the aggregator's special tokens)."""
    tf, th, tw = rope_table_3d(head_dim)
    ff = np.broadcast_to(tf[:f][:, None, None, :], (f, h, w, tf.shape[1]))
    hh = np.broadcast_to(th[:h][None, :, None, :], (f, h, w, th.shape[1]))
    ww = np.broadcast_to(tw[:w][None, None, :, :], (f, h, w, tw.shape[1]))
    grid = np.concatenate([ff, hh, ww], axis=-1)
    if n_extra_per_frame:
        d2 = grid.shape[-1]
        grid = grid.reshape(f, h * w, d2)
        extra = np.zeros((f, n_extra_per_frame, d2), np.float64)
        grid = np.concatenate([extra, grid], axis=1)
        return grid.reshape(f * (n_extra_per_frame + h * w), d2)
    return grid.reshape(f * h * w, grid.shape[-1])


def cos_sin_half_from_angles(angles: np.ndarray, device=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(seq, d/2) angles -> (seq, d) duplicated f32 cos/sin tables for
    ``apply_rope_half`` (f64 trig on the host, cast once)."""
    c, s = np.cos(angles), np.sin(angles)
    return (torch.as_tensor(np.concatenate([c, c], -1), dtype=torch.float32,
                            device=device),
            torch.as_tensor(np.concatenate([s, s], -1), dtype=torch.float32,
                            device=device))


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """Rotate contiguous half-split pairs, out = x*cos + rotate_half(x)*sin.
    x: (B, seq, heads, head_dim); cos/sin: (seq, head_dim)."""
    d = x.shape[-1]
    x1 = x[..., : d // 2].float()
    x2 = x[..., d // 2:].float()
    c1, c2 = cos[:, None, : d // 2], cos[:, None, d // 2:]
    s1, s2 = sin[:, None, : d // 2], sin[:, None, d // 2:]
    return torch.cat([x1 * c1 - x2 * s1, x2 * c2 + x1 * s2],
                     dim=-1).to(x.dtype)


@functools.lru_cache(maxsize=32)
def rope2d_freq_table(dim_per_axis: int, max_pos: int,
                      frequency: float = 100.0):
    """f32 cos/sin tables (max_pos, dim_per_axis) for one spatial axis."""
    exponents = np.arange(0, dim_per_axis, 2, dtype=np.float64) / dim_per_axis
    inv_freq = 1.0 / (frequency ** exponents)
    ang = np.outer(np.arange(max_pos, dtype=np.float64), inv_freq)
    ang = np.concatenate([ang, ang], axis=-1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def rope2d_tables_from_positions(positions: torch.Tensor, head_dim: int, *,
                                 frequency: float = 100.0,
                                 max_pos: int = 2048):
    """(..., seq, 2) int (y, x) positions -> per-token (cos, sin) tables,
    each (..., seq, 1, head_dim) laid out [y-half | x-half]."""
    cos_t, sin_t = rope2d_freq_table(head_dim // 2, max_pos, frequency)
    cos_t = torch.as_tensor(cos_t, device=positions.device)
    sin_t = torch.as_tensor(sin_t, device=positions.device)
    py, px = positions[..., 0].long(), positions[..., 1].long()
    cos = torch.cat([cos_t[py], cos_t[px]], dim=-1)[..., :, None, :]
    sin = torch.cat([sin_t[py], sin_t[px]], dim=-1)[..., :, None, :]
    return cos, sin


def apply_rope_2d_tables(x: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor) -> torch.Tensor:
    """2D rope from per-token tables; x: (..., seq, heads, head_dim). Each
    half of the head dim is rotated rotate-half style by its axis."""
    xf = x.float()
    half = xf.shape[-1] // 2
    q = half // 2
    out = []
    for i in (0, 1):
        feats = xf[..., i * half:(i + 1) * half]
        c = cos[..., i * half:(i + 1) * half].float()
        s = sin[..., i * half:(i + 1) * half].float()
        f1, f2 = feats[..., :q], feats[..., q:]
        out.append(f1 * c[..., :q] - f2 * s[..., :q])
        out.append(f2 * c[..., q:] + f1 * s[..., q:])
    return torch.cat(out, dim=-1).to(x.dtype)


def grid_positions_2d(h: int, w: int, n_special: int = 0) -> np.ndarray:
    """(n_special + h*w, 2) int32 positions: specials at (0, 0), patches at
    1-based (y, x)."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([ys.ravel(), xs.ravel()], axis=-1).astype(np.int32) + 1
    if n_special:
        pos = np.concatenate([np.zeros((n_special, 2), np.int32), pos], 0)
    return pos


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """[cos | sin] timestep embedding, f32; frequencies from f64 on the
    host."""
    half = dim // 2
    freqs = torch.as_tensor(
        np.power(10000.0, -np.arange(half, dtype=np.float64) / half),
        dtype=torch.float32, device=position.device)
    sinusoid = position.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)


def deinterleave_indices(head_dim: int) -> np.ndarray:
    """Channel permutation per head, out[j] = in[idx[j]] with
    idx = [0, 2, 4, ..., 1, 3, 5, ...]: interleaved RoPE pairs -> the
    rotate-half layout."""
    return np.concatenate([np.arange(0, head_dim, 2),
                           np.arange(1, head_dim, 2)])


def permute_qk_out_channels(arr: np.ndarray, head_dim: int, axis: int = -1
                            ) -> np.ndarray:
    """Permute a weight, bias or scale along its output-channel axis by the
    per-head de-interleave; the axis holds heads * head_dim channels, heads
    contiguous."""
    arr = np.asarray(arr)
    n = arr.shape[axis]
    idx = (np.arange(0, n, head_dim)[:, None]
           + deinterleave_indices(head_dim)[None, :]).reshape(-1)
    return np.take(arr, idx, axis=axis)
