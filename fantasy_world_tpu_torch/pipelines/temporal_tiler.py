"""Temporal latent tiling for long-video denoising
(``pipelines/temporal_tiler.py``) in PyTorch: slide a window over the
latent-frame axis, run the denoiser per window, and blend the overlapping
outputs with 0.5-shifted linear ramps, which sum to 1 where two windows
overlap. The blend is f32, on the device of the tensors.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


def build_1d_mask(length: int, left_bound: bool, right_bound: bool,
                  border_width: int) -> np.ndarray:
    """Ones, with a ramp (i + 0.5) / border over ``border_width`` frames at
    each side that is not a bound of the whole axis."""
    x = np.ones((length,), np.float32)
    if border_width == 0:
        return x
    ramp = (np.arange(border_width) + 0.5) / border_width
    if not left_bound:
        x[:border_width] = ramp
    if not right_bound:
        x[-border_width:] = ramp[::-1]
    return x


def window_plan(T: int, size: int, stride: int) -> List[Tuple[int, int]]:
    """(start, end) of each window: one every ``stride`` frames, less those
    that the window before already reaches the end with."""
    plan = []
    for t in range(0, T, stride):
        if t - stride >= 0 and t - stride + size >= T:
            continue
        plan.append((t, min(t + size, T)))
    return plan


def temporal_tiled_forward(model_fn: Callable[..., torch.Tensor],
                           tensors: Dict[str, torch.Tensor],
                           sliding_window_size: int,
                           sliding_window_stride: int,
                           slice_names: Sequence[str] = ("latents", "y"),
                           **static_kwargs) -> torch.Tensor:
    """``model_fn(**tensors, **static_kwargs)`` over sliding windows of the
    frame axis (2) of the (B, C, T, H, W) tensors named in ``slice_names``
    (the others pass whole), the outputs blended; returned in the dtype of
    the first sliced tensor."""
    names = [n for n in slice_names if tensors.get(n) is not None]
    ref = tensors[names[0]]
    T = ref.shape[2]
    value = None
    weight = torch.zeros((1, 1, T, 1, 1), dtype=torch.float32,
                         device=ref.device)
    border = sliding_window_size - sliding_window_stride
    for t0, t1 in window_plan(T, sliding_window_size, sliding_window_stride):
        kwargs = dict(tensors)
        for n in names:
            kwargs[n] = tensors[n][:, :, t0:t1]
        out = model_fn(**kwargs, **static_kwargs).float()
        if value is None:
            value = out.new_zeros((out.shape[0], out.shape[1], T)
                                  + tuple(out.shape[3:]))
        mask = torch.as_tensor(build_1d_mask(t1 - t0, t0 == 0, t1 == T,
                                             border), device=out.device
                               ).view(1, 1, -1, 1, 1)
        value[:, :, t0:t1] += out * mask
        weight[:, :, t0:t1] += mask
    return (value / weight).to(ref.dtype)
