"""Wan2.2 TI2V-5B denoise (``pipelines/ti2v.py``) in PyTorch: the standalone
DiT (``WanDiT.forward``), no geometry branch.

TI2V-5B conditions on the input image by fusing its 38-block VAE latent
into latent frame 0 (``units.ImageEmbedderFused``): the frame's tokens are
modulated at t = 0 (the separated timestep), and after every step the
frame is set back to the clean latent. CFG runs as one batch of two, the
timestep stays f32 (bf16's spacing near t = 1000 is 4) and the Euler
update is f32, as in ``FantasyWorldPipeline.denoise``.

The noise is a ``torch.Generator`` draw seeded with ``seed``; the JAX
package draws from ``jax.random``, so a caller that needs its noise passes
it as ``noise``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.wan.dit import WanDiT
from ..schedulers.flow_match import FlowMatchScheduler
from .wan_video import FantasyWorldPipeline


@torch.no_grad()
def denoise_ti2v(dit: WanDiT, context_pos, context_neg, height: int,
                 width: int, num_frames: int = 121,
                 num_inference_steps: int = 50, cfg_scale: float = 5.0,
                 seed: Optional[int] = None, first_frame_latents=None,
                 noise: Optional[torch.Tensor] = None,
                 progress_callback: Optional[Callable[[int, int], None]]
                 = None) -> torch.Tensor:
    """Returns the final latents (B, out_dim, f, height / 16, width / 16)
    on the 38-block VAE's latent grid. ``noise`` (that shape) replaces the
    seeded draw (f32 from ``torch.Generator('cpu')``, seed 0 when None);
    ``progress_callback(done, n)`` runs after each step is queued."""
    cfg = dit.cfg
    if num_frames % 4 != 1:
        num_frames = (num_frames + 2) // 4 * 4 + 1
    f = (num_frames - 1) // 4 + 1
    sched = FlowMatchScheduler().set_timesteps(num_inference_steps)
    weight = dit.patch_embedding.weight
    dev, dtype = weight.device, weight.dtype
    B = context_pos.shape[0]
    shape = (B, cfg.out_dim, f, height // 16, width // 16)
    if noise is None:
        noise = FantasyWorldPipeline.generate_noise(
            shape, 0 if seed is None else seed)
    if tuple(noise.shape) != shape:
        raise ValueError(f"noise {tuple(noise.shape)}, want {shape}")
    latents = noise.to(dev, dtype, copy=True)
    fuse = (cfg.seperated_timestep and cfg.fuse_vae_embedding_in_latents
            and first_frame_latents is not None)
    if fuse:
        first = first_frame_latents.to(dev, dtype)
        latents[:, :, 0:1] = first
    ctx = torch.cat([context_pos, context_neg]).to(dev, dtype)
    pairs = sched.sigma_pairs()
    n = len(sched.timesteps)
    for i in range(n):
        t = torch.full((2 * B,), float(sched.timesteps[i]),
                       dtype=torch.float32, device=dev)
        out = dit(torch.cat([latents] * 2), t, ctx, fuse_first_frame=fuse)
        pos, neg = out[:B].float(), out[B:].float()
        pred = neg + cfg_scale * (pos - neg)
        latents = (latents.float() + pred * float(pairs[i, 1] - pairs[i, 0])
                   ).to(dtype)
        if fuse:
            latents[:, :, 0:1] = first
        if progress_callback is not None:
            progress_callback(i + 1, n)
    return latents
