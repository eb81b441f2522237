"""Wan2.2-Fun-A14B-Control-Camera dual-expert denoise
(``pipelines/wan_video_22.py``) in PyTorch.

Two fusion models of one config -- the high-noise and the low-noise
expert, each with its Reward-LoRA merged -- switched at a timestep
boundary (900): steps with t > boundary run the high expert, the rest the
low one, and the geometry heads run on the last step's expert. The camera
enters at the patch embedding through the control adapter
(``WanDiT.control_adapter_tokens``), evaluated once per clip and per
expert; there is no CLIP branch. CFG runs as one batch of two and the
update is f32, as in ``FantasyWorldPipeline.denoise``.

Two bf16 experts do not fit on an 80 GB card beside umT5 and the
activations, so when the experts sit on different devices only the active
one is on the card: the other waits in pinned host memory and the two
trade places, tensor by tensor, at the boundary (``swap_residency``).

Not ported here: TeaCache, the segmented/resumable denoise, meshes and
quantization.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.fusion.model import FusionModel
from ..schedulers.flow_match import FlowMatchScheduler
from .wan_video import FantasyWorldPipeline


def control_camera_latents_from_plucker(plucker: np.ndarray) -> np.ndarray:
    """(1, F, H, W, 6) Plucker video -> (1, 24, (F - 1) / 4 + 1, H, W)
    control latents: frame 0 repeated 4 times, then each 4 consecutive
    frames folded into channels."""
    video = np.transpose(plucker[0], (3, 0, 1, 2))[None]      # (1,6,F,H,W)
    video = np.concatenate([np.repeat(video[:, :, 0:1], 4, axis=2),
                            video[:, :, 1:]], axis=2)          # (1,6,F+3,H,W)
    lat = np.transpose(video, (0, 2, 1, 3, 4))                 # (1,f4,6,H,W)
    b, f4, c, h, w = lat.shape
    lat = lat.reshape(b, f4 // 4, 4, c, h, w).transpose(0, 1, 3, 2, 4, 5)
    return lat.reshape(b, f4 // 4, c * 4, h, w).transpose(0, 2, 1, 3, 4)


def _tensors(module: nn.Module):
    return list(module.parameters()) + list(module.buffers())


# pinned host memory is taken in slabs of this size, each packed with
# tensors: PyTorch's pinned allocator rounds every request up to a power of
# two, so an expert pinned tensor by tensor would take ~1.5x its size
PIN_SLAB_BYTES = 1 << 30


@torch.no_grad()
def pin_to_host(module: nn.Module) -> nn.Module:
    """Move ``module``'s tensors into pinned host memory, one at a time,
    packed into slabs of ``PIN_SLAB_BYTES`` (or of one larger tensor)."""
    slab, off = None, 0
    for t in _tensors(module):
        n = t.numel() * t.element_size()
        if slab is None or off + n > slab.numel():
            slab = torch.empty(max(PIN_SLAB_BYTES, n), dtype=torch.uint8,
                               pin_memory=True)
            off = 0
        host = slab[off:off + n].view(t.dtype).view(t.shape)
        off += -(-n // 256) * 256
        host.copy_(t.data)
        t.data = host
    return module


@torch.no_grad()
def swap_residency(resident: nn.Module, waiting: nn.Module) -> None:
    """``waiting`` (in pinned host memory) moves to ``resident``'s device,
    and ``resident`` into the host buffers ``waiting`` leaves, tensor by
    tensor: the card holds at most one tensor more than the resident model.
    Both copies of a pair are queued on the current stream, the upload
    before the download that overwrites its source. The two modules must
    hold the same tensors in the same order (two experts of one config)."""
    pairs = list(zip(_tensors(resident), _tensors(waiting)))
    for a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"experts differ: {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    for a, b in pairs:
        incoming = b.data.to(a.device, non_blocking=True, copy=True)
        b.data.copy_(a.data, non_blocking=True)
        a.data, b.data = b.data, incoming
    if pairs and pairs[0][1].is_cuda:
        torch.cuda.current_stream().synchronize()


class DualModelDenoiser:
    """The high- and low-noise experts and their switch."""

    # the noise is the reference's torch-generator draw
    generate_noise = staticmethod(FantasyWorldPipeline.generate_noise)

    def __init__(self, high: FusionModel, low: FusionModel,
                 timestep_boundary: float = 900.0):
        self.experts = {True: high, False: low}
        self.cfg = high.cfg
        self.timestep_boundary = float(timestep_boundary)

    @staticmethod
    def _device_of(model: FusionModel) -> torch.device:
        return model.dit.patch_embedding.weight.device

    @property
    def device(self) -> torch.device:
        """The device the experts run on: the card when either is there."""
        devs = [self._device_of(m) for m in self.experts.values()]
        return next((d for d in devs if d.type != "cpu"), devs[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.experts[True].dit.patch_embedding.weight.dtype

    def activate(self, high: bool) -> bool:
        """Bring the wanted expert to the compute device, swapping it with
        the other when it waits on the host. Returns whether it swapped."""
        want, other = self.experts[high], self.experts[not high]
        dev = self.device
        if self._device_of(want) == dev:
            return False
        if self._device_of(other) != dev:
            raise RuntimeError("neither expert is on the compute device")
        swap_residency(other, want)
        return True

    @torch.no_grad()
    def denoise(self, context_pos, context_neg, y, height: int, width: int,
                num_frames: int = 81, num_inference_steps: int = 50,
                cfg_scale: float = 5.0, seed: Optional[int] = None,
                control_camera_latents: Optional[np.ndarray] = None,
                progress_callback: Optional[Callable[[int, int], None]] = None,
                stage_callback: Optional[Callable[[str], None]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (final latents (1, z, f, h, w), geometry prediction of
        the positive row). ``progress_callback(done, total)`` runs after
        each step is queued; ``stage_callback`` after an expert's control
        tokens ("control_adapter_high" / "_low") and after a swap
        ("swap")."""
        stage = stage_callback or (lambda name: None)
        if num_frames % 4 != 1:
            num_frames = (num_frames + 2) // 4 * 4 + 1
        f = (num_frames - 1) // 4 + 1
        sched = FlowMatchScheduler().set_timesteps(num_inference_steps)
        ts, pairs = sched.timesteps, sched.sigma_pairs()
        n, n_high = len(ts), int((ts > self.timestep_boundary).sum())
        dev, dtype = self.device, self.dtype
        B = context_pos.shape[0]
        dcfg = self.cfg.dit
        lat_ch = dcfg.in_dim - y.shape[1] if dcfg.require_vae_embedding \
            else dcfg.in_dim
        latents = self.generate_noise(
            (B, lat_ch, f, height // 8, width // 8), seed).to(dev, dtype)
        ctx = torch.cat([context_pos, context_neg]).to(dev, dtype)
        y2 = torch.cat([y, y]).to(dev, dtype)
        ctrl = None if control_camera_latents is None else torch.as_tensor(
            np.asarray(control_camera_latents), device=dev, dtype=dtype)
        tokens: Dict[bool, Optional[torch.Tensor]] = {}
        prediction = None
        for i in range(n):
            high, last = i < n_high, i == n - 1
            if self.activate(high):
                stage("swap")
            expert = self.experts[high]
            if high not in tokens:
                tokens[high] = (None if ctrl is None else
                                expert.dit.control_adapter_tokens(ctrl))
                stage("control_adapter_" + ("high" if high else "low"))
            t = torch.full((2 * B,), float(ts[i]), dtype=torch.float32,
                           device=dev)
            noise, prediction = expert.joint_forward(
                torch.cat([latents] * 2), t, ctx, None, y2,
                return_prediction=last, control_tokens=tokens[high])
            pos, neg = noise[:B].float(), noise[B:].float()
            pred = neg + cfg_scale * (pos - neg)
            latents = (latents.float() + pred * float(pairs[i, 1] - pairs[i, 0])
                       ).to(dtype)
            if progress_callback is not None:
                progress_callback(i + 1, n)
        return latents, {k: v[:B] for k, v in prediction.items()}
