"""FantasyWorld denoise (``pipelines/wan_video.py``) in PyTorch: noise,
Plucker encoding and the CFG-pair flow-matching loop with the geometry
heads on the last step.

Not ported here: TeaCache, segmented/resumable loops, sliding windows and
multi-device meshes (options off the default path), and the conditioning
encoders, VAE and sampler, which come with the next slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.fusion.model import FusionModel
from ..models.wan.camera import CameraPoseEncoder
from ..schedulers.flow_match import FlowMatchScheduler


class FantasyWorldPipeline:
    """Holds the fusion model and the camera pose encoder, built on one
    device in one dtype."""

    def __init__(self, fusion: FusionModel,
                 pose_encoder: Optional[CameraPoseEncoder] = None):
        self.fusion = fusion
        self.pose_encoder = pose_encoder
        self.cfg = fusion.cfg

    @property
    def device(self) -> torch.device:
        return self.fusion.dit.patch_embedding.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.fusion.dit.patch_embedding.weight.dtype

    @staticmethod
    def generate_noise(shape, seed: Optional[int] = None) -> torch.Tensor:
        """f32 noise on the host from ``torch.Generator('cpu')`` seeded
        with ``seed`` (1024 when None), as the reference draws it; the
        caller moves it to the device."""
        g = torch.Generator("cpu").manual_seed(1024 if seed is None
                                               else int(seed))
        return torch.randn(shape, generator=g, dtype=torch.float32)

    @torch.no_grad()
    def encode_plucker(self, plucker_embedding: np.ndarray) -> torch.Tensor:
        """(B, F, H, W, 6) Plucker video -> (B, L, plucker_dim) features."""
        x = torch.as_tensor(np.asarray(plucker_embedding), dtype=self.dtype,
                            device=self.device)
        return self.pose_encoder(x)

    @torch.no_grad()
    def denoise(self, context_pos, context_neg, clip_feature, y,
                height: int, width: int, num_frames: int = 81,
                num_inference_steps: int = 50, cfg_scale: float = 5.0,
                seed: Optional[int] = None, plucker_fea=None,
                progress_callback: Optional[Callable[[int, int], None]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (final latents (B, 16, f, h, w), geometry prediction of
        the positive rows). Each step runs the CFG pair as batch 2 (rows
        [:B] positive, [B:] negative); the CFG combine and the Euler update
        are f32. ``progress_callback(done, total)`` runs after each step's
        work is queued (it does not synchronise)."""
        if num_frames % 4 != 1:
            num_frames = (num_frames + 2) // 4 * 4 + 1
        f = (num_frames - 1) // 4 + 1
        sched = FlowMatchScheduler().set_timesteps(num_inference_steps)
        dev, dtype = self.device, self.dtype
        B = context_pos.shape[0]
        zc = self.cfg.dit.out_dim
        latents = self.generate_noise(
            (B, zc, f, height // 8, width // 8), seed).to(dev, dtype)

        def pair(a, b):
            return torch.cat([a, b], dim=0).to(dev, dtype)

        ctx = pair(context_pos, context_neg)
        clip2 = None if clip_feature is None else pair(clip_feature,
                                                       clip_feature)
        y2 = pair(y, y)
        pl2 = None if plucker_fea is None else pair(plucker_fea, plucker_fea)

        pairs = sched.sigma_pairs()
        n = len(sched.timesteps)
        prediction = None
        for i in range(n):
            last = i == n - 1
            t = torch.full((2 * B,), float(sched.timesteps[i]),
                           dtype=torch.float32, device=dev)
            noise, prediction = self.fusion.joint_forward(
                torch.cat([latents] * 2, dim=0), t, ctx, clip2, y2,
                plucker_fea=pl2, return_prediction=last)
            pos, neg = noise[:B].float(), noise[B:].float()
            pred = neg + cfg_scale * (pos - neg)
            latents = (latents.float() + pred * float(pairs[i, 1] - pairs[i, 0])
                       ).to(dtype)
            if progress_callback is not None:
                progress_callback(i + 1, n)
        # the heads ran on the CFG-doubled batch; keep the positive rows
        prediction = {k: v[:B] for k, v in prediction.items()}
        return latents, prediction
