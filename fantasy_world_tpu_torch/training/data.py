"""A clip -> one flow-matching training batch (``training/data.py``),
through the inference conditioning of ``pipelines/wan_video.py``: the
clean latents of the whole clip (the untiled VAE encode), umT5 on the
prompt, CLIP and y of the first frame, the pose encoder on the clip's
Plucker rays, and a schedule index and Gaussian noise drawn from a
``torch.Generator``. The result is the keyword set of
``training/step.py:flow_match_loss``.

The JAX package draws the index and the noise from ``jax.random``; the
port cannot reproduce those draws, so the two agree on everything but
``noise``, ``sigma`` and ``timestep``."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..schedulers.flow_match import FlowMatchScheduler
from .step import sample_training_inputs


@torch.no_grad()
def build_train_batch(pipe, video_frames: np.ndarray, prompt: str,
                      generator: torch.Generator,
                      plucker_embedding: Optional[np.ndarray] = None,
                      sched: Optional[FlowMatchScheduler] = None,
                      num_train_steps: int = 1000,
                      stage_callback: Optional[Callable[[str], None]] = None
                      ) -> Dict[str, object]:
    """video_frames (T, H, W, 3), uint8 or floats in [0, 1]; ``pipe`` a
    ``FantasyWorldPipeline`` with the VAE, umT5 and CLIP (and the pose
    encoder when ``plucker_embedding`` (1, T, H, W, 6) is given). Returns
    {clean_latents, noise, sigma (float), timestep (1,), context,
    clip_feature (None without an image branch), y[, plucker_fea]}, the
    tensors f32 on the pipeline's device. ``stage_callback(name)`` runs
    after each stage is queued: "vae_encode", "clip", "y", "t5", "noise"
    and "plucker"."""
    stage = stage_callback or (lambda name: None)
    frames = np.asarray(video_frames, np.float32)
    if frames.max() > 1.5:                 # uint8 range
        frames = frames / 255.0
    frames = frames * 2.0 - 1.0
    T, H, W = frames.shape[:3]
    dev, dtype = pipe.device, pipe.dtype
    video = torch.as_tensor(frames.transpose(3, 0, 1, 2)[None]).to(dev,
                                                                   dtype)
    clean_latents = pipe.vae.encode(video).float()
    del video
    stage("vae_encode")
    clip_feature = pipe.encode_clip(frames[0])
    stage("clip")
    y = pipe.encode_y(frames[0], T, H, W)
    stage("y")
    context = pipe.encode_prompt(prompt).float()
    stage("t5")
    sched = sched or FlowMatchScheduler().set_timesteps(num_train_steps)
    noise, sigma, timestep = sample_training_inputs(generator, sched,
                                                    clean_latents.shape)
    stage("noise")
    batch = {
        "clean_latents": clean_latents,
        "noise": noise.to(dev),
        "sigma": sigma,
        "timestep": torch.full((1,), timestep, dtype=torch.float32,
                               device=dev),
        "context": context,
        "clip_feature": None if clip_feature is None else clip_feature.float(),
        "y": y.float(),
    }
    if plucker_embedding is not None:
        batch["plucker_fea"] = pipe.encode_plucker(plucker_embedding).float()
        stage("plucker")
    return batch
