"""FantasyWorld generation pipeline (``pipelines/wan_video.py``) in
PyTorch: conditioning -> denoise -> decode.

  * ``tokenize`` / ``encode_prompt``: umT5 ids -> context, zeroed past each
    prompt's length; the HF tokenizer loads lazily from a local path;
  * ``encode_image``: CLIP's 257 tokens and y = [4-channel first-frame mask
    | VAE latent of the masked video];
  * ``generate_noise``, ``encode_plucker`` and the CFG-pair flow-matching
    ``denoise`` with the geometry heads on the last step;
  * ``decode_video``: the full-sequence causal VAE decode, or the
    reference's tiled one, to uint8 frames.

Not ported here: TeaCache, segmented/resumable loops, sliding windows,
multi-device meshes and the Wan2.2 TI2V VAE.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.fusion.model import FusionModel
from ..models.wan.camera import CameraPoseEncoder
from ..models.wan.clip import CLIPVision, preprocess_image
from ..models.wan.t5 import T5Encoder
from ..models.wan.vae import (WanVAE, tile_plan, vae_decode_tiled,
                               vae_encode_tiled)
from ..schedulers.flow_match import FlowMatchScheduler


class FantasyWorldPipeline:
    """Holds the fusion model, the camera pose encoder and the encoders,
    built on one device in one dtype; any of them may be absent when its
    stage is not run."""

    def __init__(self, fusion: Optional[FusionModel] = None,
                 pose_encoder: Optional[CameraPoseEncoder] = None, *,
                 t5: Optional[T5Encoder] = None,
                 clip: Optional[CLIPVision] = None,
                 vae: Optional[WanVAE] = None,
                 tokenizer_path: Optional[str] = None, text_len: int = 512):
        self.fusion = fusion
        self.pose_encoder = pose_encoder
        self.t5, self.clip, self.vae = t5, clip, vae
        self.cfg = None if fusion is None else fusion.cfg
        self.tokenizer_path = tokenizer_path
        self.text_len = text_len
        # the HF tokenizer, loaded on first use; any callable with its
        # interface may be installed instead
        self.tokenizer = None

    def _weight(self) -> torch.Tensor:
        if self.fusion is not None:
            return self.fusion.dit.patch_embedding.weight
        for m in (self.t5, self.clip, self.vae, self.pose_encoder):
            if m is not None:
                return next(m.parameters())
        raise ValueError("the pipeline holds no module")

    @property
    def device(self) -> torch.device:
        return self._weight().device

    @property
    def dtype(self) -> torch.dtype:
        return self._weight().dtype

    @staticmethod
    def generate_noise(shape, seed: Union[None, int, Sequence[int]] = None
                       ) -> torch.Tensor:
        """f32 noise on the host from ``torch.Generator('cpu')`` seeded
        with ``seed`` (1024 when None), as the reference draws it; a list
        gives one seed per batch row, and row i is then what a single-clip
        run with seed[i] draws. The caller moves it to the device."""
        if isinstance(seed, (list, tuple, np.ndarray)):
            if len(seed) != shape[0]:
                raise ValueError(f"{len(seed)} seeds for {shape[0]} rows")
            return torch.stack([
                torch.randn(tuple(shape[1:]), dtype=torch.float32,
                            generator=torch.Generator("cpu").manual_seed(
                                int(s))) for s in seed])
        g = torch.Generator("cpu").manual_seed(1024 if seed is None
                                               else int(seed))
        return torch.randn(shape, generator=g, dtype=torch.float32)

    # -- text ---------------------------------------------------------------

    def tokenize(self, prompt: str) -> Tuple[np.ndarray, np.ndarray]:
        """Cleaned prompt -> (ids, mask), (1, text_len), padded to
        text_len."""
        if self.tokenizer is None:
            if self.tokenizer_path is None:
                raise ValueError("no tokenizer_path configured; pass ids")
            from transformers import AutoTokenizer
            self.tokenizer = AutoTokenizer.from_pretrained(
                self.tokenizer_path)
        from ..utils.textclean import clean_prompt
        enc = self.tokenizer([clean_prompt(prompt)], padding="max_length",
                             truncation=True, max_length=self.text_len,
                             return_tensors="np")
        return (np.asarray(enc["input_ids"], np.int64),
                np.asarray(enc["attention_mask"]))

    @torch.no_grad()
    def encode_prompt(self, prompt: Optional[str] = None, ids=None,
                      mask=None) -> torch.Tensor:
        """(1, L, dim) umT5 context in the pipeline's dtype, zero past each
        prompt's length."""
        if ids is None:
            ids, mask = self.tokenize(prompt)
        dev = self.device
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev)
        mask = torch.as_tensor(np.asarray(mask), device=dev)
        emb = self.t5(ids, mask)
        return emb * (mask[..., None] > 0).to(emb.dtype)

    # -- image --------------------------------------------------------------

    def _image(self, image: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(image), dtype=torch.float32,
                               device=self.device).permute(2, 0, 1)[None]

    @torch.no_grad()
    def encode_clip(self, image: np.ndarray) -> Optional[torch.Tensor]:
        """image (H, W, 3) in [-1, 1] -> (1, 257, dim) CLIP tokens, or None
        when the model takes no image context."""
        if self.clip is None or (self.cfg is not None
                                 and not self.cfg.dit.has_image_input):
            return None
        return self.clip(preprocess_image(self._image(image)).to(self.dtype))

    @torch.no_grad()
    def encode_y(self, image: np.ndarray, num_frames: int, height: int,
                 width: int, end_image: Optional[np.ndarray] = None,
                 tiled: bool = False) -> torch.Tensor:
        """image (H, W, 3) in [-1, 1] -> y (1, 4 + z, f, h, w): the mask of
        the given frames and the VAE latent of the video that holds the
        image, zero frames, and ``end_image`` (same form) as the last frame
        when given. ``tiled`` encodes over the reference's tile grid."""
        img = self._image(image)
        msk = np.ones((1, num_frames, height // 8, width // 8), np.float32)
        msk[:, 1:] = 0
        frames = [img.transpose(0, 1),
                  img.new_zeros((3, num_frames - 1, height, width))]
        if end_image is not None:
            msk[:, -1:] = 1
            frames[1][:, -1] = self._image(end_image)[0]
        msk = np.concatenate([msk[:, 0:1].repeat(4, axis=1), msk[:, 1:]],
                             axis=1)
        msk = msk.reshape(1, msk.shape[1] // 4, 4, height // 8, width // 8)
        msk = msk.transpose(0, 2, 1, 3, 4)[0]                # (4, f, h, w)
        video = torch.cat(frames, dim=1)[None].to(self.dtype)
        lat = (vae_encode_tiled(self.vae, video) if tiled
               else self.vae.encode(video))[0]
        return torch.cat([torch.as_tensor(msk, dtype=lat.dtype,
                                          device=lat.device), lat])[None]

    def encode_image(self, image: np.ndarray, num_frames: int, height: int,
                     width: int) -> Dict[str, Optional[torch.Tensor]]:
        """image (H, W, 3) float in [-1, 1], already (height, width) ->
        {'clip_feature': (1, 257, dim) | None, 'y': (1, 4 + z, f, h, w)}."""
        return {"clip_feature": self.encode_clip(image),
                "y": self.encode_y(image, num_frames, height, width)}

    # -- decode -------------------------------------------------------------

    @torch.no_grad()
    def decode_video(self, latents: torch.Tensor, tiled: bool = False,
                     tile_size=None, tile_stride=None) -> np.ndarray:
        """latents (1, z, f, h, w) -> uint8 frames (T, H, W, 3). ``tiled``
        decodes over the reference's tile grid, or over the given one (in
        latent pixels; give both tile_size and tile_stride, or neither)."""
        x = latents.to(self.vae.conv2.weight.device, self.dtype)
        if tiled:
            video = vae_decode_tiled(self.vae, x,
                                     *tile_plan(tile_size, tile_stride))
        else:
            video = self.vae.decode(x)
        video = video[0].permute(1, 2, 3, 0).float().cpu().numpy()
        return np.clip((video + 1) / 2 * 255, 0, 255).astype(np.uint8)

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
                seed: Union[None, int, Sequence[int]] = None,
                plucker_fea=None,
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
