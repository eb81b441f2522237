"""The samplers (``sampler.py``) in PyTorch: the user-facing
``generate_video`` API of the Wan2.1 FantasyWorld model
(``FantasyWorldSampler``, over ``pipelines/wan_video.py``) and of
Wan2.2-Fun-A14B-Control-Camera (``Wan22Sampler``, over
``pipelines/wan_video_22.py``).

Each is built from modules already on their device or from the reference
checkpoint layout (``from_checkpoint``), optionally with a MoGe model for
the scene-scale normalization of the camera path;
``generate_video(prompt, neg_prompt, image, camera_params, ...)`` returns
the uint8 frames and the geometry prediction, and ``export`` writes the
MP4 and the colored PLY. ``FantasyWorldSampler.generate_videos`` runs a
batch of clips in one denoise. Each generate call passes the serving
options (``tea_cache_l1_thresh``, ``tea_cache_model_id``,
``segment_size``, ``gen_ckpt_path``) to the denoise; ``quant`` at
``from_checkpoint`` (or the pipelines' ``quantize``) rewrites the
denoiser's large linears.

``FantasyWorldSampler.generate_video(mesh=..., ulysses=...)`` is the
multi-GPU clip, one process per rank over a pipeline sharded with
``pipe.shard(mesh)``: rank 0 runs the encoders (umT5, CLIP, the VAE
encode, MoGe) and broadcasts the conditioning, so the ranks cannot
diverge; every rank denoises; rank 0 alone decodes and returns the clip
(the others return (None, None)) and exports it. The other ranks need
no encoders (``from_checkpoint(encoders=False)``, as the CLIs load
them). ``Wan22Sampler`` does
the same over a ``DualModelDenoiser`` split with ``denoiser.shard(mesh)``
(or ``from_checkpoint(mesh=)``, which builds each expert split): rank 0
conditions (umT5, the tiled VAE encode, MoGe, the control latents) and
decodes.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .cli.moge_scale import moge_scale_normalize
from .hostops.camera import (camera_matrices, extri_intri_to_pose_encoding,
                             plucker_from_pose_encoding)
from .models.moge.infer import moge_infer
from .models.moge.model import MoGe
from .pipelines.tea_cache import DEFAULT_MODEL_ID
from .pipelines.units import run_condition
from .pipelines.wan_video import FantasyWorldPipeline
from .pipelines.wan_video_22 import (DualModelDenoiser,
                                     control_camera_latents_from_plucker)


def image_pm1(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, 3) in [0, 1] -> (height, width, 3) f32 in [-1, 1], through
    8-bit and PIL's default resize as the reference does. PIL is imported
    only to resize: at the target size its resize returns a copy."""
    q = (image * 255).astype(np.uint8)
    if q.shape[:2] != (height, width):
        from PIL import Image
        q = np.asarray(Image.fromarray(q).resize((width, height)))
    return (q / 255.0 * 2 - 1).astype(np.float32)


def read_image(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB")) / 255.0


class FantasyWorldSampler:
    """Wan2.1 FantasyWorld sampler over a ``FantasyWorldPipeline``.

    ``stage_callback(name)``, where given, runs after each conditioning
    stage and the decode are queued ("moge" when a MoGe model scales the
    camera path, "camera", "clip", "vae_encode", "t5_pos", "t5_neg",
    "vae_decode"); ``progress_callback(done, total)`` after each denoise
    step."""

    def __init__(self, pipe: FantasyWorldPipeline,
                 moge: Optional[MoGe] = None):
        self.pipe = pipe
        self.moge = moge

    @classmethod
    def from_checkpoint(cls, wan_ckpt_path: str, model_ckpt: str, *,
                        device, dtype: torch.dtype = torch.bfloat16,
                        tokenizer_path: Optional[str] = None,
                        moge_ckpt: Optional[str] = None,
                        quant: Optional[str] = None, encoders: bool = True
                        ) -> "FantasyWorldSampler":
        """``quant`` ("int8" / "fp8") quantizes the fusion model after
        load. ``encoders`` False: no umT5, CLIP, VAE or MoGe, for a mesh
        rank other than 0 (rank 0 conditions and decodes)."""
        from .convert.checkpoint import load_pipeline
        from .convert.moge import load_moge
        pipe = load_pipeline(wan_ckpt_path, model_ckpt, device=device,
                             dtype=dtype, tokenizer_path=tokenizer_path,
                             encoders=encoders)
        if quant:
            pipe.quantize(quant)
        return cls(pipe, None if moge_ckpt is None or not encoders
                   else load_moge(moge_ckpt, device=device, dtype=dtype))

    # -- conditioning -------------------------------------------------------

    def prepare_camera(self, camera_params: List, image: np.ndarray,
                       height: int, width: int, using_scale: bool = True,
                       stage=None) -> np.ndarray:
        """Camera list -> Plucker video (1, S, H, W, 6), scale-normalized
        first when ``using_scale``: by MoGe's depth of ``image`` when the
        sampler has a MoGe model (then ``stage("moge")``), else only
        rebased on the first camera."""
        extr, intr = camera_matrices(camera_params)
        if using_scale:
            infer = None if self.moge is None else functools.partial(
                moge_infer, self.moge)
            extr = moge_scale_normalize(image, extr, intr, moge_infer=infer)
            if infer is not None and stage is not None:
                stage("moge")
        pose_enc = extri_intri_to_pose_encoding(extr[:, :3, :], intr,
                                                (height, width))
        return plucker_from_pose_encoding(pose_enc, (height, width))

    def _condition(self, prompt, image, camera_params, using_scale, height,
                   width, num_frames, stage):
        """Plucker features, CLIP tokens, y and the positive context of one
        clip."""
        pipe = self.pipe
        img = image_pm1(image, height, width)
        plucker_fea = None
        if camera_params is not None:
            plucker_fea = pipe.encode_plucker(self.prepare_camera(
                camera_params, image, height, width, using_scale, stage))
        stage("camera")
        clip_feature = pipe.encode_clip(img)
        stage("clip")
        y = pipe.encode_y(img, num_frames, height, width)
        stage("vae_encode")
        ctx = pipe.encode_prompt(prompt)
        stage("t5_pos")
        return plucker_fea, clip_feature, y, ctx

    # -- generation ---------------------------------------------------------

    def generate_video(self, prompt: str, neg_prompt: str = "",
                       image: Optional[np.ndarray] = None,
                       image_path: Optional[str] = None,
                       camera_params: Optional[List] = None,
                       using_scale: bool = True, seed: Optional[int] = 1024,
                       height: int = 336, width: int = 592,
                       num_frames: int = 81, sample_steps: int = 50,
                       cfg_scale: float = 5.0, progress_callback=None,
                       stage_callback=None,
                       tea_cache_l1_thresh: Optional[float] = None,
                       tea_cache_model_id: str = DEFAULT_MODEL_ID,
                       segment_size: Optional[int] = None,
                       gen_ckpt_path: Optional[str] = None,
                       mesh=None, ulysses: bool = False
                       ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """image (H, W, 3) in [0, 1], or image_path -> (uint8 frames
        (T, H, W, 3), geometry prediction {name: f32 numpy}). The serving
        options go to ``FantasyWorldPipeline.denoise``. ``mesh`` /
        ``ulysses``: the multi-GPU clip (every rank calls this; rank 0
        returns the clip, the others (None, None))."""
        from .parallel.distributed import broadcast_tensors
        stage = stage_callback or (lambda name: None)
        meshed = mesh is not None and not mesh.trivial
        cond = [None] * 5
        if not meshed or mesh.rank == 0:
            if image is None:
                image = read_image(image_path)
            pl, clip, y, ctx_pos = self._condition(
                prompt, image, camera_params, using_scale, height, width,
                num_frames, stage)
            ctx_neg = self.pipe.encode_prompt(neg_prompt)
            stage("t5_neg")
            cond = [pl, clip, y, ctx_pos, ctx_neg]
        if meshed:
            cond = broadcast_tensors(cond, src=0, device=self.pipe.device)
        pl, clip, y, ctx_pos, ctx_neg = cond
        latents, prediction = self.pipe.denoise(
            ctx_pos, ctx_neg, clip, y, height, width, num_frames=num_frames,
            num_inference_steps=sample_steps, cfg_scale=cfg_scale, seed=seed,
            plucker_fea=pl, progress_callback=progress_callback,
            tea_cache_l1_thresh=tea_cache_l1_thresh,
            tea_cache_model_id=tea_cache_model_id,
            segment_size=segment_size, gen_ckpt_path=gen_ckpt_path,
            **({"mesh": mesh, "ulysses": ulysses} if meshed else {}))
        if meshed and mesh.rank != 0:
            return None, None
        video = self.pipe.decode_video(latents)
        stage("vae_decode")
        return video, {k: v.float().cpu().numpy()
                       for k, v in (prediction or {}).items()}

    def generate_videos(self, prompts: List[str],
                        images: Optional[List[np.ndarray]] = None,
                        image_paths: Optional[List[str]] = None,
                        camera_params: Optional[List[List]] = None,
                        neg_prompt: str = "", using_scale: bool = True,
                        seeds: Optional[List[int]] = None,
                        height: int = 336, width: int = 592,
                        num_frames: int = 81, sample_steps: int = 50,
                        cfg_scale: float = 5.0, progress_callback=None,
                        tea_cache_l1_thresh: Optional[float] = None,
                        tea_cache_model_id: str = DEFAULT_MODEL_ID,
                        segment_size: Optional[int] = None,
                        gen_ckpt_path: Optional[str] = None,
                        mesh=None, ulysses: bool = False
                        ) -> List[Tuple[np.ndarray, Dict[str, np.ndarray]]]:
        """B clips in one denoise (a CFG batch of 2B); conditioning and the
        decode run per clip. Row i is ``generate_video(prompts[i], ...,
        seed=seeds[i])`` (seeds default to 0..B-1). ``mesh`` /
        ``ulysses``: as in ``generate_video`` (the 2B rows split over
        'data' where they divide); rank 0 returns the clips, the others an
        empty list."""
        from .parallel.distributed import broadcast_tensors
        B = len(prompts)
        seeds = list(range(B)) if seeds is None else list(seeds)
        meshed = mesh is not None and not mesh.trivial
        cond = [None] * 5
        if not meshed or mesh.rank == 0:
            if images is None:
                images = [read_image(p) for p in image_paths]
            if len(images) != B or len(seeds) != B:
                raise ValueError(f"{B} prompts, {len(images)} images, "
                                 f"{len(seeds)} seeds")
            # the negative prompt is the same for every clip: encoded once
            ctx_n = self.pipe.encode_prompt(neg_prompt)
            rows = [self._condition(prompts[i], images[i],
                                    None if camera_params is None
                                    else camera_params[i], using_scale,
                                    height, width, num_frames,
                                    lambda name: None)
                    for i in range(B)]
            pls, clips, ys, ctx_p = (list(c) for c in zip(*rows))
            cond = [torch.cat(ctx_p), torch.cat([ctx_n] * B),
                    None if clips[0] is None else torch.cat(clips),
                    torch.cat(ys),
                    None if pls[0] is None else torch.cat(pls)]
        if meshed:
            cond = broadcast_tensors(cond, src=0, device=self.pipe.device)
        latents, prediction = self.pipe.denoise(
            *cond[:4], height, width, num_frames=num_frames,
            num_inference_steps=sample_steps, cfg_scale=cfg_scale,
            seed=seeds, plucker_fea=cond[4],
            progress_callback=progress_callback,
            tea_cache_l1_thresh=tea_cache_l1_thresh,
            tea_cache_model_id=tea_cache_model_id,
            segment_size=segment_size, gen_ckpt_path=gen_ckpt_path,
            **({"mesh": mesh, "ulysses": ulysses} if meshed else {}))
        if meshed and mesh.rank != 0:
            return []
        return [(self.pipe.decode_video(latents[i:i + 1]),
                 {k: v[i:i + 1].float().cpu().numpy()
                  for k, v in (prediction or {}).items()})
                for i in range(B)]

    # -- export -------------------------------------------------------------

    @staticmethod
    def export(video: np.ndarray, prediction: Dict[str, np.ndarray],
               output_dir: str, fps: int = 16, conf_threshold: float = 1.0,
               stride: int = 4) -> Dict[str, str]:
        """video.mp4 (or its .npy) and ``recon_confthresh{c}.ply`` in
        output_dir; returns {"video": path, "ply": path or None}."""
        from .hostops.export import (get_pointclouds,
                                     save_colored_pointcloud_ply, save_video)
        os.makedirs(output_dir, exist_ok=True)
        out = {"video": save_video(video, os.path.join(output_dir,
                                                       "video.mp4"), fps=fps),
               "ply": None}
        if prediction:
            points = get_pointclouds(prediction, fix_first_frame=True)
            valid = prediction["depth_conf"][0] >= conf_threshold
            out["ply"] = os.path.join(output_dir,
                                      f"recon_confthresh{conf_threshold}.ply")
            save_colored_pointcloud_ply(points, video.astype(np.float32),
                                        out["ply"], stride=stride,
                                        valid_mask=valid)
        return out


class Wan22Sampler:
    """Wan2.2-Fun-A14B-Control-Camera sampler: umT5 and the Wan2.1 VAE in
    a ``FantasyWorldPipeline``, the two experts in a ``DualModelDenoiser``;
    the camera path enters as control-camera latents, and there is no CLIP
    branch. The VAE encodes and decodes over the reference's tile grid: at
    480x832 the untiled passes do not fit on an 80 GB card beside an expert
    and umT5. The conditioning runs through ``run_condition``
    (``pipelines/units.py``). ``stage_callback`` names "moge", "camera",
    each conditioning unit (``PipelineUnit.name``: "t5" for both prompts,
    "vae_encode" for y, ...), the denoiser's "control_adapter_high" /
    "_low" and "swap", and "vae_decode"."""

    def __init__(self, pipe: FantasyWorldPipeline,
                 denoiser: DualModelDenoiser, moge: Optional[MoGe] = None):
        self.pipe = pipe
        self.denoiser = denoiser
        self.moge = moge
        if pipe.cfg is None:
            # the conditioning units read the experts' configuration
            pipe.cfg = denoiser.cfg

    @classmethod
    def from_checkpoint(cls, wan_ckpt_path: str, model_ckpt_high: str,
                        model_ckpt_low: str, *, device,
                        dtype: torch.dtype = torch.bfloat16,
                        tokenizer_path: Optional[str] = None,
                        moge_ckpt: Optional[str] = None,
                        timestep_boundary: float = 900.0,
                        quant: Optional[str] = None,
                        mesh=None, encoders: bool = True) -> "Wan22Sampler":
        """``quant`` quantizes both experts as they load; ``mesh`` builds
        each as this rank's part of it (``place_experts``); ``encoders``
        False: no umT5, VAE or MoGe, as on a mesh rank other than 0."""
        from .convert.checkpoint import load_wan22
        from .convert.moge import load_moge
        pipe, denoiser = load_wan22(
            wan_ckpt_path, model_ckpt_high, model_ckpt_low, device=device,
            dtype=dtype, tokenizer_path=tokenizer_path,
            timestep_boundary=timestep_boundary, quant=quant, mesh=mesh,
            encoders=encoders)
        return cls(pipe, denoiser, None if moge_ckpt is None or not encoders
                   else load_moge(moge_ckpt, device=device, dtype=dtype))

    prepare_camera = FantasyWorldSampler.prepare_camera

    def generate_video(self, prompt: str, neg_prompt: str = "",
                       image: Optional[np.ndarray] = None,
                       image_path: Optional[str] = None,
                       end_image: Optional[np.ndarray] = None,
                       camera_params: Optional[List] = None,
                       using_scale: bool = True, seed: Optional[int] = 42,
                       height: int = 480, width: int = 832,
                       num_frames: int = 81, sample_steps: int = 50,
                       cfg_scale: float = 5.0, progress_callback=None,
                       stage_callback=None,
                       tea_cache_l1_thresh: Optional[float] = None,
                       tea_cache_model_id: str = DEFAULT_MODEL_ID,
                       segment_size: Optional[int] = None,
                       gen_ckpt_path: Optional[str] = None,
                       mesh=None, ulysses: bool = False
                       ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """image and end_image (H, W, 3) in [0, 1], or image_path ->
        (uint8 frames (T, H, W, 3), geometry prediction {name: f32
        numpy}). The serving options go to ``DualModelDenoiser.denoise``.
        ``mesh`` / ``ulysses``: the multi-GPU clip (every rank calls this
        with the same arguments; rank 0 reads the images, conditions and
        returns the clip, the others (None, None))."""
        from .parallel.distributed import broadcast_tensors
        stage = stage_callback or (lambda name: None)
        meshed = mesh is not None and not mesh.trivial
        cond = [None] * 4
        if not meshed or mesh.rank == 0:
            if image is None:
                image = read_image(image_path)
            img = image_pm1(image, height, width)
            end = None if end_image is None else image_pm1(end_image, height,
                                                           width)
            ctrl = None
            if camera_params is not None:
                ctrl = torch.as_tensor(control_camera_latents_from_plucker(
                    self.prepare_camera(camera_params, image, height, width,
                                        using_scale, stage)))
            stage("camera")
            shared, posi, nega = run_condition(
                self.pipe, prompt, neg_prompt, input_image=img,
                end_image=end, height=height, width=width,
                num_frames=num_frames, seed=seed, cfg_scale=cfg_scale,
                tiled=True, stage_callback=stage)
            cond = [posi["context"], nega["context"], shared["y"], ctrl]
        if meshed:
            if cond[3] is not None:
                cond[3] = cond[3].to(self.denoiser.device)
            cond = broadcast_tensors(cond, src=0,
                                     device=self.denoiser.device)
        latents, prediction = self.denoiser.denoise(
            cond[0], cond[1], cond[2], height, width,
            num_frames=num_frames,
            num_inference_steps=sample_steps, cfg_scale=cfg_scale, seed=seed,
            control_camera_latents=cond[3],
            progress_callback=progress_callback,
            stage_callback=stage, tea_cache_l1_thresh=tea_cache_l1_thresh,
            tea_cache_model_id=tea_cache_model_id,
            segment_size=segment_size, gen_ckpt_path=gen_ckpt_path,
            **({"mesh": mesh, "ulysses": ulysses} if meshed else {}))
        if meshed and mesh.rank != 0:
            return None, None
        video = self.pipe.decode_video(latents, tiled=True)
        stage("vae_decode")
        return video, {k: v.float().cpu().numpy()
                       for k, v in prediction.items()}

    export = staticmethod(FantasyWorldSampler.export)

