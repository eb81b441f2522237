"""Declarative conditioning units (``pipelines/units.py``) in PyTorch.

Each unit names the keys of the shared, positive and negative input dicts
it reads and returns its updates; ``PipelineUnitRunner`` threads the three
dicts through a list of units, and ``run_condition`` runs the default list
and returns the dicts instead of denoising (the reference's
``return_condition=True``). ``Wan22Sampler`` conditions through it, and so
does the TI2V-5B path (``pipelines/ti2v.py``), whose ``ImageEmbedderFused``
writes the 38-block VAE's latent of the input image into latent frame 0.

The pipe the units read is a ``FantasyWorldPipeline``: ``cfg.dit``,
``vae`` and ``vae_cfg`` (the 2.1 VAE, or the 38-block one with
``spatial_down`` 16), ``generate_noise``, ``encode_prompt``, ``encode_y``,
``clip_tokens`` (CLIP, when it holds one), ``device`` and ``dtype``. Images
are (H, W, 3) in [-1, 1]; videos (1, 3, T, H, W) in [-1, 1].
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..schedulers.flow_match import FlowMatchScheduler


class PipelineUnit:
    # the name ``run_condition``'s stage callback gives the unit
    name = "unit"

    def __init__(self, seperate_cfg: bool = False, take_over: bool = False,
                 input_params: Optional[Tuple[str, ...]] = None,
                 input_params_posi: Optional[Dict[str, str]] = None,
                 input_params_nega: Optional[Dict[str, str]] = None):
        self.seperate_cfg = seperate_cfg
        self.take_over = take_over
        self.input_params = input_params
        self.input_params_posi = input_params_posi
        self.input_params_nega = input_params_nega

    def process(self, pipe, *args, **kwargs) -> dict:
        raise NotImplementedError


class PipelineUnitRunner:
    """Runs one unit over the three dicts. A ``seperate_cfg`` unit runs
    for the positive side, and for the negative side unless cfg_scale is 1:
    then the negative side takes the positive outputs, as the reference
    does."""

    @torch.no_grad()
    def __call__(self, unit: PipelineUnit, pipe, inputs_shared: dict,
                 inputs_posi: dict, inputs_nega: dict):
        if unit.take_over:
            return unit.process(pipe, inputs_shared=inputs_shared,
                                inputs_posi=inputs_posi,
                                inputs_nega=inputs_nega)
        if unit.seperate_cfg:
            proc = {n: inputs_posi.get(src)
                    for n, src in unit.input_params_posi.items()}
            for n in (unit.input_params or ()):
                proc[n] = inputs_shared.get(n)
            out = unit.process(pipe, **proc)
            inputs_posi.update(out)
            if inputs_shared.get("cfg_scale", 5.0) != 1:
                proc = {n: inputs_nega.get(src)
                        for n, src in unit.input_params_nega.items()}
                for n in (unit.input_params or ()):
                    proc[n] = inputs_shared.get(n)
                inputs_nega.update(unit.process(pipe, **proc))
            else:
                inputs_nega.update(out)
        else:
            proc = {n: inputs_shared.get(n) for n in unit.input_params}
            inputs_shared.update(unit.process(pipe, **proc))
        return inputs_shared, inputs_posi, inputs_nega


def _video(pipe, video) -> torch.Tensor:
    return torch.as_tensor(np.asarray(video), dtype=torch.float32
                           ).to(pipe.device, pipe.dtype)


def _still(pipe, image) -> torch.Tensor:
    """(H, W, 3) -> a one-frame video (1, 3, 1, H, W) in the pipe's dtype."""
    img = torch.as_tensor(np.asarray(image), dtype=torch.float32)
    return img.permute(2, 0, 1)[None, :, None].to(pipe.device, pipe.dtype)


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

class ShapeChecker(PipelineUnit):
    """Height and width rounded up to multiples of 16, frames to 4k + 1."""
    name = "shape_check"

    def __init__(self):
        super().__init__(input_params=("height", "width", "num_frames"))

    def process(self, pipe, height, width, num_frames):
        height = (height + 15) // 16 * 16
        width = (width + 15) // 16 * 16
        if num_frames % 4 != 1:
            num_frames = (num_frames + 2) // 4 * 4 + 1
        return {"height": height, "width": width, "num_frames": num_frames}


class NoiseInitializer(PipelineUnit):
    """The noise on the latent grid of the pipe's VAE (8x or 16x)."""
    name = "noise"

    def __init__(self):
        super().__init__(input_params=("height", "width", "num_frames",
                                       "seed"))

    def process(self, pipe, height, width, num_frames, seed):
        length = (num_frames - 1) // 4 + 1
        sd = getattr(pipe.vae_cfg, "spatial_down", 8)
        shape = (1, pipe.vae_cfg.z_dim, length, height // sd, width // sd)
        return {"noise": pipe.generate_noise(shape, seed=seed)}


class PromptEmbedder(PipelineUnit):
    name = "t5"

    def __init__(self):
        super().__init__(
            seperate_cfg=True,
            input_params_posi={"prompt": "prompt"},
            input_params_nega={"prompt": "negative_prompt"})

    def process(self, pipe, prompt):
        return {"context": pipe.encode_prompt(prompt)}


class InputVideoEmbedder(PipelineUnit):
    """Video to video: the input video's latent noised to the first
    timestep of a schedule at ``denoising_strength``; without an input
    video the latents are the noise."""
    name = "input_video"

    def __init__(self):
        super().__init__(input_params=("input_video", "noise",
                                       "denoising_strength",
                                       "num_inference_steps"))

    def process(self, pipe, input_video, noise, denoising_strength,
                num_inference_steps):
        if input_video is None:
            return {"latents": noise}
        lat = pipe.vae.encode(_video(pipe, input_video))
        sched = FlowMatchScheduler().set_timesteps(
            num_inference_steps, denoising_strength=denoising_strength or 1.0)
        sigma = float(sched.sigmas[0])
        return {"latents": (1 - sigma) * lat.to(noise) + sigma * noise}


class ImageEmbedderVAE(PipelineUnit):
    """y = [the frame mask | the VAE latent of the video holding the input
    image, the end image and the keyframes] (``FantasyWorldPipeline.
    encode_y``); ``tiled`` encodes over the reference's tile grid."""
    name = "vae_encode"

    def __init__(self):
        super().__init__(input_params=("input_image", "end_image",
                                       "num_frames", "height", "width",
                                       "mid_images_list",
                                       "mid_images_id_list", "tiled"))

    def process(self, pipe, input_image, end_image, num_frames, height,
                width, mid_images_list=None, mid_images_id_list=None,
                tiled=False):
        if input_image is None or not pipe.cfg.dit.require_vae_embedding:
            return {}
        mids = None
        if mid_images_list is not None and mid_images_id_list is not None:
            mids = list(zip(mid_images_list, mid_images_id_list))
        return {"y": pipe.encode_y(input_image, num_frames, height, width,
                                   end_image=end_image, mid_images=mids,
                                   tiled=bool(tiled))}


class ImageEmbedderCLIP(PipelineUnit):
    """CLIP's tokens of the input image, and of the end image after them
    when the DiT has an image position embedding."""
    name = "clip"

    def __init__(self):
        super().__init__(input_params=("input_image", "end_image", "height",
                                       "width"))

    def process(self, pipe, input_image, end_image, height, width):
        if input_image is None or pipe.clip is None \
                or not pipe.cfg.dit.has_image_input:
            return {}
        feat = pipe.clip_tokens(input_image)
        if end_image is not None and pipe.cfg.dit.has_image_pos_emb:
            feat = torch.cat([feat, pipe.clip_tokens(end_image)], dim=1)
        return {"clip_feature": feat}


class ImageEmbedderFused(PipelineUnit):
    """TI2V-5B: the input image's VAE latent (the 38-block VAE's, on its
    16x grid) replaces latent frame 0, instead of entering through y."""
    name = "vae_encode_fused"

    def __init__(self):
        super().__init__(input_params=("input_image", "latents", "height",
                                       "width"))

    def process(self, pipe, input_image, latents, height, width):
        if input_image is None \
                or not pipe.cfg.dit.fuse_vae_embedding_in_latents:
            return {}
        z = pipe.vae.encode(_still(pipe, input_image))
        latents = latents.clone()
        latents[:, :, 0:1] = z.to(latents)
        return {"latents": latents, "fuse_vae_embedding_in_latents": True,
                "first_frame_latents": z}


class FunControl(PipelineUnit):
    """Fun-Control: the control video's VAE latent stacked in front of the
    masked-image y channels; CLIP tokens and y zero-filled to the DiT's
    in_dim when absent."""
    name = "fun_control"

    def __init__(self):
        super().__init__(input_params=("control_video", "num_frames",
                                       "height", "width", "clip_feature",
                                       "y", "noise"))

    def process(self, pipe, control_video, num_frames, height, width,
                clip_feature, y, noise):
        if control_video is None:
            return {}
        control = pipe.vae.encode(_video(pipe, control_video))
        y_dim = pipe.cfg.dit.in_dim - control.shape[1] - noise.shape[1]
        if clip_feature is None or y is None:
            clip_feature = control.new_zeros((1, 257, 1280))
            y = control.new_zeros((1, y_dim, (num_frames - 1) // 4 + 1,
                                   height // 8, width // 8))
        else:
            y = y[:, -y_dim:]
        return {"clip_feature": clip_feature,
                "y": torch.cat([control, y.to(control)], dim=1)}


class FunReference(PipelineUnit):
    """Fun-Reference: the VAE latent of a reference still, and its CLIP
    tokens when the pipe holds CLIP."""
    name = "fun_reference"

    def __init__(self):
        super().__init__(input_params=("reference_image", "height", "width"))

    def process(self, pipe, reference_image, height, width):
        if reference_image is None:
            return {}
        out = {"reference_latents": pipe.vae.encode(
            _still(pipe, reference_image))}
        if pipe.clip is not None:
            out["clip_feature"] = pipe.clip_tokens(reference_image)
        return out


class FunCameraControl(PipelineUnit):
    """The Plucker video folded into the control-camera latents of the
    Wan2.2 control adapter."""
    name = "camera_control"

    def __init__(self):
        super().__init__(input_params=("plucker_embedding",))

    def process(self, pipe, plucker_embedding):
        if plucker_embedding is None:
            return {}
        from .wan_video_22 import control_camera_latents_from_plucker
        return {"control_camera_latents_input":
                control_camera_latents_from_plucker(plucker_embedding)}


class SpeedControl(PipelineUnit):
    """The motion bucket, passed through as a tensor."""
    name = "speed_control"

    def __init__(self):
        super().__init__(input_params=("motion_bucket_id",))

    def process(self, pipe, motion_bucket_id):
        if motion_bucket_id is None:
            return {}
        return {"motion_bucket_id": torch.tensor([float(motion_bucket_id)])}


class CfgMerger(PipelineUnit):
    """The positive and negative contexts as one batch of two."""
    name = "cfg_merge"

    def __init__(self):
        super().__init__(take_over=True)

    def process(self, pipe, inputs_shared, inputs_posi, inputs_nega):
        if "context" in inputs_posi and "context" in inputs_nega:
            inputs_shared["context_merged"] = torch.cat(
                [inputs_posi["context"], inputs_nega["context"]], dim=0)
        return inputs_shared, inputs_posi, inputs_nega


DEFAULT_UNITS: Sequence[PipelineUnit] = (
    ShapeChecker(), NoiseInitializer(), PromptEmbedder(),
    InputVideoEmbedder(), ImageEmbedderCLIP(), ImageEmbedderVAE(),
    ImageEmbedderFused(), FunControl(), FunReference(), FunCameraControl(),
    SpeedControl(), CfgMerger(),
)


def run_condition(pipe, prompt: str, negative_prompt: str = "",
                  input_image=None, end_image=None, height: int = 480,
                  width: int = 832, num_frames: int = 81,
                  seed: Optional[int] = None, plucker_embedding=None,
                  cfg_scale: float = 5.0, units=DEFAULT_UNITS,
                  stage_callback: Optional[Callable[[str], None]] = None,
                  **extra_shared):
    """Run ``units`` over the inputs and return (shared, positive,
    negative) dicts instead of denoising. ``stage_callback(unit.name)``
    runs after each unit; ``extra_shared`` adds shared inputs (``tiled``,
    ``input_video``, ``control_video``, ...)."""
    runner = PipelineUnitRunner()
    inputs_posi = {"prompt": prompt}
    inputs_nega = {"negative_prompt": negative_prompt}
    inputs_shared = dict(input_image=input_image, end_image=end_image,
                         height=height, width=width, num_frames=num_frames,
                         seed=seed, plucker_embedding=plucker_embedding,
                         cfg_scale=cfg_scale, input_video=None,
                         denoising_strength=1.0, num_inference_steps=50,
                         mid_images_list=None, mid_images_id_list=None,
                         control_video=None, reference_image=None,
                         motion_bucket_id=None, clip_feature=None, y=None,
                         latents=None, noise=None, tiled=False)
    inputs_shared.update(extra_shared)
    for unit in units:
        inputs_shared, inputs_posi, inputs_nega = runner(
            unit, pipe, inputs_shared, inputs_posi, inputs_nega)
        if stage_callback is not None:
            stage_callback(unit.name)
    return inputs_shared, inputs_posi, inputs_nega
