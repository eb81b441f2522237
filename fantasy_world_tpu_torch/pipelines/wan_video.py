"""FantasyWorld generation pipeline (``pipelines/wan_video.py``) in
PyTorch: conditioning -> denoise -> decode.

  * ``tokenize`` / ``encode_prompt``: umT5 ids -> context, zeroed past each
    prompt's length; the HF tokenizer loads lazily from a local path;
  * ``encode_image``: CLIP's 257 tokens and y = [4-channel first-frame mask
    | VAE latent of the masked video];
  * ``generate_noise``, ``encode_plucker`` and the CFG-pair flow-matching
    ``denoise`` with the geometry heads on the last step;
  * ``decode_video``: the full-sequence causal VAE decode, or the
    reference's tiled one, to uint8 frames, through the 2.1 VAE or the
    38-block one (``models/wan/vae38.py``) that the pipe holds;
  * ``quantize``: int8 / fp8 over the fusion model (``core/quant.py``).

A pipe may hold a standalone DiT (``dit``, the TI2V-5B model) in place of
the fusion model: the conditioning units (``pipelines/units.py``) read its
``cfg.dit``, and ``pipelines/ti2v.py`` denoises with it.

The denoise takes TeaCache (``pipelines/tea_cache.py``: the skip plan made
before the loop, the stack residual carried) and runs segmented and
resumable: after every ``segment_size`` steps it synchronises, reports
progress and writes the partial state atomically to ``gen_ckpt_path``,
from which an identically conditioned call resumes. Its sliding-window
option evaluates each step over temporal windows of the latents
(``pipelines/temporal_tiler.py``) and blends them.

On a mesh (``shard``, then ``denoise(mesh=...)``; one process per rank)
every rank draws the same seeded noise and runs the same schedule: each
step's CFG pair goes through the sharded ``joint_forward``, which splits it
over 'data' where it divides and gathers the whole prediction for the CFG
combine, so the latents stay equal on every rank. The heads step's
prediction is rank 0's. TeaCache takes rank 0's skip plan on every rank
(a rank that skipped alone would leave the others waiting in a
collective) and carries each rank's part of the stack residual; rank 0
alone writes the partial state, with the whole residual gathered from the
ranks, and each rank takes its part back on resume. The sliding window
runs each window's CFG pair through the sharded forward.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.fusion.model import FusionModel
from ..models.wan.camera import CameraPoseEncoder
from ..models.wan.clip import CLIPVision, preprocess_image
from ..models.wan.dit import WanDiT, WanDiTConfig
from ..models.wan.t5 import T5Encoder
from ..models.wan.vae import (WanVAE, tile_plan, vae_decode_tiled,
                               vae_encode_tiled)
from ..models.wan.vae38 import WanVAE38, vae38_decode_tiled
from ..schedulers.flow_match import FlowMatchScheduler
from .tea_cache import DEFAULT_MODEL_ID, compute_skip_schedule


def segment_ends(start: int, n_scan: int, segment_size: int,
                 cuts: Sequence[int] = ()) -> set:
    """The steps after which a segment of the denoise ends: every
    ``segment_size`` steps from ``start``, never across a step of ``cuts``
    (the Wan2.2 expert boundary), the last at ``n_scan``."""
    ends, i, seg = set(), start, max(1, segment_size)
    while i < n_scan:
        stop = min([c for c in cuts if i < c < n_scan] + [n_scan])
        i = min(i + seg, stop)
        ends.add(i)
    return ends


def synchronize(t: torch.Tensor) -> None:
    """Wait for the work queued on ``t``'s device."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def load_partial(path: Optional[str], n_scan: int, latents: torch.Tensor,
                 residual: Optional[torch.Tensor], tea: bool,
                 take: Optional[Callable] = None):
    """(start step, latents, residual) from a partial-state file when it
    belongs to this run: the same step count and latent shape, and -- for
    a TeaCache run -- a residual (without one, a planned skip would add a
    zero residual in place of the stack). Else (0, latents, residual).
    ``take``: the file's whole residual -> this mesh rank's part."""
    if not path or not os.path.exists(path):
        return 0, latents, residual
    with np.load(path) as data:
        if (int(data["n_scan"]) != n_scan
                or tuple(data["latents"].shape) != tuple(latents.shape)
                or (tea and "residual" not in data.files)):
            return 0, latents, residual
        start = int(data["step"])
        latents = torch.as_tensor(data["latents"]).to(latents.device,
                                                      latents.dtype)
        if tea:
            whole = torch.as_tensor(data["residual"])
            residual = (whole if take is None else take(whole)).to(
                residual.device, residual.dtype)
    return start, latents, residual


def save_partial(path: str, step: int, n_scan: int, latents: torch.Tensor,
                 residual: Optional[torch.Tensor]) -> None:
    """{step, n_scan, latents[, residual]} in f32, written to ``path`` +
    ".tmp" and renamed over ``path``."""
    state = {"step": np.asarray(step), "n_scan": np.asarray(n_scan),
             "latents": latents.float().cpu().numpy()}
    if residual is not None:
        state["residual"] = residual.float().cpu().numpy()
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **state)
    os.replace(tmp, path)


def tea_setup(skips: np.ndarray, batch: int, grid: Sequence[int], dim: int,
              dtype, device, mesh=None):
    """A TeaCache denoise's (plan, zero residual, take, gather) for DiT
    tokens forming ``grid`` (f, h, w): the residual (batch, f*h*w, dim).
    On a ``mesh``: rank 0's plan on every rank (a step skipped by some
    ranks and computed by others would leave the latter waiting in the
    stack's collectives; the plan comes from the replicated time MLP, so
    the ranks' own agree), this rank's part of the residual
    (``sharding.token_split``), and the partial state's hooks, ``take``
    (the whole residual -> this rank's part) and ``gather`` (the reverse,
    a collective); in one process both hooks are None."""
    from ..parallel import distributed, sharding
    f, h, w = grid
    if mesh is None:
        return skips, torch.zeros((batch, f * h * w, dim), dtype=dtype,
                                  device=device), None, None
    part = sharding.token_split(batch, grid, mesh)
    rows = part[0]
    n = batch if rows is None else rows.stop - rows.start
    return (np.asarray(distributed.broadcast_object(np.asarray(skips, bool)),
                       bool),
            torch.zeros((n, part[1].local, dim), dtype=dtype, device=device),
            lambda whole: sharding.take_tokens(whole, part),
            lambda mine: sharding.gather_tokens(mine, part, mesh))


class StepReport:
    """What follows each denoise step: with ``segment_size`` or
    ``gen_ckpt_path``, at each segment's end, a synchronisation, the
    partial state written and ``progress(done, n)``; else ``progress``
    after the step is queued. After the last step the partial state is
    removed. A resumed run (``start`` > 0) reports its start first.

    On a ``mesh`` every rank makes one (each at the same steps):
    ``gather`` (this rank's residual part -> the whole, a collective) runs
    on every rank before the state is written, only rank 0 writes and
    removes the file, and the ranks meet after it, so that on every rank
    the file is as rank 0 left it when ``progress`` runs."""

    def __init__(self, n: int, start: int, segment_size: Optional[int],
                 path: Optional[str], progress: Optional[Callable],
                 cuts: Sequence[int] = (), mesh=None,
                 gather: Optional[Callable] = None):
        self.n, self.path, self.progress = n, path, progress
        self.meshed = mesh is not None and not mesh.trivial
        self.writer = not self.meshed or mesh.rank == 0
        self.gather = gather
        self.segmented = segment_size is not None or path is not None
        self.ends = segment_ends(start, n - 1, segment_size or n - 1, cuts)
        if progress is not None and start:
            progress(start, n)

    def __call__(self, done: int, latents: torch.Tensor,
                 residual: Optional[torch.Tensor]) -> None:
        if done == self.n:
            if self.path and self.writer:
                synchronize(latents)
                if os.path.exists(self.path):
                    os.remove(self.path)
            self._meet()
        elif self.segmented:
            if done not in self.ends:
                return
            synchronize(latents)
            if self.path:
                if residual is not None and self.gather is not None:
                    residual = self.gather(residual)
                if self.writer:
                    save_partial(self.path, done, self.n - 1, latents,
                                 residual)
            self._meet()
        if self.progress is not None:
            self.progress(done, self.n)

    def _meet(self) -> None:
        """On a mesh with a partial-state file, every rank waits for rank
        0's write or removal."""
        if self.meshed and self.path:
            from ..parallel.distributed import barrier
            barrier()


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """The ``cfg`` of a pipe around a standalone DiT."""
    dit: WanDiTConfig


class FantasyWorldPipeline:
    """Holds the fusion model (or a standalone DiT), the camera pose
    encoder and the encoders, built on one device in one dtype; any of them
    may be absent when its stage is not run."""

    def __init__(self, fusion: Optional[FusionModel] = None,
                 pose_encoder: Optional[CameraPoseEncoder] = None, *,
                 t5: Optional[T5Encoder] = None,
                 clip: Optional[CLIPVision] = None,
                 vae: Union[None, WanVAE, WanVAE38] = None,
                 dit: Optional[WanDiT] = None,
                 tokenizer_path: Optional[str] = None, text_len: int = 512):
        self.fusion = fusion
        self.pose_encoder = pose_encoder
        self.t5, self.clip, self.vae, self.dit = t5, clip, vae, dit
        self.cfg = (fusion.cfg if fusion is not None else
                    None if dit is None else DiTConfig(dit.cfg))
        self.tokenizer_path = tokenizer_path
        self.text_len = text_len
        # the HF tokenizer, loaded on first use; any callable with its
        # interface may be installed instead
        self.tokenizer = None

    def _weight(self) -> torch.Tensor:
        if self.fusion is not None:
            return self.fusion.dit.patch_embedding.weight
        if self.dit is not None:
            return self.dit.patch_embedding.weight
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

    @property
    def vae_cfg(self):
        """The VAE's config: ``spatial_down`` 8 (2.1) or 16 (38-block)."""
        return None if self.vae is None else self.vae.cfg

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
    def clip_tokens(self, image: np.ndarray) -> torch.Tensor:
        """image (H, W, 3) in [-1, 1] -> (1, 257, dim) CLIP tokens."""
        return self.clip(preprocess_image(self._image(image)).to(self.dtype))

    def encode_clip(self, image: np.ndarray) -> Optional[torch.Tensor]:
        """``clip_tokens``, or None when the model takes no image
        context."""
        if self.clip is None or (self.cfg is not None
                                 and not self.cfg.dit.has_image_input):
            return None
        return self.clip_tokens(image)

    @torch.no_grad()
    def encode_y(self, image: np.ndarray, num_frames: int, height: int,
                 width: int, end_image: Optional[np.ndarray] = None,
                 tiled: bool = False,
                 mid_images: Optional[Sequence] = None) -> torch.Tensor:
        """image (H, W, 3) in [-1, 1] -> y (1, 4 + z, f, h, w): the mask of
        the given frames and the VAE latent of the video that holds the
        image, zero frames, ``end_image`` (same form) as the last frame
        when given, and each (image, frame index) of ``mid_images`` as a
        keyframe. ``tiled`` encodes over the reference's tile grid."""
        img = self._image(image)
        msk = np.ones((1, num_frames, height // 8, width // 8), np.float32)
        msk[:, 1:] = 0
        frames = [img.transpose(0, 1),
                  img.new_zeros((3, num_frames - 1, height, width))]
        if end_image is not None:
            msk[:, -1:] = 1
            frames[1][:, -1] = self._image(end_image)[0]
        for mid, idx in mid_images or ():
            msk[:, idx:idx + 1] = 1
            if idx:
                frames[1][:, idx - 1] = self._image(mid)[0]
            else:
                frames[0] = self._image(mid).transpose(0, 1)
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
        """latents (1, z, f, h, w) -> uint8 frames (T, H, W, 3), through the
        VAE the pipe holds (the 2.1 one, or the 38-block one: 16 pixels a
        latent pixel). ``tiled`` decodes over the reference's tile grid,
        (30, 52) latent pixels with stride (15, 26) for either VAE, or over
        the given one (give both tile_size and tile_stride, or neither)."""
        x = latents.to(self.vae.conv2.weight.device, self.dtype)
        if tiled:
            decode = (vae38_decode_tiled if isinstance(self.vae, WanVAE38)
                      else vae_decode_tiled)
            video = decode(self.vae, x, *tile_plan(tile_size, tile_stride))
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

    def shard(self, mesh) -> None:
        """Split the fusion model over ``mesh`` (``FusionModel.shard``: the
        DiT's projections over 'model'); the encoders, the VAE and the pose
        encoder stay whole, they run once per clip. Pass the same mesh to
        ``denoise``."""
        self.fusion.shard(mesh)

    def quantize(self, mode: str = "int8", **kw) -> int:
        """int8 w8a8 or fp8 storage over the fusion model's eligible
        linears, in place (``core.quant.quantize_model``; the encoders, the
        VAE and the pose encoder run once per clip and stay as they are).
        Returns how many layers were rewritten. A model already sharded
        (``shard``) quantizes its parts to the bits the whole model's
        quantization would split into; every rank calls it."""
        from ..core.quant import quantize_model
        return quantize_model(self.fusion, mode,
                              axis=self.fusion.dit.blocks[0].tp, **kw)

    @torch.no_grad()
    def denoise(self, context_pos, context_neg, clip_feature, y,
                height: int, width: int, num_frames: int = 81,
                num_inference_steps: int = 50, cfg_scale: float = 5.0,
                seed: Union[None, int, Sequence[int]] = None,
                plucker_fea=None,
                progress_callback: Optional[Callable[[int, int], None]] = None,
                tea_cache_l1_thresh: Optional[float] = None,
                tea_cache_model_id: str = DEFAULT_MODEL_ID,
                segment_size: Optional[int] = None,
                gen_ckpt_path: Optional[str] = None,
                sliding_window_size: Optional[int] = None,
                sliding_window_stride: Optional[int] = None,
                mesh=None, ulysses: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """Returns (final latents (B, 16, f, h, w), geometry prediction of
        the positive rows). Each step runs the CFG pair as batch 2 (rows
        [:B] positive, [B:] negative); the CFG combine and the Euler update
        are f32.

        ``tea_cache_l1_thresh``: TeaCache at this relative-L1 threshold
        (the reference suggests 0.05 at 480P) with ``tea_cache_model_id``'s
        polynomial; the plan is made before the loop.

        ``segment_size`` / ``gen_ckpt_path``: the steps before the last run
        in segments of ``segment_size`` (all of them when only a path is
        given); after each the device is synchronised,
        ``progress_callback(done, n)`` runs and the partial state is
        written to ``gen_ckpt_path``; a call with the same step count and
        shapes resumes from it, and the file is removed at the end. The
        result equals the unsegmented one step for step. Without either,
        ``progress_callback`` runs after each step's work is queued (it
        does not synchronise).

        ``sliding_window_size`` / ``sliding_window_stride`` (latent frames;
        the stride defaults to half the size): each step evaluates the CFG
        pair over temporal windows of the latents, y and the Plucker
        features and blends them (``temporal_tiled_forward``). The geometry
        heads do not run, so the prediction is None; TeaCache,
        ``segment_size`` and ``gen_ckpt_path`` do not combine with it.

        ``mesh`` / ``ulysses``: the multi-GPU denoise over a
        ``parallel.sharding.Mesh`` the model was sharded over (``shard``),
        every attention whose keys are split over 'seq' re-sharded through
        Ulysses (or the ring) under ``ulysses``; every rank
        returns the latents, rank 0 the prediction (None on the others).
        Every option above combines with it; every rank passes the same
        arguments (the same ``gen_ckpt_path``, which rank 0 writes)."""
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
        meshed = mesh is not None and not mesh.trivial
        fwd = {"mesh": mesh, "ulysses": ulysses} if meshed else {}
        if sliding_window_size is not None:
            given = [name for name, v in (
                ("tea_cache_l1_thresh", tea_cache_l1_thresh),
                ("segment_size", segment_size),
                ("gen_ckpt_path", gen_ckpt_path)) if v is not None]
            if given:
                raise ValueError(f"sliding_window_size does not combine "
                                 f"with {', '.join(given)}")
            return self._denoise_windowed(
                latents, sched, ctx, clip2, y2, pl2, cfg_scale, f, height,
                width, sliding_window_size,
                sliding_window_stride or max(1, sliding_window_size // 2),
                progress_callback, fwd), None
        tea = tea_cache_l1_thresh is not None
        skips, residual = np.zeros((n,), bool), None
        take = gather = None
        if tea:
            pt = self.cfg.dit.patch_size
            skips, residual, take, gather = tea_setup(
                compute_skip_schedule(self.fusion.dit, sched.timesteps,
                                      tea_cache_l1_thresh,
                                      tea_cache_model_id),
                2 * B, (f, height // 8 // pt[1], width // 8 // pt[2]),
                self.cfg.dit.dim, dtype, dev, mesh if meshed else None)
        start, latents, residual = load_partial(gen_ckpt_path, n - 1,
                                                latents, residual, tea, take)
        # every rank resumes from the partial state; rank 0 alone writes it
        report = StepReport(n, start, segment_size, gen_ckpt_path,
                            progress_callback, mesh=mesh, gather=gather)
        prediction = None
        for i in range(start, n):
            last = i == n - 1
            t = torch.full((2 * B,), float(sched.timesteps[i]),
                           dtype=torch.float32, device=dev)
            lat2 = torch.cat([latents] * 2, dim=0)
            if tea and not last:
                noise, residual = self.fusion.joint_forward_tea(
                    lat2, t, ctx, clip2, y2, plucker_fea=pl2,
                    skip=bool(skips[i]), residual=residual, **fwd)
            else:
                noise, prediction = self.fusion.joint_forward(
                    lat2, t, ctx, clip2, y2, plucker_fea=pl2,
                    return_prediction=last, **fwd)
            pos, neg = noise[:B].float(), noise[B:].float()
            pred = neg + cfg_scale * (pos - neg)
            latents = (latents.float() + pred * float(pairs[i, 1] - pairs[i, 0])
                       ).to(dtype)
            report(i + 1, latents, residual)
        # the heads ran on the CFG-doubled batch; keep the positive rows
        if prediction is not None:
            prediction = {k: v[:B] for k, v in prediction.items()}
        return latents, prediction

    def _denoise_windowed(self, latents, sched, ctx, clip2, y2, pl2,
                          cfg_scale, f, height, width, size, stride,
                          progress_callback, fwd):
        """The step loop with each CFG-pair prediction tiled over temporal
        windows; the Plucker features (B2, L, D) enter as (B2, D, f, h, w)
        so that they slice by frame like the latents. ``fwd``: the mesh
        arguments of each window's ``joint_forward`` (its frames split over
        'seq' as a whole clip's are, raggedly where they do not divide)."""
        from .temporal_tiler import temporal_tiled_forward
        pl_bcthw = None
        if pl2 is not None:
            pt = self.cfg.dit.patch_size
            h2, w2 = height // 8 // pt[1], width // 8 // pt[2]
            pl_bcthw = pl2.view(pl2.shape[0], f, h2, w2,
                                pl2.shape[-1]).permute(0, 4, 1, 2, 3)

        def window(latents, y, plucker, t):
            pl = None
            if plucker is not None:
                pl = plucker.permute(0, 2, 3, 4, 1).reshape(
                    plucker.shape[0], -1, plucker.shape[1])
            lat2 = torch.cat([latents] * 2, dim=0)
            noise, _ = self.fusion.joint_forward(
                lat2, torch.full((lat2.shape[0],), t, dtype=torch.float32,
                                 device=lat2.device), ctx, clip2, y,
                plucker_fea=pl, **fwd)
            nb = latents.shape[0]
            pos, neg = noise[:nb].float(), noise[nb:].float()
            return neg + cfg_scale * (pos - neg)

        pairs, n = sched.sigma_pairs(), len(sched.timesteps)
        for i in range(n):
            pred = temporal_tiled_forward(
                window, {"latents": latents, "y": y2, "plucker": pl_bcthw},
                size, stride, slice_names=("latents", "y", "plucker"),
                t=float(sched.timesteps[i]))
            latents = (latents.float() + pred.float()
                       * float(pairs[i, 1] - pairs[i, 0])).to(latents.dtype)
            if progress_callback is not None:
                progress_callback(i + 1, n)
        return latents
