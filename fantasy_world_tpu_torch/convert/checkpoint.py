"""The reference checkpoint layout -> the port's modules (the counterpart of
``cli/infer_wan21.py:load_fusion_params`` with ``convert/{fusion,wan_dit,
vggt,camera,encoders,wan_vae}.py``).

``wan_ckpt_path`` holds the base DiT as ``diffusion_pytorch_model-*.
safetensors`` shards, ``Wan2.1_VAE.pth``, the CLIP and umT5 ``.pth`` files;
``model_ckpt`` is the FantasyWorld fusion ``.pth``. The port's module paths
are the checkpoint's names, so loading is renaming:

  * the base DiT, with the fusion file's ``pipe.dit.*`` overlaid on it;
  * the IRG surgery reversed: ``IRGBlock.{i}.x_dit.*`` -> DiT block
    ``start_index + i``, ``IRGBlock.{i}.x_agg.*`` -> VGGT global block i,
    ``IRGBlock.{i}.bicross_attention.*`` -> bicross i; ``vggt.*`` as is;
  * ``ops/rope.py:permute_qk_out_channels`` on the DiT self-attention q/k
    (weights, biases, RMS scales) and the bicross m1/m2 projections, for
    the rotate-half RoPE the port runs;
  * ``camera_condition.pose_encoder.*`` into a pose encoder whose widths
    are read off those tensors.

A shard key that appears twice is an error; a key the port's modules need
and the files lack is an error; keys the port has no module for (the CLIP
text tower, heads the configuration leaves out) are not read.
``.safetensors`` is read by ``read_safetensors`` (the format is an 8-byte
header length, a JSON header and the raw buffers), ``.pth`` by
``torch.load(weights_only=True)``, both mapped from disk rather than read
into memory. ``reference_state_dicts`` and ``write_safetensors`` go the
other way, from the port's modules to the layout, for checkpoints written
from a seed.

An optional ``configs.json`` in ``wan_ckpt_path`` ({"fusion", "t5",
"clip", "vae"}: each a config's ``dataclasses.asdict``) gives the
architecture; without one the production configs apply.

The Wan2.2-Fun-A14B-Control-Camera layout (``load_wan22``) holds the two
experts' base DiTs under ``high_noise_model/`` and ``low_noise_model/``,
their Reward-LoRAs under ``PAI/Wan2.2-Fun-Reward-LoRAs/``, the shared
``Wan2.1_VAE.pth`` and umT5 ``.pth``, and one fusion ``.pth`` per expert.
Each expert is its base DiT with its LoRA merged at 0.55
(``convert/lora.py``), then the fusion file overlaid as above, with the
same q/k permutation.

A standalone DiT's state dict (the TI2V-5B model) takes the same
permutation (``dit_state_dict_from``); ``Wan2.2_VAE.pth`` loads into
``WanVAE38`` by ``load_into`` once its ``model.`` prefix is stripped.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.params import build
from ..models.fusion.model import FusionConfig, FusionModel
from ..models.wan.camera import CameraPoseEncoder, CameraPoseEncoderConfig
from ..models.wan.clip import CLIPVision, CLIPVisionConfig
from ..models.wan.t5 import T5Config, T5Encoder
from ..models.wan.dit import WanDiTConfig
from ..models.wan.vae import VAEConfig, WanVAE
from ..ops.rope import permute_qk_out_channels

DIT_SHARDS = "diffusion_pytorch_model-*.safetensors"
VAE_FILE = "Wan2.1_VAE.pth"
CLIP_FILE = "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"
T5_FILE = "models_t5_umt5-xxl-enc-bf16.pth"
CONFIGS_FILE = "configs.json"
POSE_PREFIX = "camera_condition.pose_encoder."
EXPERT_SHARDS = {True: "high_noise_model/diffusion_pytorch_model*.safetensors",
                 False: "low_noise_model/diffusion_pytorch_model*.safetensors"}
LORA_DIR = os.path.join("PAI", "Wan2.2-Fun-Reward-LoRAs")
EXPERT_LORAS = {
    True: os.path.join(LORA_DIR, "Wan2.2-Fun-A14B-InP-high-noise-HPS2.1"
                                 ".safetensors"),
    False: os.path.join(LORA_DIR, "Wan2.2-Fun-A14B-InP-low-noise-HPS2.1"
                                  ".safetensors")}
LORA_MULTIPLIER = 0.55

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a ``.safetensors`` file, each a view of the
    file mapped copy-on-write (nothing is read until a tensor is used)."""
    with open(path, "rb") as fh:
        n = int.from_bytes(fh.read(8), "little")
        header = json.loads(fh.read(n))
    header.pop("__metadata__", None)
    buf = np.memmap(path, dtype=np.uint8, mode="c", offset=8 + n)
    out = {}
    for name, info in header.items():
        lo, hi = info["data_offsets"]
        t = torch.from_numpy(buf[lo:hi]).view(_ST_DTYPES[info["dtype"]])
        out[name] = t.reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]
                      ) -> None:
    """{name: tensor} -> a ``.safetensors`` file in each tensor's dtype:
    the 8-byte header length, the JSON header (padded to 8 bytes), the raw
    buffers."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as fh:
        fh.write(len(head).to_bytes(8, "little"))
        fh.write(head)
        for blob in blobs:
            fh.write(blob)


def read_pth(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.pth`` state dict (unwrapping a top-level
    ``model_state`` or ``model`` dict)."""
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    for key in ("model_state", "model"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def read_shards(paths: List[str]) -> Dict[str, torch.Tensor]:
    """One state dict from split ``.safetensors`` files; a key in two files
    is corruption and raises."""
    sd: Dict[str, torch.Tensor] = {}
    for p in paths:
        part = read_safetensors(p)
        dup = sd.keys() & part.keys()
        if dup:
            raise ValueError(f"duplicate keys across shards ({p}): "
                             f"{sorted(dup)[:5]}")
        sd.update(part)
    return sd


def dit_shards(wan_ckpt_path: str, pattern: str = DIT_SHARDS) -> List[str]:
    return sorted(glob.glob(os.path.join(wan_ckpt_path, pattern)))


def missing_files(wan_ckpt_path: str, model_ckpt: str) -> List[str]:
    """The checkpoint files that ``load_pipeline`` needs and cannot find."""
    missing = [] if dit_shards(wan_ckpt_path) else [
        os.path.join(wan_ckpt_path, DIT_SHARDS)]
    missing += [p for p in [model_ckpt] + [
        os.path.join(wan_ckpt_path, f) for f in (VAE_FILE, CLIP_FILE,
                                                  T5_FILE)]
        if not os.path.isfile(p)]
    return missing


def missing_files_wan22(wan_ckpt_path: str, model_ckpt_high: str,
                        model_ckpt_low: str) -> List[str]:
    """The checkpoint files that ``load_wan22`` needs and cannot find."""
    missing = [os.path.join(wan_ckpt_path, pat)
               for pat in EXPERT_SHARDS.values()
               if not dit_shards(wan_ckpt_path, pat)]
    return missing + [p for p in [model_ckpt_high, model_ckpt_low] + [
        os.path.join(wan_ckpt_path, f) for f in
        (*EXPERT_LORAS.values(), VAE_FILE, T5_FILE)]
        if not os.path.isfile(p)]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def wan22_fusion_config() -> FusionConfig:
    """Wan2.2-Fun-A14B-Control-Camera FantasyWorld: no CLIP branch, the
    control adapter on 24 Plucker channels, no per-layer camera
    adapters."""
    return FusionConfig(dit=WanDiTConfig(
        has_image_input=False, require_vae_embedding=True,
        add_control_adapter=True, in_dim_control_adapter=24,
        camera_adapter_end=0), camera_control=True)


def config_from_dict(default, values: Mapping):
    """``default`` (a config instance) with the fields in ``values``
    replaced, nested configs recursively, lists as tuples."""
    kw = {}
    for f in dataclasses.fields(default):
        if f.name not in values:
            continue
        cur, new = getattr(default, f.name), values[f.name]
        if dataclasses.is_dataclass(cur):
            new = config_from_dict(cur, new)
        elif isinstance(new, list):
            new = tuple(new)
        kw[f.name] = new
    return dataclasses.replace(default, **kw)


def read_configs(wan_ckpt_path: str,
                 fusion: FusionConfig = FusionConfig()) -> Dict[str, object]:
    """{"fusion", "t5", "clip", "vae"} configs: ``configs.json``'s fields
    over the production defaults (``fusion`` for the fusion model)."""
    defaults = {"fusion": fusion, "t5": T5Config(),
                "clip": CLIPVisionConfig(), "vae": VAEConfig()}
    path = os.path.join(wan_ckpt_path, CONFIGS_FILE)
    if not os.path.isfile(path):
        return defaults
    with open(path) as fh:
        raw = json.load(fh)
    return {k: config_from_dict(d, raw[k]) if k in raw else d
            for k, d in defaults.items()}


# ---------------------------------------------------------------------------
# state dicts
# ---------------------------------------------------------------------------

def _permute(t: torch.Tensor, head_dim: int, inverse: bool = False
             ) -> torch.Tensor:
    """``permute_qk_out_channels`` along dim 0 (torch's output axis), or
    its inverse."""
    idx = permute_qk_out_channels(np.arange(t.shape[0]), head_dim)
    return t[torch.as_tensor(np.argsort(idx) if inverse else idx)]


def _dit_permuted_names(cfg: WanDiTConfig, prefix: str = ""):
    """(name, head_dim) of the DiT's self-attention q/k tensors."""
    for i in range(cfg.num_layers):
        for name in ("q.weight", "q.bias", "k.weight", "k.bias",
                     "norm_q.weight", "norm_k.weight"):
            yield f"{prefix}blocks.{i}.self_attn.{name}", cfg.head_dim


def _permuted_names(cfg: FusionConfig):
    """(name, head_dim) of every tensor the RoPE permutation applies to."""
    yield from _dit_permuted_names(cfg.dit, "dit.")
    for i in range(cfg.num_irg):
        for name in ("m1_proj.weight", "m1_proj.bias", "m2_proj.weight",
                     "m2_proj.bias"):
            yield f"bicross.{i}.cross_attn.{name}", cfg.bicross.head_dim


def fusion_state_dict_from(base_dit: Mapping[str, torch.Tensor],
                           fusion: Mapping[str, torch.Tensor],
                           cfg: FusionConfig) -> Dict[str, torch.Tensor]:
    """The base DiT and the fusion checkpoint -> {FusionModel name:
    tensor}, the surgery reversed and the RoPE permutation applied."""
    out = {"dit." + k: v for k, v in base_dit.items()}
    irg = {"x_dit": lambda i: f"dit.blocks.{cfg.start_index + i}.",
           "x_agg": lambda i: f"vggt.aggregator.global_blocks.{i}.",
           "bicross_attention": lambda i: f"bicross.{i}."}
    for k, v in fusion.items():
        if k.startswith("pipe.dit."):
            out["dit." + k[len("pipe.dit."):]] = v
        elif k.startswith("IRGBlock."):
            i, part, rest = k[len("IRGBlock."):].split(".", 2)
            if part in irg:
                out[irg[part](int(i)) + rest] = v
        elif k.startswith("vggt."):
            out[k] = v
    for name, head_dim in _permuted_names(cfg):
        if name in out:
            out[name] = _permute(out[name], head_dim)
    return out


def dit_state_dict_from(sd: Mapping[str, torch.Tensor], cfg: WanDiTConfig
                        ) -> Dict[str, torch.Tensor]:
    """A reference WanModel state dict (the TI2V-5B DiT's shards) -> the
    standalone ``WanDiT``'s, the RoPE permutation applied to the
    self-attention q/k."""
    out = dict(sd)
    for name, head_dim in _dit_permuted_names(cfg):
        if name in out:
            out[name] = _permute(out[name], head_dim)
    return out


def reference_state_dicts(sd: Mapping[str, torch.Tensor], cfg: FusionConfig
                          ) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]:
    """A ``FusionModel`` state dict -> (base DiT, fusion file), which
    ``fusion_state_dict_from`` turns back into ``sd``. The base holds every
    DiT tensor but the camera adapters (``.processor.``), the blocks that
    the IRG stack takes over too, as the released base checkpoint does;
    the fusion file holds the adapters of the blocks before the stack as
    ``pipe.dit.*``, the IRG blocks (adapters included) and the rest of
    VGGT. The pose encoder is not in ``sd``: its tensors go into the
    fusion file under ``POSE_PREFIX``."""
    sd = dict(sd)
    for name, head_dim in _permuted_names(cfg):
        if name in sd:
            sd[name] = _permute(sd[name], head_dim, inverse=True)
    base, fusion = {}, {}
    for k, v in sd.items():
        blk = re.match(r"dit\.blocks\.(\d+)\.(.*)", k)
        irg = re.match(r"(vggt\.aggregator\.global_blocks|bicross)\.(\d+)\."
                       r"(.*)", k)
        if blk and int(blk.group(1)) >= cfg.start_index:
            fusion[f"IRGBlock.{int(blk.group(1)) - cfg.start_index}.x_dit."
                   f"{blk.group(2)}"] = v
            if ".processor." not in k:
                base[k[len("dit."):]] = v
        elif k.startswith("dit.") and ".processor." in k:
            fusion["pipe." + k] = v
        elif k.startswith("dit."):
            base[k[len("dit."):]] = v
        elif irg:
            part = ("x_agg" if irg.group(1).startswith("vggt")
                    else "bicross_attention")
            fusion[f"IRGBlock.{irg.group(2)}.{part}.{irg.group(3)}"] = v
        else:
            fusion[k] = v
    return base, fusion


def pose_config_from_state_dict(sd: Mapping[str, torch.Tensor],
                                base: CameraPoseEncoderConfig =
                                CameraPoseEncoderConfig()
                                ) -> CameraPoseEncoderConfig:
    """The pose encoder's widths, its input channels, its DiT width and its
    output width, read off its tensors."""
    first = sd["controlnet_encode_first.0.weight"].shape
    return dataclasses.replace(
        base, in_channels=first[1] // base.downscale ** 2,
        dim=sd["patch_embedding.weight"].shape[0],
        context_dim=sd["fc.4.weight"].shape[0],
        hidden=(first[0], sd["controlnet_encode_first.2.weight"].shape[0],
                sd["controlnet_encode_second.0.weight"].shape[0]))


def _strip(sd: Mapping[str, torch.Tensor], prefixes) -> Dict[str, torch.Tensor]:
    """sd with the first matching prefix removed from each key."""
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def load_into(module: nn.Module, sd: Mapping[str, torch.Tensor],
              what: str) -> nn.Module:
    """Copy ``sd`` into every parameter and buffer of ``module``; keys it
    does not have are not read. VGGT blocks saved without LayerScale get
    unit scales, as the reference's Identity is."""
    want = module.state_dict()
    sd = dict(sd)
    for k, t in want.items():
        if k not in sd and k.endswith((".ls1.gamma", ".ls2.gamma")):
            sd[k] = torch.ones_like(t, device="cpu")
    missing = sorted(k for k in want if k not in sd)
    if missing:
        raise KeyError(f"{what}: the checkpoint lacks {len(missing)} "
                       f"tensors, e.g. {missing[:5]}")
    module.load_state_dict({k: sd[k] for k in want}, strict=True)
    return module


def load_pipeline(wan_ckpt_path: str, model_ckpt: str, *, device,
                  dtype: torch.dtype = torch.bfloat16,
                  tokenizer_path: Optional[str] = None):
    """The reference layout -> a ``FantasyWorldPipeline`` with the fusion
    model, the pose encoder, umT5, CLIP and the VAE built on ``device`` in
    ``dtype``."""
    from ..pipelines.wan_video import FantasyWorldPipeline
    cfgs = read_configs(wan_ckpt_path)
    missing = missing_files(wan_ckpt_path, model_ckpt)
    if missing:
        raise FileNotFoundError(f"checkpoint files missing: {missing}")

    def make(ctor, cfg):
        return build(lambda: ctor(cfg), device=device, dtype=dtype)

    fusion_sd = read_pth(model_ckpt)
    fusion = load_into(make(FusionModel, cfgs["fusion"]),
                       fusion_state_dict_from(
                           read_shards(dit_shards(wan_ckpt_path)),
                           fusion_sd, cfgs["fusion"]), "fusion")
    pose_sd = {k[len(POSE_PREFIX):]: v for k, v in fusion_sd.items()
               if k.startswith(POSE_PREFIX)}
    pose = None
    if pose_sd:
        pose = load_into(make(CameraPoseEncoder,
                              pose_config_from_state_dict(pose_sd)),
                         pose_sd, "pose encoder")
    del fusion_sd
    vae = load_into(make(WanVAE, cfgs["vae"]), _strip(
        read_pth(os.path.join(wan_ckpt_path, VAE_FILE)), ("model.",)), "vae")
    clip = load_into(make(CLIPVision, cfgs["clip"]), _strip(
        read_pth(os.path.join(wan_ckpt_path, CLIP_FILE)),
        ("model.visual.", "visual.")), "clip")
    t5 = load_into(make(T5Encoder, cfgs["t5"]),
                   read_pth(os.path.join(wan_ckpt_path, T5_FILE)), "t5")
    if tokenizer_path is None:
        cand = os.path.join(wan_ckpt_path, "google", "umt5-xxl")
        tokenizer_path = cand if os.path.isdir(cand) else None
    return FantasyWorldPipeline(fusion, pose, t5=t5, clip=clip, vae=vae,
                                tokenizer_path=tokenizer_path)


def expert_state_dict(wan_ckpt_path: str, high: bool, model_ckpt: str,
                      cfg: FusionConfig) -> Dict[str, torch.Tensor]:
    """One Wan2.2 expert: its base DiT shards with its Reward-LoRA merged,
    the fusion checkpoint overlaid -> {FusionModel name: tensor}."""
    from .lora import merge_lora_into_state_dict
    base = read_shards(dit_shards(wan_ckpt_path, EXPERT_SHARDS[high]))
    base = merge_lora_into_state_dict(
        base, read_safetensors(os.path.join(wan_ckpt_path,
                                            EXPERT_LORAS[high])),
        multiplier=LORA_MULTIPLIER, verbose=True)
    return fusion_state_dict_from(base, read_pth(model_ckpt), cfg)


def load_wan22(wan_ckpt_path: str, model_ckpt_high: str, model_ckpt_low: str,
               *, device, dtype: torch.dtype = torch.bfloat16,
               tokenizer_path: Optional[str] = None,
               timestep_boundary: float = 900.0,
               quant: Optional[str] = None):
    """The Wan2.2 layout -> (a ``FantasyWorldPipeline`` with umT5 and the
    VAE, a ``DualModelDenoiser``), all in ``dtype``. On a card the high
    expert is built there and the low one in pinned host memory, to trade
    places at the boundary; on the CPU both are built there. ``quant``
    ("int8" / "fp8") quantizes each expert as it loads, layer by layer on
    ``device``, before the low one is pinned."""
    from ..pipelines.wan_video import FantasyWorldPipeline
    from ..pipelines.wan_video_22 import DualModelDenoiser, place_expert
    cfgs = read_configs(wan_ckpt_path, wan22_fusion_config())
    missing = missing_files_wan22(wan_ckpt_path, model_ckpt_high,
                                  model_ckpt_low)
    if missing:
        raise FileNotFoundError(f"checkpoint files missing: {missing}")
    device = torch.device(device)

    def make(ctor, cfg, dev=device):
        return build(lambda: ctor(cfg), device=dev, dtype=dtype)

    experts = {}
    for high, ckpt in ((True, model_ckpt_high), (False, model_ckpt_low)):
        on_card = high or device.type == "cpu"
        model = make(FusionModel, cfgs["fusion"],
                     device if on_card else "cpu")
        load_into(model, expert_state_dict(wan_ckpt_path, high, ckpt,
                                           cfgs["fusion"]),
                  "high expert" if high else "low expert")
        experts[high] = place_expert(model, device, on_host=not on_card,
                                     quant=quant)
    vae = load_into(make(WanVAE, cfgs["vae"]), _strip(
        read_pth(os.path.join(wan_ckpt_path, VAE_FILE)), ("model.",)), "vae")
    t5 = load_into(make(T5Encoder, cfgs["t5"]),
                   read_pth(os.path.join(wan_ckpt_path, T5_FILE)), "t5")
    if tokenizer_path is None:
        cand = os.path.join(wan_ckpt_path, "google", "umt5-xxl")
        tokenizer_path = cand if os.path.isdir(cand) else None
    pipe = FantasyWorldPipeline(t5=t5, vae=vae, tokenizer_path=tokenizer_path)
    return pipe, DualModelDenoiser(experts[True], experts[False],
                                   timestep_boundary)

