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
"clip", "vae"}: each a config in ``utils/configio.py``'s schema) gives the
architecture; without one the production configs apply. A bundle written
by ``cli/convert.py`` (``convert/bundle.py``) loads in the reference
layout's place: its components are already in the port's names. Each
loader reads the state dicts first (``pipeline_state_dicts``,
``expert_state_dict``), then builds the modules from them
(``pipeline_from_state_dicts``, ``place_experts``), so that
``cli/verify_weights.py`` can check the tensors in between.

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
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.params import build
from ..models.fusion.model import FusionConfig, FusionModel
from ..models.wan.camera import CameraPoseEncoder, CameraPoseEncoderConfig
from ..models.wan.clip import CLIPVision, CLIPVisionConfig
from ..models.wan.t5 import T5Config, T5Encoder
from ..models.wan.dit import WanDiT, WanDiTConfig
from ..models.wan.vae import VAEConfig, WanVAE
from ..ops.rope import permute_qk_out_channels
from ..utils.configio import config_from_dict
from .bundle import bundle_components, is_bundle, load_bundle

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
# a bundle's components (convert/bundle.py); Wan2.1's pose encoder is
# optional, as in the fusion file
WAN21_COMPONENTS = ("fusion", "t5", "clip", "vae")
WAN22_COMPONENTS = ("fusion_high", "fusion_low", "t5", "vae")

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
    buffers, written one tensor at a time (a tensor on the card is copied
    to the host when its turn comes)."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as fh:
        fh.write(len(head).to_bytes(8, "little"))
        fh.write(head)
        for t in tensors.values():
            t = t.detach().cpu().contiguous()
            fh.write(t.reshape(-1).view(torch.uint8).numpy().data)


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


def read_state_dict(path) -> Dict[str, torch.Tensor]:
    """A state dict from a ``.safetensors`` or ``.pth`` file, a list of
    ``.safetensors`` shards, or a directory of them."""
    if isinstance(path, (list, tuple)):
        return read_shards(list(path))
    if os.path.isdir(path):
        shards = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        if not shards:
            raise FileNotFoundError(f"no safetensors under {path}")
        return read_shards(shards)
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return read_pth(path)


def dit_shards(wan_ckpt_path: str, pattern: str = DIT_SHARDS) -> List[str]:
    return sorted(glob.glob(os.path.join(wan_ckpt_path, pattern)))


def _missing_components(wan_ckpt_path: str, want) -> List[str]:
    have = bundle_components(wan_ckpt_path)
    return [os.path.join(wan_ckpt_path, c + ".safetensors") for c in want
            if c not in have]


def missing_files(wan_ckpt_path: str, model_ckpt: Optional[str],
                  components: Sequence[str] = WAN21_COMPONENTS
                  ) -> List[str]:
    """The checkpoint files that ``load_pipeline`` needs for
    ``components`` and cannot find (of a bundle: its components;
    ``model_ckpt`` is then not read)."""
    if is_bundle(wan_ckpt_path):
        return _missing_components(wan_ckpt_path, components)
    missing, files = [], []
    if "fusion" in components:
        if not dit_shards(wan_ckpt_path):
            missing.append(os.path.join(wan_ckpt_path, DIT_SHARDS))
        files.append(model_ckpt)
    files += [os.path.join(wan_ckpt_path, f) for c, f in (
        ("vae", VAE_FILE), ("clip", CLIP_FILE), ("t5", T5_FILE))
        if c in components]
    return missing + [p for p in files if not os.path.isfile(p)]


def missing_files_wan22(wan_ckpt_path: str, model_ckpt_high: str,
                        model_ckpt_low: str) -> List[str]:
    """The checkpoint files that ``load_wan22`` needs and cannot find."""
    if is_bundle(wan_ckpt_path):
        return _missing_components(wan_ckpt_path, WAN22_COMPONENTS)
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


def read_configs(wan_ckpt_path: str,
                 fusion: FusionConfig = FusionConfig()) -> Dict[str, object]:
    """{"fusion", "fusion_high", "fusion_low", "t5", "clip", "vae"}
    configs: ``configs.json``'s fields (``utils/configio.py``'s schema)
    over the production defaults (``fusion`` for each fusion model), and
    "pose" when the file gives one."""
    defaults = {"fusion": fusion, "fusion_high": fusion,
                "fusion_low": fusion, "t5": T5Config(),
                "clip": CLIPVisionConfig(), "vae": VAEConfig()}
    path = os.path.join(wan_ckpt_path, CONFIGS_FILE)
    raw = {}
    if os.path.isfile(path):
        with open(path) as fh:
            raw = json.load(fh)
    # a Wan2.2 bundle names its experts' config, a reference layout "fusion"
    for k in ("fusion_high", "fusion_low"):
        raw.setdefault(k, raw.get("fusion", {}))
    out = {k: config_from_dict(type(d), raw[k], d) if k in raw else d
           for k, d in defaults.items()}
    if "pose" in raw:
        out["pose"] = config_from_dict(CameraPoseEncoderConfig, raw["pose"])
    return out


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


def plain_dit_state_dict(wan_ckpt_path: str, cfg: WanDiTConfig,
                         names=None) -> Dict[str, torch.Tensor]:
    """The plain Wan DiT of the reference layout's shards as the
    standalone ``WanDiT``'s state dict (``dit_state_dict_from``): of
    ``names`` only when given -- a pipeline stage reads its own blocks, the
    rest of the mapped files is never read."""
    sd = read_shards(dit_shards(wan_ckpt_path))
    if names is not None:
        names = set(names)
        sd = {k: v for k, v in sd.items() if k in names}
    return dit_state_dict_from(sd, cfg)


def dit_reference_state_dict(sd: Mapping[str, torch.Tensor],
                             cfg: WanDiTConfig) -> Dict[str, torch.Tensor]:
    """``dit_state_dict_from``'s inverse: a standalone ``WanDiT``'s state
    dict -> the reference WanModel's (the checkpoint file's) layout."""
    out = dict(sd)
    for name, head_dim in _dit_permuted_names(cfg):
        if name in out:
            out[name] = _permute(out[name], head_dim, inverse=True)
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


UNIT_SCALES = (".ls1.gamma", ".ls2.gamma")


# the tensor that marks each kind of pose adapter in a DiT block; the two
# latent methods share their keys, so only the configuration tells them
# apart
_ADAPTER_KEYS = {"adaln": "cross_attn.processor.k_proj.group1.weight",
                 "latent_split or latent_overall":
                 "cross_attn.processor.k_proj.weight"}


def check_pose_adapters(module: nn.Module, sd: Mapping[str, torch.Tensor],
                        what: str) -> None:
    """Raise when a block of a ``WanDiT`` inside ``module`` has a pose
    adapter of another kind than ``sd`` holds for it ('adaln' against
    'latent_split' / 'latent_overall'), naming the block, the method the
    configuration names and the one the tensors show."""
    for name, m in module.named_modules():
        if not isinstance(m, WanDiT):
            continue
        cfg, pre = m.cfg, name + "." if name else ""
        want = ("adaln" if cfg.pose_inject_method == "adaln"
                else "latent_split or latent_overall")
        for i in range(min(cfg.camera_adapter_end, cfg.num_layers)):
            found = [kind for kind, key in _ADAPTER_KEYS.items()
                     if f"{pre}blocks.{i}.{key}" in sd]
            if found and found != [want]:
                raise ValueError(
                    f"{what}: block {i}'s pose adapter tensors are "
                    f"{found[0]!r} ({pre}blocks.{i}."
                    f"{_ADAPTER_KEYS[found[0]]}) but the configuration "
                    f"names pose_inject_method="
                    f"{cfg.pose_inject_method!r}")


def module_state_dict(module: nn.Module, sd: Mapping[str, torch.Tensor],
                      what: str) -> Dict[str, torch.Tensor]:
    """{name: tensor} of every parameter and buffer of ``module`` (which
    may live on the meta device), taken from ``sd``; keys it does not have
    are not read, a key it lacks raises, and so does a pose adapter of
    another kind than the configuration's (``check_pose_adapters``). VGGT
    blocks saved without LayerScale get unit scales, as the reference's
    Identity is."""
    check_pose_adapters(module, sd, what)
    want = module.state_dict()
    missing = sorted(k for k in want if k not in sd
                     and not k.endswith(UNIT_SCALES))
    if missing:
        raise KeyError(f"{what}: the checkpoint lacks {len(missing)} "
                       f"tensors, e.g. {missing[:5]}")
    return {k: sd[k] if k in sd else torch.ones(t.shape, dtype=t.dtype)
            for k, t in want.items()}


def load_into(module: nn.Module, sd: Mapping[str, torch.Tensor],
              what: str) -> nn.Module:
    """Copy ``module_state_dict(module, sd)`` into ``module``."""
    module.load_state_dict(module_state_dict(module, sd, what), strict=True)
    return module


def _encoder_state_dicts(wan_ckpt_path: str, names) -> Dict[str, Dict]:
    """{"t5", "clip", "vae"} of ``names``: the reference layout's files,
    CLIP's visual tower and the VAE without their prefixes."""
    out = {}
    if "vae" in names:
        out["vae"] = _strip(read_pth(os.path.join(wan_ckpt_path, VAE_FILE)),
                            ("model.",))
    if "clip" in names:
        out["clip"] = _strip(read_pth(os.path.join(wan_ckpt_path, CLIP_FILE)),
                             ("model.visual.", "visual."))
    if "t5" in names:
        out["t5"] = read_pth(os.path.join(wan_ckpt_path, T5_FILE))
    return out


def pipeline_state_dicts(wan_ckpt_path: str, model_ckpt: Optional[str],
                         cfg: FusionConfig, encoders: bool = True,
                         components: Sequence[str] = WAN21_COMPONENTS
                         ) -> Dict[str, Dict]:
    """The Wan2.1 reference layout (or bundle) -> {"fusion", "pose" (when
    the fusion file holds one), "t5", "clip", "vae"} of ``components``
    (the encoders left out when ``encoders`` is False): each a state dict
    in the port's names, tensors mapped from the files. Without "fusion"
    neither ``model_ckpt`` nor the DiT shards are read (the pipeline
    trainer's encoders)."""
    want = [c for c in components
            if encoders or c not in ("t5", "clip", "vae")]
    if is_bundle(wan_ckpt_path):
        have = bundle_components(wan_ckpt_path)
        return load_bundle(wan_ckpt_path, [
            c for c in (*WAN21_COMPONENTS, "pose") if c in have
            and (c in want or (c == "pose" and "fusion" in want))])
    out = {}
    if "fusion" in want:
        fusion_sd = read_pth(model_ckpt)
        out["fusion"] = fusion_state_dict_from(
            read_shards(dit_shards(wan_ckpt_path)), fusion_sd, cfg)
        pose_sd = {k[len(POSE_PREFIX):]: v for k, v in fusion_sd.items()
                   if k.startswith(POSE_PREFIX)}
        if pose_sd:
            out["pose"] = pose_sd
    out.update(_encoder_state_dicts(wan_ckpt_path, want))
    return out


def _tokenizer(wan_ckpt_path: str, tokenizer_path: Optional[str]):
    if tokenizer_path is None:
        cand = os.path.join(wan_ckpt_path, "google", "umt5-xxl")
        tokenizer_path = cand if os.path.isdir(cand) else None
    return tokenizer_path


def pipeline_from_state_dicts(sds: Mapping[str, Mapping], cfgs: Mapping, *,
                              device, dtype: torch.dtype = torch.bfloat16,
                              tokenizer_path: Optional[str] = None):
    """``pipeline_state_dicts``' output -> a ``FantasyWorldPipeline`` with
    the modules it holds built on ``device`` in ``dtype`` (the pose
    encoder's widths read off its tensors)."""
    from ..pipelines.wan_video import FantasyWorldPipeline

    def make(ctor, cfg, name):
        if name not in sds:
            return None
        return load_into(build(lambda: ctor(cfg), device=device,
                               dtype=dtype), sds[name], name)

    pose = None
    if "pose" in sds:
        pose = make(CameraPoseEncoder,
                    pose_config_from_state_dict(sds["pose"]), "pose")
    return FantasyWorldPipeline(
        make(FusionModel, cfgs["fusion"], "fusion"), pose,
        t5=make(T5Encoder, cfgs["t5"], "t5"),
        clip=make(CLIPVision, cfgs["clip"], "clip"),
        vae=make(WanVAE, cfgs["vae"], "vae"), tokenizer_path=tokenizer_path)


def load_pipeline(wan_ckpt_path: str, model_ckpt: Optional[str], *, device,
                  dtype: torch.dtype = torch.bfloat16,
                  tokenizer_path: Optional[str] = None,
                  configs: Optional[Mapping[str, object]] = None,
                  encoders: bool = True,
                  components: Sequence[str] = WAN21_COMPONENTS):
    """The reference layout, or a bundle (``convert/bundle.py``; then
    ``model_ckpt`` is not read) -> a ``FantasyWorldPipeline`` with the
    fusion model, the pose encoder, umT5, CLIP and the VAE built on
    ``device`` in ``dtype``; without umT5, CLIP and the VAE when
    ``encoders`` is False (a mesh rank other than 0, which neither
    conditions nor decodes); of ``components`` only (("t5", "clip",
    "vae"): the encoders alone, ``model_ckpt`` not read). ``configs``
    override ``read_configs``'."""
    cfgs = {**read_configs(wan_ckpt_path), **(configs or {})}
    missing = missing_files(wan_ckpt_path, model_ckpt, components)
    if missing:
        raise FileNotFoundError(f"checkpoint files missing: {missing}")
    return pipeline_from_state_dicts(
        pipeline_state_dicts(wan_ckpt_path, model_ckpt, cfgs["fusion"],
                             encoders, components),
        cfgs, device=device, dtype=dtype,
        tokenizer_path=_tokenizer(wan_ckpt_path, tokenizer_path))


def expert_state_dict(wan_ckpt_path: str, high: bool,
                      model_ckpt: Optional[str], cfg: FusionConfig
                      ) -> Dict[str, torch.Tensor]:
    """One Wan2.2 expert: its base DiT shards with its Reward-LoRA merged,
    the fusion checkpoint overlaid -> {FusionModel name: tensor}; of a
    bundle, its ``fusion_high`` / ``fusion_low``."""
    from .lora import merge_lora_into_state_dict
    if is_bundle(wan_ckpt_path):
        name = "fusion_high" if high else "fusion_low"
        return load_bundle(wan_ckpt_path, [name])[name]
    base = read_shards(dit_shards(wan_ckpt_path, EXPERT_SHARDS[high]))
    base = merge_lora_into_state_dict(
        base, read_safetensors(os.path.join(wan_ckpt_path,
                                            EXPERT_LORAS[high])),
        multiplier=LORA_MULTIPLIER, verbose=True)
    return fusion_state_dict_from(base, read_pth(model_ckpt), cfg)


def wan22_encoder_state_dicts(wan_ckpt_path: str) -> Dict[str, Dict]:
    """{"t5", "vae"} of the Wan2.2 layout or bundle."""
    if is_bundle(wan_ckpt_path):
        return load_bundle(wan_ckpt_path, ["t5", "vae"])
    return _encoder_state_dicts(wan_ckpt_path, ("t5", "vae"))


def place_experts(expert_sds, cfg: FusionConfig, *, device,
                  dtype: torch.dtype = torch.bfloat16,
                  quant: Optional[str] = None,
                  timestep_boundary: float = 900.0, mesh=None):
    """((high, state dict or a callable that returns it), (low, ...))
    -> a ``DualModelDenoiser``. On a card the high expert is built there
    and the low one in pinned host memory, to trade places at the
    boundary; on the CPU both are built there. ``quant`` ("int8" / "fp8")
    quantizes each expert as it loads, layer by layer on ``device``,
    before the low one is pinned. A callable is called only when its
    expert is built, so one expert's tensors are read at a time.

    ``mesh``: each expert is built as this rank's part (``FusionModel.
    shard`` on the meta device), filled from its part of the state dict
    and quantized over the model axis, so no rank holds or pins a whole
    expert; the low one then goes to the card beside the high one where
    both parts fit (``wan_video_22.both_fit``), else to pinned host
    memory."""
    from ..parallel import sharding
    from ..parallel.distributed import ranks_per_card
    from ..pipelines.wan_video_22 import (DualModelDenoiser, both_fit,
                                          expert_bytes, place_expert)
    device = torch.device(device)
    meshed = mesh is not None and not mesh.trivial
    experts = {}
    both = device.type == "cpu"
    for high, sd in expert_sds:
        on_card = high or both
        model = build(lambda: FusionModel(cfg), dtype=dtype,
                      device=device if on_card else "cpu",
                      mesh=mesh if meshed else None)
        sd = sd() if callable(sd) else sd
        if meshed:
            sd = sharding.shard_state_dict(sd, mesh)
        load_into(model, sd, "high expert" if high else "low expert")
        experts[high] = place_expert(model, device, on_host=not on_card,
                                     quant=quant)
        if high and meshed:
            both = both_fit(expert_bytes(model), device, ranks_per_card())
    return DualModelDenoiser(experts[True], experts[False],
                             timestep_boundary)


def load_wan22(wan_ckpt_path: str, model_ckpt_high: Optional[str],
               model_ckpt_low: Optional[str], *, device,
               dtype: torch.dtype = torch.bfloat16,
               tokenizer_path: Optional[str] = None,
               timestep_boundary: float = 900.0,
               quant: Optional[str] = None,
               configs: Optional[Mapping[str, object]] = None, mesh=None,
               encoders: bool = True):
    """The Wan2.2 layout, or a bundle -> (a ``FantasyWorldPipeline`` with
    umT5 and the VAE -- empty when ``encoders`` is False, as on a mesh
    rank other than 0 --, a ``DualModelDenoiser`` (``place_experts``,
    split over ``mesh`` when given)), all in ``dtype``. ``configs``
    override ``read_configs``'."""
    from ..pipelines.wan_video import FantasyWorldPipeline
    cfgs = {**read_configs(wan_ckpt_path, wan22_fusion_config()),
            **(configs or {})}
    missing = missing_files_wan22(wan_ckpt_path, model_ckpt_high,
                                  model_ckpt_low)
    if missing:
        raise FileNotFoundError(f"checkpoint files missing: {missing}")
    cfg = cfgs["fusion_high"]
    den = place_experts(
        [(high, lambda high=high, ckpt=ckpt: expert_state_dict(
            wan_ckpt_path, high, ckpt, cfg))
         for high, ckpt in ((True, model_ckpt_high),
                            (False, model_ckpt_low))],
        cfg, device=device, dtype=dtype, quant=quant,
        timestep_boundary=timestep_boundary, mesh=mesh)
    sds = wan22_encoder_state_dicts(wan_ckpt_path) if encoders else {}
    pipe = pipeline_from_state_dicts(
        sds, cfgs, device=device, dtype=dtype,
        tokenizer_path=_tokenizer(wan_ckpt_path, tokenizer_path))
    return pipe, den
