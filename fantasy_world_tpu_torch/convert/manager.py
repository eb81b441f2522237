"""ModelManager: checkpoint files -> hash-detected modules
(``convert/manager.py``).

Loads a ``.pth`` / ``.safetensors`` file, a shard list, a directory of
shards or an in-memory state dict; detects the architecture by the md5 of
its key census (``convert/registry.py``); builds the port's module of that
architecture on the manager's device in its dtype (the card in bf16
unless the caller asks for the CPU) and loads the tensors
(the DiT's self-attention q/k permuted for the rotate-half RoPE, as
``convert/checkpoint.py`` does); serves the modules by name. A TI2V-5B DiT
file becomes a ``WanDiT`` with ``seperated_timestep``, which
``pipelines/ti2v.py:denoise_ti2v`` takes.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from ..core.params import build
from .checkpoint import _strip, dit_state_dict_from, load_into, read_state_dict
from .registry import detect

Source = Union[str, Sequence[str], Mapping[str, torch.Tensor]]


def _translate_dit_config(overrides: Mapping) -> Dict:
    """Registry entries use the reference's flag names: Wan2.2 carries
    ``require_clip_embedding`` beside an explicit ``has_image_input``; the
    explicit module flag wins, and ``require_clip_embedding`` stands in
    only when it is absent."""
    out = dict(overrides)
    clip_flag = out.pop("require_clip_embedding", None)
    if clip_flag is not None and "has_image_input" not in out:
        out["has_image_input"] = clip_flag
    return out


# registry model name -> bundle component name (``convert/bundle.py``)
COMPONENTS = {"wan_video_dit": "dit", "wan_video_text_encoder": "t5",
              "wan_video_image_encoder": "clip", "wan_video_vae": "vae"}


def detected_module(name: str, overrides: Mapping,
                    sd: Mapping[str, torch.Tensor]):
    """(config, module constructor, state dict in the port's names) of a
    state dict that ``detect`` named."""
    from ..models.wan.clip import CLIPVision, CLIPVisionConfig
    from ..models.wan.dit import WanDiT, WanDiTConfig
    from ..models.wan.t5 import T5Config, T5Encoder
    from ..models.wan.vae import VAEConfig, WanVAE
    if name == "wan_video_dit":
        cfg = WanDiTConfig(**_translate_dit_config(overrides))
        return cfg, WanDiT, dit_state_dict_from(sd, cfg)
    if name == "wan_video_text_encoder":
        return T5Config(), T5Encoder, dict(sd)
    if name == "wan_video_image_encoder":
        # the file holds the bare XLM-RoBERTa CLIP: 'visual.*' and the text
        # tower 'textual.*', which the port does not build
        return (CLIPVisionConfig(), CLIPVision,
                _strip(sd, ("model.visual.", "visual.")))
    if name == "wan_video_vae":
        return VAEConfig(), WanVAE, _strip(sd, ("model.",))
    raise KeyError(name)                         # pragma: no cover


def build_detected(name: str, overrides: Mapping,
                   sd: Mapping[str, torch.Tensor], *, device,
                   dtype: torch.dtype) -> Tuple[object, nn.Module]:
    """(config, module built on ``device`` in ``dtype`` holding ``sd``)."""
    cfg, ctor, sd = detected_module(name, overrides, sd)
    module = build(lambda: ctor(cfg), device=device, dtype=dtype)
    return cfg, load_into(module, sd, name)


class ModelManager:
    """load_models(paths) -> fetch_model(name) over the built modules."""

    def __init__(self, device="cuda", dtype: torch.dtype = torch.bfloat16):
        self.device, self.dtype = torch.device(device), dtype
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' (and "
                               "torch.float32) to load on the CPU")
        # name -> [(config, module), ...] in load order: two checkpoints of
        # one architecture (the Wan2.2 experts both detect as
        # wan_video_dit) coexist, fetched by index
        self.models: Dict[str, List[Tuple[object, nn.Module]]] = {}

    def load_model(self, path: Source) -> str:
        """path: a file, a shard list, a directory, or a state dict already
        in memory (in the reference's names)."""
        sd = path if isinstance(path, Mapping) else read_state_dict(path)
        name, overrides = detect(sd)
        self.models.setdefault(name, []).append(build_detected(
            name, overrides, sd, device=self.device, dtype=self.dtype))
        return name

    def load_models(self, paths: Sequence[Source]) -> List[str]:
        return [self.load_model(p) for p in paths]

    def fetch_model(self, name: str, index: Optional[int] = None):
        """index=None -> the first loaded (config, module) (with a notice
        when several match); index=N -> the first N as a list."""
        if name not in self.models:
            raise KeyError(f"{name} not loaded; have {sorted(self.models)}")
        entries = self.models[name]
        if index is not None:
            return entries[:index]
        if len(entries) > 1:
            print(f"More than one {name} loaded; using the first of "
                  f"{len(entries)} (pass index=N for the list)")
        return entries[0]

    def fetch_params(self, name: str) -> Dict[str, torch.Tensor]:
        """The first ``name`` module's state dict (the port's names)."""
        return self.fetch_model(name)[1].state_dict()


def from_model_configs(model_configs: Sequence,
                       manager: Optional[ModelManager] = None
                       ) -> ModelManager:
    """Resolve ``downloader.ModelConfig`` entries on the local disk and
    load them (into a new manager on the card unless one is given)."""
    manager = manager or ModelManager()
    for mc in model_configs:
        mc.download_if_necessary()
        manager.load_model(mc.path)
    return manager
