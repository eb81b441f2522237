"""Converted bundles: the port's counterpart of JAX ``convert/orbax_io.py:
save_bundle`` (Orbax itself stays with the JAX package).

A bundle is a directory holding one ``<component>.safetensors`` per
component -- the port's state dict of that module, in the port's names and
q/k column order (``convert/checkpoint.py``), so it loads without renaming
or permuting -- a ``configs.json`` in ``utils/configio.py``'s schema
(the reference layout's ``configs.json`` has the same one) and the
manifest ``bundle.json``. Components: ``fusion``, ``pose``, ``t5``,
``clip``, ``vae`` (Wan2.1); ``fusion_high``, ``fusion_low``, ``t5``,
``vae`` (Wan2.2); or the single component a ``cli.convert --file`` run
detects (``dit``, ``t5``, ``clip``, ``vae``).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn as nn

MANIFEST = "bundle.json"
CONFIGS = "configs.json"


def is_bundle(path: Optional[str]) -> bool:
    return bool(path) and os.path.isfile(os.path.join(path, MANIFEST))


def _tensors(component) -> Mapping[str, torch.Tensor]:
    return component.state_dict() if isinstance(component, nn.Module) \
        else component


def save_bundle(components: Mapping[str, object], path: str,
                configs: Optional[Mapping[str, object]] = None,
                dtype: Optional[torch.dtype] = None) -> str:
    """{name: state dict, module, or a callable returning one} -> a
    bundle directory at ``path`` (created; returned as an absolute path).
    A callable is called when its component is written, so one
    component's tensors are held at a time. Floating tensors are cast to
    ``dtype`` when it is given. ``configs``: {key: config dataclass}, keys
    per ``configio.config_registry``."""
    from .checkpoint import write_safetensors
    from ..utils.configio import config_to_dict
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    for name, comp in components.items():
        comp = comp() if callable(comp) and not isinstance(
            comp, nn.Module) else comp
        sd = {k: (v.to(dtype) if dtype is not None and v.is_floating_point()
                  else v) for k, v in _tensors(comp).items()}
        write_safetensors(os.path.join(path, name + ".safetensors"), sd)
    configs = dict(configs or {})
    with open(os.path.join(path, CONFIGS), "w") as fh:
        json.dump({k: config_to_dict(v) for k, v in configs.items()}, fh,
                  indent=1)
    with open(os.path.join(path, MANIFEST), "w") as fh:
        json.dump({"components": sorted(components), "format": 1,
                   "configs": sorted(configs)}, fh)
    return path


def bundle_components(path: str) -> list:
    with open(os.path.join(path, MANIFEST)) as fh:
        return list(json.load(fh)["components"])


def load_bundle(path: str, components: Optional[Sequence[str]] = None
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{name: state dict} of a bundle, each tensor a view of its file
    mapped from disk; ``components`` restricts and orders them (a missing
    one raises KeyError)."""
    from .checkpoint import read_safetensors
    have = bundle_components(path)
    want = list(components) if components is not None else have
    missing = [c for c in want if c not in have]
    if missing:
        raise KeyError(f"bundle {path} lacks components {missing}; has "
                       f"{sorted(have)}")
    return {name: read_safetensors(os.path.join(path, name + ".safetensors"))
            for name in want}


def load_bundle_configs(path: str) -> Dict[str, object]:
    """{key: config dataclass} stamped by ``save_bundle``."""
    from ..utils.configio import config_from_dict, config_registry
    fn = os.path.join(path, CONFIGS)
    if not os.path.isfile(fn):
        return {}
    reg = config_registry()
    with open(fn) as fh:
        raw = json.load(fh)
    return {k: config_from_dict(reg[k], v) for k, v in raw.items()
            if k in reg}
