"""Config (de)serialization for the port's bundles (``utils/configio.py``).

The reference derives every architecture from a state-dict hash at load
time; ``cli/convert.py`` instead stamps the resolved configs into the
bundle once (``convert/bundle.py:save_bundle``, ``configs.json``), and the
loaders rebuild the exact dataclasses from it, so a bundle of any size
(the production 14B or a reduced one) loads without the caller naming its
widths. ``configs.json`` in a reference-layout directory
(``convert/checkpoint.py:read_configs``) has the same schema.

Every config is a (nested) frozen dataclass whose fields are ints, floats,
bools, strings, tuples or further configs; the two functions below
round-trip that through JSON.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Dict, Mapping, Optional


def config_to_dict(cfg) -> Dict:
    """Recursive dataclass -> plain JSON-serializable dict."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = config_to_dict(v)
        elif isinstance(v, tuple):
            out[f.name] = list(v)
        else:
            out[f.name] = v
    return out


def _field_type(hints, f):
    t = hints.get(f.name, f.type)
    if typing.get_origin(t) is typing.Union:          # Optional[...]
        args = [a for a in typing.get_args(t) if a is not type(None)]
        if args:
            t = args[0]
    return t


def config_from_dict(cls, d: Mapping, default: Optional[object] = None):
    """A ``cls`` config from ``config_to_dict`` output. Unknown keys are
    ignored; a missing key keeps ``default``'s value (an instance of
    ``cls``; ``cls()`` when none is given). Lists become tuples, and
    config-typed fields recurse over ``default``'s nested config, so a
    nested default that differs from its class's (``FusionConfig.dit``)
    holds too."""
    if default is None:
        try:
            default = cls()
        except TypeError:       # a field without a default
            default = None
    try:
        hints = typing.get_type_hints(cls)
    except Exception:      # unresolvable forward refs: the raw annotations
        hints = {f.name: f.type for f in dataclasses.fields(cls)}
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v, t = d[f.name], _field_type(hints, f)
        cur = None if default is None else getattr(default, f.name)
        if v is None:
            kw[f.name] = None
        elif dataclasses.is_dataclass(t) or dataclasses.is_dataclass(cur):
            sub = type(cur) if dataclasses.is_dataclass(cur) else t
            kw[f.name] = config_from_dict(sub, v, cur)
        elif typing.get_origin(t) is tuple or t is tuple \
                or isinstance(v, list):
            kw[f.name] = tuple(v)
        else:
            kw[f.name] = v
    if default is not None:
        return dataclasses.replace(default, **kw)
    return cls(**kw)


def config_registry() -> Dict[str, type]:
    """Bundle config key -> dataclass: the bundle's component names
    (fusion / fusion_high / fusion_low / dit / t5 / clip / vae) and "pose"
    for the camera pose encoder."""
    from ..models.fusion.model import FusionConfig
    from ..models.wan.camera import CameraPoseEncoderConfig
    from ..models.wan.clip import CLIPVisionConfig
    from ..models.wan.dit import WanDiTConfig
    from ..models.wan.t5 import T5Config
    from ..models.wan.vae import VAEConfig
    return {
        "fusion": FusionConfig,
        "fusion_high": FusionConfig,
        "fusion_low": FusionConfig,
        "dit": WanDiTConfig,
        "t5": T5Config,
        "clip": CLIPVisionConfig,
        "vae": VAEConfig,
        "pose": CameraPoseEncoderConfig,
    }
