"""Hash-keyed architecture detection for checkpoints (``convert/
registry.py``).

The reference's scheme: md5 over the sorted "key:shape,key" census of a
state dict, so the same ``.pth`` / ``.safetensors`` files resolve to the
same architectures. The hashes are the reference registry's, unchanged;
``detect`` maps a state dict to a model name and the configuration fields
its entry sets (``convert/manager.py`` turns them into the port's
configs).
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, Mapping, Tuple


def state_dict_census(state_dict: Mapping[str, Any], with_shape: bool = True
                      ) -> str:
    """The sorted "key:d0_d1_...,key" census of a (nested) state dict;
    anything without a ``shape`` is left out."""
    keys = []
    for key, value in state_dict.items():
        if not isinstance(key, str):
            continue
        if isinstance(value, dict):
            keys.append(key + "|" + state_dict_census(value, with_shape))
        else:
            shape = getattr(value, "shape", None)
            if shape is None:
                continue
            if with_shape:
                keys.append(key + ":" + "_".join(map(str, list(shape))))
            keys.append(key)
    keys.sort()
    return ",".join(keys)


def hash_state_dict_keys(state_dict: Mapping[str, Any],
                         with_shape: bool = True) -> str:
    return hashlib.md5(
        state_dict_census(state_dict, with_shape).encode("utf-8")).hexdigest()


# hash -> configuration fields, in the reference registry's names (the
# entries FantasyWorld's paths load)
_DIT_14B_I2V = dict(has_image_input=True, patch_size=(1, 2, 2), in_dim=36,
                    dim=5120, ffn_dim=13824, freq_dim=256, text_dim=4096,
                    out_dim=16, num_heads=40, num_layers=40, eps=1e-6)

WAN_DIT_CONFIGS: Dict[str, Dict] = {
    # 14B T2V
    "aafcfd9672c3a2456dc46e1cb6e52c70": dict(
        _DIT_14B_I2V, has_image_input=False, in_dim=16),
    # 14B I2V (the FantasyWorld-Wan2.1 base)
    "6bfcfb3b342cb286ce886889d519a77e": dict(_DIT_14B_I2V),
    # 1.3B T2V
    "9269f8db9040a9d860eaca435be61814": dict(
        _DIT_14B_I2V, has_image_input=False, in_dim=16, dim=1536,
        ffn_dim=8960, num_heads=12, num_layers=30),
    # 1.3B I2V
    "6d6ccde6845b95ad9114ab993d917893": dict(
        _DIT_14B_I2V, dim=1536, ffn_dim=8960, num_heads=12, num_layers=30),
    # 14B I2V with image position embedding (FLF2V)
    "3ef3b1f8e1dab83d5b71fd7b617f859f": dict(
        _DIT_14B_I2V, has_image_pos_emb=True),
    # Wan2.2 Fun Control-Camera (control adapter, no CLIP branch)
    "47dbeab5e560db3180adf51dc0232fb1": dict(
        _DIT_14B_I2V, has_image_input=False, add_control_adapter=True,
        in_dim_control_adapter=24, require_clip_embedding=False),
    # Wan2.2 TI2V-5B (per-token timestep, fused first-frame latent, the
    # 38-block VAE's z = 48)
    "1f5ab7703c6fc803fdded85ff040c316": dict(
        has_image_input=False, patch_size=(1, 2, 2), in_dim=48, dim=3072,
        ffn_dim=14336, freq_dim=256, text_dim=4096, out_dim=48,
        num_heads=24, num_layers=30, eps=1e-6, seperated_timestep=True,
        require_vae_embedding=False, fuse_vae_embedding_in_latents=True),
}

WAN_T5_HASH = "9c8818c2cbea55eca56c7b447df170da"
WAN_CLIP_HASH = "5941c53e207d62f20f9025686193c40b"
WAN21_VAE_HASH = "1378ea763357eea97acdef78e65d6d96"
WAN21_VAE_HASH_ALT = "ccc42284ea13e1ad04693284c7a09be6"


def detect(state_dict: Mapping[str, Any]) -> Tuple[str, Dict]:
    """(model name, configuration fields) of a raw state dict; raises
    KeyError for a census the registry does not hold."""
    h = hash_state_dict_keys(state_dict)
    if h in WAN_DIT_CONFIGS:
        return "wan_video_dit", WAN_DIT_CONFIGS[h]
    if h == WAN_T5_HASH:
        return "wan_video_text_encoder", {}
    if h == WAN_CLIP_HASH:
        return "wan_video_image_encoder", {}
    if h in (WAN21_VAE_HASH, WAN21_VAE_HASH_ALT):
        return "wan_video_vae", {}
    raise KeyError(f"unrecognized state dict (hash {h})")
