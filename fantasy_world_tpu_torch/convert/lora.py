"""LoRA merge into a flat state dict (the port's copy of
``convert/lora.py``): the Wan2.2 Reward-LoRA applied to each expert's base
DiT before the fusion checkpoint is overlaid.

The LoRA file's keys come in kohya (``lora_unet_blocks_0_self_attn_q.
lora_up.weight``, ``.alpha``) or peft (``blocks.0.self_attn.q.lora_A.
default.weight``) form. Each is normalised to a mangled layer name (every
'.' flattened to '_'), which is matched to the unique ``.weight`` key of the
state dict whose own flattening equals it, or, when the LoRA omits module
prefixes, ends with it at a token boundary.

    W += multiplier * alpha / rank * (up @ down)

computed in f32 and cast back to W's dtype; a 1x1-conv LoRA merges the
same way. Layers that match nothing, or lack up or down, are counted and
left out.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Mapping

import torch

_SUFFIXES = (("_lora_up_weight", ".lora_up.weight"),
             ("_lora_down_weight", ".lora_down.weight"),
             ("_lora_A_default_weight", ".lora_A.weight"),
             ("_lora_B_default_weight", ".lora_B.weight"),
             ("_lora_A_weight", ".lora_A.weight"),
             ("_lora_B_weight", ".lora_B.weight"),
             ("_alpha", ".alpha"))


def _normalize_key(key: str) -> str:
    if "lora_A" in key or "lora_B" in key:
        key = "lora_unet__" + key
    key = key.replace(".", "_")
    for suffix, repl in _SUFFIXES:
        if key.endswith(suffix):
            key = key[: -len(suffix)] + repl
            break
    return (key.replace(".lora_A.default.", ".lora_down.")
               .replace(".lora_B.default.", ".lora_up.")
               .replace(".lora_A.", ".lora_down.")
               .replace(".lora_B.", ".lora_up."))


def resolve_lora_targets(sd: Mapping, lora_keys) -> Dict[str, str]:
    """Mangled LoRA layer name -> the ``.weight`` key of ``sd`` it
    adapts."""
    flat_index = {k[:-len(".weight")].replace(".", "_"): k
                  for k in sd if k.endswith(".weight")}
    out = {}
    for key in lora_keys:
        layer = _normalize_key(key).split(".", 1)[0]
        # peft keys got the 'lora_unet__' prefix: the empty segment after
        # it is dropped, as the reference's attribute walk skips it
        name = layer.split("lora_unet_")[-1].lstrip("_")
        target = flat_index.get(name)
        if target is None:
            # a suffix at a token boundary, and only a unique one: a bare
            # endswith would take "attn_q" into "cross_attn_q" and
            # "self_attn_q"
            cands = [v for k, v in flat_index.items()
                     if k.endswith("_" + name)]
            target = cands[0] if len(cands) == 1 else None
        if target is not None:
            out[layer] = target
    return out


def merge_lora_into_state_dict(sd: Dict[str, torch.Tensor],
                               lora_sd: Mapping[str, torch.Tensor],
                               multiplier: float = 0.55,
                               verbose: bool = False
                               ) -> Dict[str, torch.Tensor]:
    """A copy of ``sd`` with the LoRA deltas merged into the matched
    weights (new tensors; the others are ``sd``'s own)."""
    updates: Dict[str, Dict[str, torch.Tensor]] = defaultdict(dict)
    for key, value in lora_sd.items():
        key = _normalize_key(key)
        if "." not in key:
            # an element suffix the merge does not know (dora_scale, ...):
            # an unmatched layer, as the reference counts it
            updates[key]
            continue
        layer, elem = key.split(".", 1)
        updates[layer][elem] = torch.as_tensor(value)
    targets = resolve_lora_targets(sd, lora_sd.keys())
    merged = dict(sd)
    n_hit = n_miss = 0
    for layer, elems in updates.items():
        target = targets.get(layer)
        if target is None or "lora_up.weight" not in elems \
                or "lora_down.weight" not in elems:
            n_miss += 1
            if verbose:
                print(f"[lora] unmatched layer: {layer}")
            continue
        up = elems["lora_up.weight"].float()
        down = elems["lora_down.weight"].float()
        alpha = (float(elems["alpha"]) / up.shape[1]
                 if "alpha" in elems else 1.0)
        if up.ndim == 4:
            delta = (up[..., 0, 0] @ down[..., 0, 0])[..., None, None]
        else:
            delta = up @ down
        w = sd[target]
        merged[target] = (w.float() + multiplier * alpha * delta).to(w.dtype)
        n_hit += 1
    if verbose:
        print(f"[lora] merged {n_hit} layers, {n_miss} unmatched")
    return merged
