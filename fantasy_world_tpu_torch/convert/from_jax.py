"""JAX parameter tree (numpy leaves) -> the port's ``state_dict``: the
fusion model, the standalone DiT, the camera pose encoder, LoRA factors,
umT5, CLIP, the VAE, the 38-block VAE and the VGGT track head (whose
split q/k/v kernels go back into ``nn.MultiheadAttention``'s packed
``in_proj_weight``).

The JAX package keeps linear kernels as (in, out) and per-block lists
(``init_fusion``); the port keeps PyTorch's (out, in) and the reference
checkpoint's names. So this module:

  * transposes every linear ``kernel`` into ``weight``;
  * reshapes the kernel==stride patch embeddings and the 1x1x1 VGGT
    projection, stored by the JAX package as matmul kernels, back into
    their Conv3d weights;
  * carries convolution kernels over unchanged: the JAX tree already keeps
    torch's (out, in, ...) layout for them;
  * renames scale -> weight for norms, and the JAX sub-tree names into the
    reference's module paths (``text_embedding.fc1`` -> ``text_embedding.0``,
    ``camera`` -> ``cross_attn.processor``, DPT ``scratch.*``, ...).

Nothing is unstacked in the model tree: the JAX tree keeps per-block lists.
LoRA factors are the exception: the JAX trainer stacks them per scan
segment, and ``lora_state_dict`` unstacks them onto the per-block modules.

RoPE column order: the JAX checkpoint converters de-interleave the q/k
projection columns (``ops/rope.py:permute_qk_out_channels``) so that the
rotate-half form applies, and the JAX model runs ``apply_rope_half``. This
module keeps the JAX column order and the port runs ``apply_rope_half``
too, so a tree carried across from the JAX package needs no permutation. A
loader of the published torch checkpoints must apply
``permute_qk_out_channels`` to the DiT self-attention q/k (weights, biases,
RMS scales) and the bicross m1/m2 projections, as ``convert/wan_dit.py`` and
``convert/fusion.py`` do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.fusion.bicross import BicrossConfig
from ..models.fusion.model import FusionConfig
from ..models.vggt.aggregator import AggregatorConfig
from ..models.vggt.model import VGGTConfig
from ..models.wan.camera import CameraPoseEncoderConfig
from ..models.wan.dit import WanDiTConfig
from ..models.wan.vae import (VAEConfig, decoder_upsample_plan,
                              encoder_downsample_plan)


def _config(cls, obj, **sub):
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
          if f.name not in sub and hasattr(obj, f.name)}
    return cls(**kw, **sub)


def fusion_config_from(cfg) -> FusionConfig:
    """The port's FusionConfig holding the field values of a JAX-package
    FusionConfig (the two declare the same fields)."""
    vggt = _config(VGGTConfig, cfg.vggt,
                   aggregator=_config(AggregatorConfig, cfg.vggt.aggregator))
    return _config(FusionConfig, cfg, dit=_config(WanDiTConfig, cfg.dit),
                   vggt=vggt, bicross=_config(BicrossConfig, cfg.bicross))


def pose_config_from(cfg, params: Optional[Mapping] = None
                     ) -> CameraPoseEncoderConfig:
    """The port's config of a JAX camera pose encoder: the JAX config's
    fields, and the conv widths of its parameter tree when one is given
    (the JAX config has none; ``convert/camera.py`` reads them off the
    checkpoint)."""
    if params is None:
        return _config(CameraPoseEncoderConfig, cfg)
    e1, e2 = params["encode_first"], params["encode_second"]
    hidden = tuple(int(np.shape(c["kernel"])[0]) for c in
                   (e1["conv1"], e1["conv2"], e2["conv1"]))
    return _config(CameraPoseEncoderConfig, cfg, hidden=hidden)


def encoder_config_from(cls, cfg):
    """The port's ``cls`` (T5Config, CLIPVisionConfig, VAEConfig) holding
    the field values of the JAX package's config of the same name."""
    return _config(cls, cfg)


def _arr(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _quantized(kernel) -> torch.Tensor:
    """A quantized JAX kernel (in, out), int8 or float8_e4m3fn -> the same
    bits as an (out, in) tensor of that dtype."""
    a = np.ascontiguousarray(np.asarray(kernel).T)
    if a.dtype == np.int8:
        return torch.from_numpy(a)
    if a.dtype.itemsize != 1 or "float8_e4m3fn" not in str(a.dtype):
        raise ValueError(f"not an int8 or float8_e4m3fn kernel: {a.dtype}")
    return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)


class _Writer:
    def __init__(self, shapes: Mapping[str, torch.Size]):
        self.shapes = shapes
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, name: str, value) -> None:
        t = _arr(value)
        if name in self.shapes and tuple(t.shape) != tuple(self.shapes[name]):
            t = t.reshape(self.shapes[name])
        self.sd[name] = t

    def linear(self, name: str, p: Mapping) -> None:
        """A float ``kernel`` (in, out), or a quantized one (``kernel_q``
        int8 / ``kernel_f8`` float8_e4m3fn, with ``kscale``) for a
        ``QuantLinear``, whose bits are kept."""
        if "kernel_q" in p or "kernel_f8" in p:
            self.sd[name + ".weight"] = _quantized(
                p["kernel_q"] if "kernel_q" in p else p["kernel_f8"])
            self.put(name + ".kscale", p["kscale"])
        else:
            self.put(name + ".weight", np.asarray(p["kernel"], np.float32).T)
        if "bias" in p:
            self.put(name + ".bias", p["bias"])

    def conv(self, name: str, p: Mapping) -> None:
        self.put(name + ".weight", p["kernel"])
        if "bias" in p:
            self.put(name + ".bias", p["bias"])

    def norm(self, name: str, p: Mapping) -> None:
        if "scale" in p:
            self.put(name + ".weight", p["scale"])
        if "bias" in p:
            self.put(name + ".bias", p["bias"])

    def mlp(self, name: str, p: Mapping) -> None:
        """fc1/fc2 -> the reference's Sequential(Linear, act, Linear)."""
        self.linear(name + ".0", p["fc1"])
        self.linear(name + ".2", p["fc2"])


def _dit(w: _Writer, p: Mapping, pre: str) -> None:
    w.linear(pre + "patch_embedding", p["patch_embedding"])
    w.mlp(pre + "text_embedding", p["text_embedding"])
    w.mlp(pre + "time_embedding", p["time_embedding"])
    w.linear(pre + "time_projection.1", p["time_projection"])
    w.linear(pre + "head.head", p["head"]["head"])
    w.put(pre + "head.modulation", p["head"]["modulation"])
    if "img_emb" in p:
        ie = p["img_emb"]
        w.norm(pre + "img_emb.proj.0", ie["norm_in"])
        w.linear(pre + "img_emb.proj.1", ie["fc1"])
        w.linear(pre + "img_emb.proj.3", ie["fc2"])
        w.norm(pre + "img_emb.proj.4", ie["norm_out"])
        if "emb_pos" in ie:
            w.put(pre + "img_emb.emb_pos", ie["emb_pos"])
    if "control_adapter" in p:
        ca = p["control_adapter"]
        w.conv(pre + "control_adapter.conv", ca["conv"])
        for i, rb in enumerate(ca["residual_blocks"]):
            w.conv(f"{pre}control_adapter.residual_blocks.{i}.conv1",
                   rb["conv1"])
            w.conv(f"{pre}control_adapter.residual_blocks.{i}.conv2",
                   rb["conv2"])
    for i, b in enumerate(p["blocks"]):
        bp = f"{pre}blocks.{i}."
        for attn in ("self_attn", "cross_attn"):
            a = b[attn]
            for name in ("q", "k", "v", "o", "k_img", "v_img"):
                if name in a:
                    w.linear(f"{bp}{attn}.{name}", a[name])
            for name in ("norm_q", "norm_k", "norm_k_img"):
                if name in a:
                    w.norm(f"{bp}{attn}.{name}", a[name])
        w.norm(bp + "norm3", b["norm3"])
        w.mlp(bp + "ffn", b["ffn"])
        w.put(bp + "modulation", b["modulation"])
        if "camera" in b:
            cam, cp = b["camera"], bp + "cross_attn.processor."
            if "k_group1" in cam:                              # 'adaln'
                w.linear(cp + "k_proj.group1", cam["k_group1"])
                w.mlp(cp + "k_proj.group2", cam["k_group2"])
                w.mlp(cp + "v_proj.group2", cam["v_group2"])
            else:                    # 'latent_split' / 'latent_overall'
                w.linear(cp + "k_proj", cam["k_proj"])
                w.linear(cp + "v_proj", cam["v_proj"])


def _vggt_block(w: _Writer, p: Mapping, pre: str) -> None:
    w.norm(pre + "norm1", p["norm1"])
    w.linear(pre + "attn.qkv", p["attn"]["qkv"])
    w.linear(pre + "attn.proj", p["attn"]["proj"])
    for name in ("q_norm", "k_norm"):
        if name in p["attn"]:
            w.norm(f"{pre}attn.{name}", p["attn"][name])
    w.put(pre + "ls1.gamma", p["ls1"]["gamma"])
    w.norm(pre + "norm2", p["norm2"])
    w.linear(pre + "mlp.fc1", p["mlp"]["fc1"])
    w.linear(pre + "mlp.fc2", p["mlp"]["fc2"])
    w.put(pre + "ls2.gamma", p["ls2"]["gamma"])
    if "modulation" in p:
        w.put(pre + "modulation", p["modulation"])


def _dpt(w: _Writer, p: Mapping, pre: str) -> None:
    w.norm(pre + "norm", p["norm"])
    for i, proj in enumerate(p["projects"]):
        w.conv(f"{pre}projects.{i}", proj)
    for i in (0, 1, 3):
        w.conv(f"{pre}resize_layers.{i}", p[f"resize{i}"])
    for i, tu in enumerate(p["temporal_upsamplers"]):
        tp = f"{pre}temporal_upsamplers.{i}."
        w.conv(tp + "conv2", tu["conv2"])
        for j, (up, res) in enumerate((("up1", "res1"), ("up2", "res2"))):
            w.conv(f"{tp}decoder.upsamples.{2 * j}.time_conv",
                   tu[up]["time_conv"])
            rp = f"{tp}decoder.upsamples.{2 * j + 1}.residual."
            w.put(rp + "0.gamma", tu[res]["norm"]["gamma"])
            w.conv(rp + "2", tu[res]["conv"])
    sp = pre + "scratch."
    for i, conv in enumerate(p["layer_rn"]):
        w.conv(f"{sp}layer{i + 1}_rn", conv)
    for k in (1, 2, 3, 4):
        fb, fp = p[f"refinenet{k}"], f"{sp}refinenet{k}."
        w.conv(fp + "out_conv", fb["out_conv"])
        for unit in (1, 2):
            if f"res{unit}_conv1" in fb:
                w.conv(f"{fp}resConfUnit{unit}.conv1", fb[f"res{unit}_conv1"])
                w.conv(f"{fp}resConfUnit{unit}.conv2", fb[f"res{unit}_conv2"])
    w.conv(sp + "output_conv1", p["output_conv1"])
    if "output_conv2_0" in p:                 # not in feature_only mode
        w.conv(sp + "output_conv2.0", p["output_conv2_0"])
        w.conv(sp + "output_conv2.2", p["output_conv2_2"])


def _mha(w: _Writer, p: Mapping, pre: str) -> None:
    """Split q/k/v (in, out) kernels -> ``nn.MultiheadAttention``'s packed
    ``in_proj_weight`` (3E, E) and ``in_proj_bias``, and ``out_proj``."""
    w.put(pre + "in_proj_weight", np.concatenate(
        [np.asarray(p[n]["kernel"], np.float32).T for n in "qkv"]))
    w.put(pre + "in_proj_bias", np.concatenate(
        [np.asarray(p[n]["bias"], np.float32) for n in "qkv"]))
    w.linear(pre + "out_proj", p["out"])


def _track_block(w: _Writer, p: Mapping, pre: str, attn: str) -> None:
    w.norm(pre + "norm1", p["norm1"])
    if "norm_context" in p:
        w.norm(pre + "norm_context", p["norm_context"])
    w.norm(pre + "norm2", p["norm2"])
    _mha(w, p["attn"], f"{pre}{attn}.")
    w.linear(pre + "mlp.fc1", p["mlp"]["fc1"])
    w.linear(pre + "mlp.fc2", p["mlp"]["fc2"])


def _tracker(w: _Writer, p: Mapping, pre: str) -> None:
    w.linear(pre + "corr_mlp.fc1", p["corr_mlp"]["fc1"])
    w.linear(pre + "corr_mlp.fc2", p["corr_mlp"]["fc2"])
    w.put(pre + "query_ref_token", p["query_ref_token"])
    uf, up = p["updateformer"], pre + "updateformer."
    w.norm(up + "input_norm", uf["input_norm"])
    w.linear(up + "input_transform", uf["input_transform"])
    w.norm(up + "output_norm", uf["output_norm"])
    w.linear(up + "flow_head", uf["flow_head"])
    w.put(up + "virual_tracks", uf["virtual_tracks"])          # sic
    for kind, attn in (("time_blocks", "attn"),
                       ("space_virtual_blocks", "attn"),
                       ("space_point2virtual_blocks", "cross_attn"),
                       ("space_virtual2point_blocks", "cross_attn")):
        for i, blk in enumerate(uf[kind]):
            _track_block(w, blk, f"{up}{kind}.{i}.", attn)
    w.norm(pre + "fmap_norm", p["fmap_norm"])
    w.norm(pre + "ffeat_norm", p["ffeat_norm"])
    w.linear(pre + "ffeat_updater.0", p["ffeat_updater"])
    w.linear(pre + "vis_predictor.0", p["vis_predictor"])
    if "conf_predictor" in p:
        w.linear(pre + "conf_predictor.0", p["conf_predictor"])


def _track_head(w: _Writer, p: Mapping, pre: str) -> None:
    _dpt(w, p["feature_extractor"], pre + "feature_extractor.")
    _tracker(w, p["tracker"], pre + "tracker.")


def _camera_head(w: _Writer, p: Mapping, pre: str) -> None:
    for i, blk in enumerate(p["trunk"]):
        _vggt_block(w, blk, f"{pre}trunk.{i}.")
    w.norm(pre + "token_norm", p["token_norm"])
    w.norm(pre + "trunk_norm", p["trunk_norm"])
    w.put(pre + "empty_pose_tokens", p["empty_pose_tokens"])
    w.linear(pre + "embed_pose", p["embed_pose"])
    w.linear(pre + "poseLN_modulation.1", p["poseLN_modulation"])
    w.conv(pre + "camera_time_upsample.expand_channels",
           p["camera_time_upsample"])
    w.linear(pre + "pose_branch.fc1", p["pose_branch"]["fc1"])
    w.linear(pre + "pose_branch.fc2", p["pose_branch"]["fc2"])


def _vggt(w: _Writer, p: Mapping, pre: str) -> None:
    w.linear(pre + "projection_head", p["projection_head"])
    w.mlp(pre + "time_embedding", p["time_embedding"])
    w.linear(pre + "time_projection.1", p["time_projection"])
    agg, ap = p["aggregator"], pre + "aggregator."
    w.put(ap + "camera_token", agg["camera_token"])
    w.put(ap + "register_token", agg["register_token"])
    for kind in ("frame_blocks", "global_blocks"):
        for i, blk in enumerate(agg[kind]):
            _vggt_block(w, blk, f"{ap}{kind}.{i}.")
    w.mlp(ap + "CamTokenProjector.mlp", agg["cam_token_projector"])
    if "camera_head" in p:
        _camera_head(w, p["camera_head"], pre + "camera_head.")
    for head in ("depth_head", "point_head"):
        if head in p:
            _dpt(w, p[head], f"{pre}{head}.")
    if "track_head" in p:
        _track_head(w, p["track_head"], pre + "track_head.")


def track_head_state_dict(params: Mapping, model: nn.Module
                          ) -> Dict[str, torch.Tensor]:
    """JAX ``init_track_head`` tree ({"feature_extractor", "tracker"}; or
    ``convert_dpt_head`` + ``convert_tracker`` of a checkpoint) -> f32
    state dict of ``TrackHead``; a ``TrackerPredictor`` ``model`` takes
    the tracker tree alone."""
    w = _Writer(_shapes(model))
    if "feature_extractor" in params:
        _track_head(w, params, "")
    else:
        _tracker(w, params, "")
    return w.sd


def _bicross(w: _Writer, p: Mapping, pre: str) -> None:
    for name in ("m1_proj", "m2_proj", "values_m1_proj", "values_m2_proj",
                 "out_m1_proj", "out_m2_proj"):
        w.linear(f"{pre}cross_attn.{name}", p[name])
    w.put(pre + "gamma_m1", p["gamma_m1"])
    w.put(pre + "gamma_m2", p["gamma_m2"])


def _shapes(module: nn.Module) -> Dict[str, torch.Size]:
    return {k: v.shape for k, v in module.state_dict().items()}


def _unstack(tree) -> List:
    """A tree of leaves stacked on a leading layer axis -> one tree per
    layer."""
    if isinstance(tree, Mapping):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = {len(v) for v in parts.values()}
        if len(n) != 1:
            raise ValueError(f"ragged stack: layer counts {sorted(n)}")
        return [{k: v[i] for k, v in parts.items()} for i in range(n.pop())]
    a = np.asarray(tree)
    return [a[i] for i in range(a.shape[0])]


def blocks_from_scan(params: Mapping, scan: Mapping) -> Dict:
    """``params`` with its per-layer block lists (DiT blocks, VGGT frame
    and global blocks, bicross) replaced by the layers of a JAX scan tree
    (``prepare_scan_params``: {"pcb": [dit stacks], "irg": [{"frame",
    "agg", "dit"[, "bicross"]}]}), such as a quantized one whose stacked
    (L, K, N) kernels carry (L, N) scales. Bicross layers of uncoupled IRG
    runs (not in the scan tree) stay ``params``'."""
    dit_blocks, frame, glob = [], [], []
    bicross = list(params["bicross"])
    for seg in scan["pcb"]:
        dit_blocks += _unstack(seg)
    for seg in scan["irg"]:
        lo = len(frame)
        dit_blocks += _unstack(seg["dit"])
        frame += _unstack(seg["frame"])
        glob += _unstack(seg["agg"])
        if "bicross" in seg:
            layers = _unstack(seg["bicross"])
            bicross[lo:lo + len(layers)] = layers
    agg = dict(params["vggt"]["aggregator"], frame_blocks=frame,
               global_blocks=glob)
    return dict(params, dit=dict(params["dit"], blocks=dit_blocks),
                vggt=dict(params["vggt"], aggregator=agg), bicross=bicross)


def fusion_state_dict(params: Mapping, model: nn.Module,
                      scan: Optional[Mapping] = None
                      ) -> Dict[str, torch.Tensor]:
    """JAX ``init_fusion`` / ``convert_fusion_checkpoint`` tree ({dit, vggt,
    bicross}) -> f32 state dict of ``FusionModel`` ``model``. Quantized
    linears (``quantize_tree``) keep their int8 / float8 bits and scales
    for a model rewritten by ``core.quant.quantize_model``. With ``scan``,
    the blocks are taken from that scan tree (``blocks_from_scan``)."""
    if scan is not None:
        params = blocks_from_scan(params, scan)
    w = _Writer(_shapes(model))
    _dit(w, params["dit"], "dit.")
    _vggt(w, params["vggt"], "vggt.")
    for i, b in enumerate(params["bicross"]):
        _bicross(w, b, f"bicross.{i}.")
    return w.sd


def pose_encoder_state_dict(params: Mapping, model: nn.Module
                            ) -> Dict[str, torch.Tensor]:
    """JAX camera pose encoder tree (``convert/camera.py:
    convert_pose_encoder``) -> f32 state dict of ``CameraPoseEncoder``."""
    w = _Writer(_shapes(model))
    e1, e2 = params["encode_first"], params["encode_second"]
    w.conv("controlnet_encode_first.0", e1["conv1"])
    w.norm("controlnet_encode_first.1", e1["norm1"])
    w.conv("controlnet_encode_first.2", e1["conv2"])
    w.norm("controlnet_encode_first.3", e1["norm2"])
    w.conv("controlnet_encode_second.0", e2["conv1"])
    w.norm("controlnet_encode_second.1", e2["norm1"])
    w.linear("patch_embedding", params["patch_embedding"])
    fc = params["fc"]
    w.linear("fc.0", fc["fc1"])
    w.norm("fc.1", fc["norm1"])
    w.linear("fc.3", fc["fc2"])
    w.norm("fc.4", fc["norm2"])
    return w.sd


def t5_state_dict(params: Mapping, model: nn.Module
                  ) -> Dict[str, torch.Tensor]:
    """JAX ``init_t5`` / ``convert_t5`` tree -> f32 state dict of
    ``T5Encoder``."""
    w = _Writer(_shapes(model))
    w.put("token_embedding.weight", params["token_embedding"])
    for i, b in enumerate(params["blocks"]):
        bp = f"blocks.{i}."
        w.norm(bp + "norm1", b["norm1"])
        for name in "qkvo":
            w.linear(f"{bp}attn.{name}", b["attn"][name])
        w.put(bp + "pos_embedding.embedding.weight", b["pos_embedding"])
        w.norm(bp + "norm2", b["norm2"])
        w.linear(bp + "ffn.gate.0", b["ffn"]["gate"])
        w.linear(bp + "ffn.fc1", b["ffn"]["fc1"])
        w.linear(bp + "ffn.fc2", b["ffn"]["fc2"])
    w.norm("norm", params["norm"])
    return w.sd


def clip_state_dict(params: Mapping, model: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """JAX ``init_clip_vision`` / ``convert_clip_vision`` tree -> f32 state
    dict of ``CLIPVision`` (the patch matmul kernel back into its conv)."""
    w = _Writer(_shapes(model))
    w.linear("patch_embedding", params["patch_embedding"])
    w.put("cls_embedding", params["cls_embedding"])
    w.put("pos_embedding", params["pos_embedding"])
    w.norm("pre_norm", params["pre_norm"])
    for i, b in enumerate(params["blocks"]):
        bp = f"transformer.{i}."
        w.norm(bp + "norm1", b["norm1"])
        w.linear(bp + "attn.to_qkv", b["attn"]["to_qkv"])
        w.linear(bp + "attn.proj", b["attn"]["proj"])
        w.norm(bp + "norm2", b["norm2"])
        w.linear(bp + "mlp.0", b["mlp"]["fc1"])
        w.linear(bp + "mlp.2", b["mlp"]["fc2"])
    return w.sd


def _vae_res(w: _Writer, p: Mapping, pre: str) -> None:
    w.put(pre + ".residual.0.gamma", p["norm1"]["gamma"])
    w.conv(pre + ".residual.2", p["conv1"])
    w.put(pre + ".residual.3.gamma", p["norm2"]["gamma"])
    w.conv(pre + ".residual.6", p["conv2"])
    if "shortcut" in p:
        w.conv(pre + ".shortcut", p["shortcut"])


def _vae_attn(w: _Writer, p: Mapping, pre: str) -> None:
    w.put(pre + ".norm.gamma", p["norm"]["gamma"])
    w.conv(pre + ".to_qkv", p["to_qkv"])
    w.conv(pre + ".proj", p["proj"])


def _vae_coder(w: _Writer, p: Mapping, pre: str, plan) -> None:
    w.conv(pre + "conv1", p["conv1"])
    seq = "downsamples" if pre == "encoder." else "upsamples"
    for i, ((kind, _), q) in enumerate(zip(plan, p[seq])):
        name = f"{pre}{seq}.{i}"
        if kind == "res":
            _vae_res(w, q, name)
        elif kind == "attn":
            _vae_attn(w, q, name)
        else:
            w.conv(name + ".resample.1", q["resample_conv"])
            if "time_conv" in q:
                w.conv(name + ".time_conv", q["time_conv"])
    _vae_res(w, p["middle_res1"], pre + "middle.0")
    _vae_attn(w, p["middle_attn"], pre + "middle.1")
    _vae_res(w, p["middle_res2"], pre + "middle.2")
    w.put(pre + "head.0.gamma", p["head_norm"]["gamma"])
    w.conv(pre + "head.2", p["head_conv"])


def vae_state_dict(params: Mapping, model: nn.Module
                   ) -> Dict[str, torch.Tensor]:
    """JAX ``init_wan_vae`` / ``convert_wan_vae`` tree -> f32 state dict of
    ``WanVAE`` (the JAX tree keeps torch's conv layout)."""
    cfg: VAEConfig = model.cfg
    w = _Writer(_shapes(model))
    _vae_coder(w, params["encoder"], "encoder.", encoder_downsample_plan(cfg))
    w.conv("conv1", params["conv1"])
    w.conv("conv2", params["conv2"])
    _vae_coder(w, params["decoder"], "decoder.", decoder_upsample_plan(cfg))
    return w.sd


def _vae38_macro(w: _Writer, p: Mapping, pre: str) -> None:
    for j, rb in enumerate(p["res"]):
        _vae_res(w, rb, f"{pre}.{j}")
    if "resample" in p:
        rs, name = p["resample"], f"{pre}.{len(p['res'])}"
        w.conv(name + ".resample.1", rs["resample_conv"])
        if "time_conv" in rs:
            w.conv(name + ".time_conv", rs["time_conv"])


def vae38_state_dict(params: Mapping, model: nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """JAX ``convert_wan_vae38`` tree -> f32 state dict of ``WanVAE38``."""
    w = _Writer(_shapes(model))
    for pre, seq in (("encoder.", "downsamples"), ("decoder.", "upsamples")):
        p = params[pre[:-1]]
        w.conv(pre + "conv1", p["conv1"])
        for i, stage in enumerate(p[seq]):
            _vae38_macro(w, stage, f"{pre}{seq}.{i}.{seq}")
        _vae_res(w, p["middle_res1"], pre + "middle.0")
        _vae_attn(w, p["middle_attn"], pre + "middle.1")
        _vae_res(w, p["middle_res2"], pre + "middle.2")
        w.put(pre + "head.0.gamma", p["head_norm"]["gamma"])
        w.conv(pre + "head.2", p["head_conv"])
    w.conv("conv1", params["conv1"])
    w.conv("conv2", params["conv2"])
    return w.sd


def dit_state_dict(params: Mapping, model: nn.Module
                   ) -> Dict[str, torch.Tensor]:
    """JAX ``init_wan_dit`` / ``convert_wan_dit`` tree -> f32 state dict of
    the standalone ``WanDiT`` ``model``."""
    w = _Writer(_shapes(model))
    _dit(w, params, "")
    return w.sd


def dit_scan_segments(cfg: FusionConfig) -> List[Tuple[str, int]]:
    """(JAX scan-tree prefix, first DiT block) of every segment that holds
    DiT blocks: the PCB prefix split where the camera adapters end
    (``pcb/{j}``), then the IRG runs split where the coupling or the
    adapters change (``irg/{j}/dit``) -- ``prepare_scan_params``'s
    layout."""
    si, ae = cfg.start_index, cfg.dit.camera_adapter_end
    cut = min(ae, si)
    pcb = [(0, cut), (cut, si)] if 0 < cut < si else [(0, si)]
    segs = [(f"pcb/{j}", lo) for j, (lo, _) in enumerate(pcb)]
    xa, prev, j = cfg.xattn_set(), None, -1
    for i in range(cfg.num_irg):
        key = (i in xa, cfg.dit.has_adapter(si + i))
        if key != prev:
            j += 1
            segs.append((f"irg/{j}/dit", si + i))
            prev = key
    return segs


_LORA_LAYER = {"fc1": "0", "fc2": "2"}


def lora_state_dict(lora: Mapping, model: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """JAX ``init_lora`` factors {scan path: {"down": (L, d_in, r), "up":
    (L, r, d_out)}} -> f32 tensors under the port's adapter names
    (``dit.blocks.{i}.{component}.{layer}.lora.down`` (r, d_in) and
    ``.up`` (d_out, r)), one per block of each stacked segment. Also maps a
    tree of the same structure, such as the factors' gradients."""
    segs = dict(dit_scan_segments(model.cfg))
    out: Dict[str, torch.Tensor] = {}
    for path, entry in lora.items():
        prefix, comp, layer, leaf = path.rsplit("/", 3)
        if leaf != "kernel" or prefix not in segs:
            raise KeyError(f"not a DiT LoRA path: {path}")
        down = np.asarray(entry["down"], np.float32)
        up = np.asarray(entry["up"], np.float32)
        for i in range(down.shape[0]):
            name = (f"dit.blocks.{segs[prefix] + i}.{comp}."
                    f"{_LORA_LAYER.get(layer, layer)}.lora")
            out[name + ".down"] = _arr(down[i].T)
            out[name + ".up"] = _arr(up[i].T)
    return out


def _moge_conv_stack(w: _Writer, p: Mapping, pre: str) -> None:
    for i, conv in enumerate(p["input_blocks"]):
        if conv is not None:
            w.conv(f"{pre}input_blocks.{i}", conv)
    for i, blocks in enumerate(p["res_blocks"]):
        for j, rb in enumerate(blocks):
            w.conv(f"{pre}res_blocks.{i}.{j}.layers.2", rb["conv1"])
            w.conv(f"{pre}res_blocks.{i}.{j}.layers.5", rb["conv2"])
    for i, conv in enumerate(p["output_blocks"]):
        if conv is not None:
            w.conv(f"{pre}output_blocks.{i}", conv)
    for i, r in enumerate(p["resamplers"]):
        if "deconv" in r:
            w.conv(f"{pre}resamplers.{i}.0", r["deconv"])
        w.conv(f"{pre}resamplers.{i}.1", r["conv"])


def moge_state_dict(params: Mapping, model: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """JAX ``init_moge`` / ``convert_moge`` tree -> f32 state dict of
    ``MoGe`` (the patch matmul kernel back into its conv)."""
    w = _Writer(_shapes(model))
    bb, pre = params["encoder"]["backbone"], "encoder.backbone."
    w.linear(pre + "patch_embed.proj", bb["patch_embed"])
    w.put(pre + "cls_token", bb["cls_token"])
    w.put(pre + "pos_embed", bb["pos_embed"])
    for i, blk in enumerate(bb["blocks"]):
        _vggt_block(w, blk, f"{pre}blocks.{i}.")
    w.norm(pre + "norm", bb["norm"])
    for i, conv in enumerate(params["encoder"]["output_projections"]):
        w.conv(f"encoder.output_projections.{i}", conv)
    for head in ("neck", "points_head", "mask_head", "normal_head"):
        if head in params:
            _moge_conv_stack(w, params[head], head + ".")
    for key, fc in params["scale_head"].items():
        w.linear(f"scale_head.{2 * int(key[2:])}", fc)
    return w.sd
