"""Convert the reference checkpoint layout into a bundle once
(``cli/convert.py``).

The loaders rename, permute and (for Wan2.2) LoRA-merge the reference
files on every run; this CLI does it once and writes a bundle
(``convert/bundle.py``: one safetensors file per component in the port's
names, and a ``configs.json``) that ``--wan_ckpt_path`` of the inference,
serve and verify CLIs takes in the layout's place. It reads and writes on
the host; no card is needed.

    # Wan2.1: fusion, pose encoder, VAE, CLIP, umT5
    python -m fantasy_world_tpu_torch.cli.convert --variant wan21 \\
        --wan_ckpt_path ./models/Wan2.1-I2V-14B-480P \\
        --model_ckpt model.pth --out ./models/wan21.bundle

    # Wan2.2: the Reward-LoRAs are merged into the experts here
    python -m fantasy_world_tpu_torch.cli.convert --variant wan22 \\
        --wan_ckpt_path ./models/Wan2.2-Fun-A14B-Control-Camera \\
        --model_ckpt_high high.pth --model_ckpt_low low.pth \\
        --out ./models/wan22.bundle

    # one checkpoint file, its architecture detected by hash
    python -m fantasy_world_tpu_torch.cli.convert --file Wan2.1_VAE.pth \\
        --out dir/

``--dtype`` (bfloat16, the default, or float32) is the bundle's floating
point type.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="reference checkpoint layout -> bundle")
    p.add_argument("--variant", choices=["wan21", "wan22"], default=None)
    p.add_argument("--wan_ckpt_path", type=str, default=None)
    p.add_argument("--model_ckpt", type=str, default=None,
                   help="fusion model.pth (wan21)")
    p.add_argument("--model_ckpt_high", type=str, default=None)
    p.add_argument("--model_ckpt_low", type=str, default=None)
    p.add_argument("--file", type=str, default=None,
                   help="convert one checkpoint file by hash detection "
                        "instead of a variant's layout")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    return p.parse_args(argv)


def _selected(ctor, cfg, sd, what):
    """The tensors of ``ctor(cfg)`` (built on the meta device) out of
    ``sd``; a missing one raises."""
    import torch
    from ..convert.checkpoint import module_state_dict
    with torch.device("meta"):
        module = ctor(cfg)
    return module_state_dict(module, sd, what)


def run(args) -> str:
    """Writes the bundle; returns its path."""
    import torch
    from ..convert import checkpoint as ckpt
    from ..convert.bundle import save_bundle
    from ..models.fusion.model import FusionModel
    from ..models.wan.clip import CLIPVision
    from ..models.wan.t5 import T5Encoder
    from ..models.wan.vae import WanVAE

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.dtype]
    encoders = {"t5": T5Encoder, "clip": CLIPVision, "vae": WanVAE}

    if args.file:
        from ..convert.manager import COMPONENTS, detected_module
        from ..convert.registry import detect
        sd = ckpt.read_state_dict(args.file)
        name, overrides = detect(sd)
        cfg, ctor, port_sd = detected_module(name, overrides, sd)
        comp = COMPONENTS[name]
        path = save_bundle({comp: _selected(ctor, cfg, port_sd, name)},
                           args.out, configs={comp: cfg}, dtype=dtype)
        print(f"converted {args.file} ({name}) -> {path}")
        return path

    if args.variant == "wan21":
        if not (args.wan_ckpt_path and args.model_ckpt):
            raise SystemExit("wan21 needs --wan_ckpt_path and --model_ckpt")
        missing = ckpt.missing_files(args.wan_ckpt_path, args.model_ckpt)
        if missing:
            raise SystemExit(f"checkpoint files missing: {missing}")
        cfgs = ckpt.read_configs(args.wan_ckpt_path)
        sds = ckpt.pipeline_state_dicts(args.wan_ckpt_path, args.model_ckpt,
                                        cfgs["fusion"])
        comps = {"fusion": _selected(FusionModel, cfgs["fusion"],
                                     sds.pop("fusion"), "fusion")}
        configs = {"fusion": cfgs["fusion"]}
        if "pose" in sds:
            comps["pose"] = sds.pop("pose")
            configs["pose"] = ckpt.pose_config_from_state_dict(comps["pose"])
        for k, sd in sds.items():
            comps[k] = _selected(encoders[k], cfgs[k], sd, k)
            configs[k] = cfgs[k]
    elif args.variant == "wan22":
        if not (args.wan_ckpt_path and args.model_ckpt_high
                and args.model_ckpt_low):
            raise SystemExit("wan22 needs --wan_ckpt_path, "
                             "--model_ckpt_high and --model_ckpt_low")
        missing = ckpt.missing_files_wan22(
            args.wan_ckpt_path, args.model_ckpt_high, args.model_ckpt_low)
        if missing:
            raise SystemExit(f"checkpoint files missing: {missing}")
        cfgs = ckpt.read_configs(args.wan_ckpt_path,
                                 ckpt.wan22_fusion_config())
        cfg = cfgs["fusion_high"]
        # one expert in memory at a time: each is read, merged and written
        # in turn
        comps = {name: (
            lambda name=name, high=high, pth=pth: _selected(
                FusionModel, cfg, ckpt.expert_state_dict(
                    args.wan_ckpt_path, high, pth, cfg), name))
            for name, high, pth in (
                ("fusion_high", True, args.model_ckpt_high),
                ("fusion_low", False, args.model_ckpt_low))}
        for k, sd in ckpt.wan22_encoder_state_dicts(
                args.wan_ckpt_path).items():
            comps[k] = _selected(encoders[k], cfgs[k], sd, k)
        configs = {"fusion_high": cfg, "fusion_low": cfg, "t5": cfgs["t5"],
                   "vae": cfgs["vae"]}
    else:
        raise SystemExit("pass --variant wan21|wan22 or --file")
    path = save_bundle(comps, args.out, configs=configs, dtype=dtype)
    print(f"bundle written: {path}")
    return path


def main(argv=None) -> str:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
