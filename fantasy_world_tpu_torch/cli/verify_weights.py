"""Check a real checkpoint end to end in one command
(``cli/verify_weights.py``).

The day the published checkpoints are on disk:

    python -m fantasy_world_tpu_torch.cli.verify_weights --variant wan21 \\
        --wan_ckpt_path ./Wan2.1-I2V-14B-480P --model_ckpt ./model.pth \\
        --report verify_report.json [--out_bundle ./wan21.bundle]

    python -m fantasy_world_tpu_torch.cli.verify_weights --variant wan22 \\
        --wan_ckpt_path ./Wan2.2-Fun-A14B-Control-Camera \\
        --model_ckpt_high ./high.pth --model_ckpt_low ./low.pth \\
        --report verify_report.json

Phases (each in the report with ok, wall_s and detail; the process exits
1 when any fails):

  load      -- the loaders' own reading (``convert/checkpoint.py:
               pipeline_state_dicts`` / ``expert_state_dict``: shards
               merged, names mapped, q/k permuted, the Reward-LoRAs merged
               at 0.55) of the files, or of a bundle (``cli/convert.py``);
  census:N  -- each fusion state dict against the architecture built on
               the meta device: missing, unexpected and mis-shaped keys;
  finite    -- every floating tensor scanned for NaN / Inf on the device;
  bundle    -- with ``--out_bundle``: save a bundle, reload, bit-compare;
  denoise   -- a real 2-step CFG denoise (random conditioning at the
               architecture's widths, 9 frames) of the modules built from
               those tensors, geometry heads on;
  heads     -- the last step's geometry: finite, depth > 0, every
               confidence >= 1, a finite pose encoding.

The architecture: ``--config_from`` (a bundle's ``configs.json``), else a
bundle's own, else the layout's ``configs.json``, else the production
config. It runs bf16 on the card (``--device cuda``, the default); ``--device
cpu`` runs f32 through the kernels' plain versions, for the tests. The
checks are functions of their own (``census``, ``finiteness``,
``denoise_check``, ``head_sanity``), which ``chip_smoke.py`` runs on a model
already on the card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Dict, Mapping, Optional

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="real-weights check")
    p.add_argument("--variant", choices=["wan21", "wan22"], default="wan21")
    p.add_argument("--wan_ckpt_path", type=str, required=True,
                   help="the reference checkpoint layout or a bundle")
    p.add_argument("--model_ckpt", type=str, default=None,
                   help="wan21 fusion checkpoint (model.pth)")
    p.add_argument("--model_ckpt_high", type=str, default=None)
    p.add_argument("--model_ckpt_low", type=str, default=None)
    p.add_argument("--config_from", type=str, default=None,
                   help="bundle whose configs.json describes the "
                        "architecture")
    p.add_argument("--out_bundle", type=str, default=None,
                   help="also save, reload and bit-compare a bundle")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--frames", type=int, default=9)
    p.add_argument("--height", type=int, default=None,
                   help="default: the variant's (336 / 480)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--quant", type=str, default=None,
                   choices=["int8", "fp8"],
                   help="check the quantized serving path instead")
    p.add_argument("--report", type=str, default="verify_report.json")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: bf16 through the hand-written kernels; cpu: "
                        "f32 through their plain versions")
    return p.parse_args(argv)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def architecture(cfg) -> Dict[str, tuple]:
    """{name: shape} of the fusion model of ``cfg``, built on the meta
    device."""
    import torch
    from ..models.fusion.model import FusionModel
    with torch.device("meta"):
        model = FusionModel(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def census(got: Mapping, want: Mapping[str, tuple]) -> dict:
    """A state dict against the architecture's {name: shape}: missing,
    unexpected and mis-shaped keys (LayerScale scales the file leaves out
    are not missing: the loader sets them to 1)."""
    from ..convert.checkpoint import UNIT_SCALES
    missing = sorted(k for k in want if k not in got
                     and not k.endswith(UNIT_SCALES))
    unexpected = sorted(k for k in got if k not in want)
    mismatched = sorted(k for k in want if k in got
                        and tuple(got[k].shape) != tuple(want[k]))
    return {"keys": len(want), "missing": missing[:20],
            "n_missing": len(missing), "unexpected": unexpected[:20],
            "n_unexpected": len(unexpected),
            "shape_mismatch": mismatched[:20],
            "n_shape_mismatch": len(mismatched),
            "ok": not (missing or unexpected or mismatched)}


def finiteness(trees: Mapping[str, Mapping], device) -> dict:
    """NaN / Inf count of every floating tensor, each moved to ``device``
    in turn; the counts stay there until one transfer at the end."""
    import torch
    names, counts, n = [], [], 0
    for tree_name, sd in trees.items():
        for k, t in sd.items():
            n += 1
            if not t.is_floating_point():
                continue
            x = t.to(device, non_blocking=True)
            names.append(f"{tree_name}/{k}")
            counts.append((~torch.isfinite(x)).sum())
    fetched = torch.stack(counts).tolist() if counts else []
    bad = {k: int(c) for k, c in zip(names, fetched) if c}
    return {"tensors": n, "scanned": len(names), "nonfinite": bad,
            "ok": not bad}


def head_sanity(pred: Mapping) -> dict:
    """The geometry of the last step: finite; depth > 0 (exp head);
    confidences >= 1 (expp1 head)."""
    checks, ok = {}, True
    for k, v in pred.items():
        a = v.float().cpu().numpy()
        c = {"shape": list(a.shape), "finite": bool(np.isfinite(a).all())}
        if k == "depth":
            c["positive"] = bool((a > 0).all())
        if k.endswith("_conf"):
            c["ge_one"] = bool((a >= 1.0 - 1e-3).all())
        checks[k] = c
        ok = ok and all(x for kk, x in c.items() if kk != "shape")
    return {"heads": checks, "ok": ok}


def digest(t) -> str:
    """sha256 of a tensor's bytes: equal digests, equal tensors."""
    import torch
    a = t.detach().contiguous().cpu()
    if a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
    return hashlib.sha256(a.numpy().tobytes()).hexdigest()


def denoise_check(den, cfg, variant: str, *, steps: int = 2,
                  frames: int = 9, height: Optional[int] = None,
                  width: Optional[int] = None, seed: int = 1):
    """A CFG denoise of ``den`` (a ``FantasyWorldPipeline`` holding the
    fusion model, or a ``DualModelDenoiser``) on random conditioning at
    ``cfg``'s widths, the heads on the last step -> (detail, prediction)."""
    import torch
    h = height or (336 if variant == "wan21" else 480)
    w = width or (592 if variant == "wan21" else 832)
    f_lat = (frames - 1) // 4 + 1
    h2, w2 = h // 8, w // 8
    d = cfg.dit
    rng = np.random.default_rng(0)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale
                                 ).astype(np.float32))
    ctx_pos = rand(1, 20, d.text_dim)
    ctx_neg = rand(1, 20, d.text_dim, scale=0.3)
    y = rand(1, d.in_dim - d.out_dim, f_lat, h2, w2)
    if variant == "wan21":
        lat, pred = den.denoise(
            ctx_pos, ctx_neg,
            rand(1, 257, d.clip_feature_dim) if d.has_image_input else None,
            y, h, w, num_frames=frames, num_inference_steps=steps,
            cfg_scale=5.0, seed=seed,
            plucker_fea=rand(1, f_lat * (h2 // 2) * (w2 // 2),
                             d.plucker_dim, scale=0.5))
    else:
        lat, pred = den.denoise(
            ctx_pos, ctx_neg, y, h, w, num_frames=frames,
            num_inference_steps=steps, cfg_scale=5.0, seed=seed,
            control_camera_latents=rand(1, 24, f_lat, h, w,
                                        scale=0.5).numpy())
    finite = bool(torch.isfinite(lat.float()).all())
    return ({"latent_shape": list(lat.shape), "latent_finite": finite,
             "latent_sha256": digest(lat), "steps": steps,
             "ok": finite and pred is not None}, pred)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _configs(args) -> Dict[str, object]:
    from ..convert.bundle import is_bundle, load_bundle_configs
    from ..convert.checkpoint import read_configs, wan22_fusion_config
    cfgs = (read_configs(args.wan_ckpt_path) if args.variant == "wan21"
            else read_configs(args.wan_ckpt_path, wan22_fusion_config()))
    src = args.config_from or (args.wan_ckpt_path
                               if is_bundle(args.wan_ckpt_path) else None)
    if src:
        got = load_bundle_configs(src)
        fusion = got.get("fusion", got.get("fusion_high"))
        if fusion is not None:
            got.update(fusion=fusion, fusion_high=fusion, fusion_low=fusion)
        cfgs.update(got)
    return cfgs


def _check_usage(args) -> None:
    import torch
    from ..convert.bundle import is_bundle
    raw = not is_bundle(args.wan_ckpt_path)
    if raw and args.variant == "wan21" and not args.model_ckpt:
        sys.exit("verify_weights: --model_ckpt is required for a raw wan21 "
                 "checkpoint layout (pass the fusion model.pth)")
    if raw and args.variant == "wan22" and not (
            args.model_ckpt_high and args.model_ckpt_low):
        sys.exit("verify_weights: --model_ckpt_high and --model_ckpt_low "
                 "are required for a raw wan22 checkpoint layout")
    if args.config_from and not is_bundle(args.config_from):
        sys.exit(f"verify_weights: --config_from {args.config_from!r} is "
                 f"not a bundle directory (one written by cli/convert.py)")
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu to run f32 on the CPU")


def run(args) -> dict:
    import torch
    from ..convert import checkpoint as ckpt

    _check_usage(args)
    report = {"variant": args.variant, "phases": [], "argv": vars(args)}

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            detail = fn()
            ok = bool(detail.pop("ok", True))
        except Exception as e:                     # noqa: BLE001
            detail, ok = {"error": f"{type(e).__name__}: {e}"[:500]}, False
        rec = {"name": name, "ok": ok,
               "wall_s": round(time.perf_counter() - t0, 3),
               "detail": detail}
        report["phases"].append(rec)
        print(f"[verify] {name}: {'OK' if ok else 'FAIL'} "
              f"({rec['wall_s']}s)", flush=True)
        return ok

    cfgs = _configs(args)
    key = "fusion" if args.variant == "wan21" else "fusion_high"
    cfg = cfgs[key]
    report["config"] = repr(cfg)[:300]
    device = torch.device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    state = {}

    def do_load():
        if args.variant == "wan21":
            trees = ckpt.pipeline_state_dicts(args.wan_ckpt_path,
                                              args.model_ckpt, cfg)
            fusions = {"fusion": trees["fusion"]}
        else:
            trees = {f"fusion_{side}": ckpt.expert_state_dict(
                args.wan_ckpt_path, high, pth, cfg)
                for side, high, pth in (
                    ("high", True, args.model_ckpt_high),
                    ("low", False, args.model_ckpt_low))}
            fusions = dict(trees)
            trees.update(ckpt.wan22_encoder_state_dicts(args.wan_ckpt_path))
        state.update(trees=trees, fusions=fusions)
        return {"components": sorted(trees),
                "tensors": sum(len(sd) for sd in trees.values()),
                "gbytes": round(sum(t.numel() * t.element_size()
                                    for sd in trees.values()
                                    for t in sd.values()) / 1e9, 3)}

    if not phase("load", do_load):
        return report
    want = architecture(cfg)
    for name, sd in state["fusions"].items():
        phase(f"census:{name}", lambda sd=sd: census(sd, want))
    phase("finite", lambda: finiteness(state["trees"], device))

    if args.out_bundle:
        def do_bundle():
            from ..convert.bundle import load_bundle, save_bundle
            trees = state["trees"]
            configs = {k: cfgs[k] for k in trees if k in cfgs}
            path = save_bundle(trees, args.out_bundle, configs=configs)
            back = load_bundle(path, sorted(trees))
            same = all(set(back[n]) == set(sd) and all(
                torch.equal(back[n][k], t) for k, t in sd.items())
                for n, sd in trees.items())
            return {"path": path, "bit_exact_reload": same, "ok": same}
        phase("bundle", do_bundle)

    state["pred"] = None

    def do_denoise():
        if args.variant == "wan21":
            den = ckpt.pipeline_from_state_dicts(
                {"fusion": state["fusions"]["fusion"]}, cfgs, device=device,
                dtype=dtype)
            if args.quant:
                den.quantize(args.quant)
        else:
            den = ckpt.place_experts(
                [(True, state["fusions"]["fusion_high"]),
                 (False, state["fusions"]["fusion_low"])], cfg,
                device=device, dtype=dtype, quant=args.quant)
        detail, state["pred"] = denoise_check(
            den, cfg, args.variant, steps=args.steps, frames=args.frames,
            height=args.height, width=args.width)
        detail["quant"] = args.quant
        return detail

    if phase("denoise", do_denoise) and state["pred"] is not None:
        phase("heads", lambda: head_sanity(state["pred"]))
    return report


def main(argv=None) -> dict:
    args = parse_args(argv)
    report = run(args)
    report["ok"] = all(p["ok"] for p in report["phases"])
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    with open(args.report, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"[verify] report written to {args.report}; "
          f"{'ALL OK' if report['ok'] else 'FAILURES PRESENT'}", flush=True)
    if not report["ok"]:
        sys.exit(1)
    return report


if __name__ == "__main__":
    main()
