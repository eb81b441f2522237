#!/usr/bin/env python3
"""Find the largest serve batch that fits one NVIDIA GPU, in bf16 and in
int8:

    python3 tools/torch_serve_probe.py [--json FILE] [--batches 1,2,3,4]

Builds what ``cli.serve`` holds for Wan2.1 from seeded weights on the card
(the full-width, full-depth fusion model and pose encoder, umT5-XXL, CLIP
ViT-H, the Wan VAE and MoGe-2), then for each batch of B clips runs the
denoise step that peaks -- the last, with the geometry heads, over the
CFG batch of 2B rows at 336x592, 81 frames -- and prints its seconds (CUDA
events) and peak memory, or that the card refused it. Then it quantizes
the fusion model to int8 in place and does the same. A step the card
refuses frees what it held, and the probe goes on with the next mode.

Prints the card's name and power limit first, then one line per batch.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None, help="write the results here")
    p.add_argument("--batches", default="1,2,3,4")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import (FusionConfig,
                                                             FusionModel)
    from fantasy_world_tpu_torch.models.moge.model import MoGe, MoGeConfig
    from fantasy_world_tpu_torch.models.wan.camera import (
        CameraPoseEncoder, CameraPoseEncoderConfig)
    from fantasy_world_tpu_torch.models.wan.clip import (CLIPVision,
                                                         CLIPVisionConfig)
    from fantasy_world_tpu_torch.models.wan.t5 import T5Config, T5Encoder
    from fantasy_world_tpu_torch.models.wan.vae import VAEConfig, WanVAE
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(1024)

    def make(ctor, cfg):
        return build(lambda: ctor(cfg), device=device, dtype=torch.bfloat16,
                     generator=g)
    cfg = FusionConfig()
    pipe = FantasyWorldPipeline(
        make(FusionModel, cfg),
        make(CameraPoseEncoder, CameraPoseEncoderConfig()),
        t5=make(T5Encoder, T5Config()), clip=make(CLIPVision,
                                                  CLIPVisionConfig()),
        vae=make(WanVAE, VAEConfig()))
    moge = make(MoGe, MoGeConfig())  # noqa: F841  (held, as the server does)
    height, width, frames = 336, 592, 81
    cond = cs.conditioning(cfg.dit, height, width, frames,
                           torch.Generator("cpu").manual_seed(1024), 512)
    plucker = pipe.encode_plucker(cond[4])
    results = []
    for mode in ("bf16", "int8"):
        if mode == "int8":
            pipe.quantize("int8")
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated() / 1e9
        for b in (int(x) for x in args.batches.split(",")):
            row = {"mode": mode, "clips": b, "cfg_rows": 2 * b,
                   "resident_gb": round(resident, 2)}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            try:
                start.record()
                lat, pred = pipe.denoise(
                    *(torch.cat([c] * b) for c in cond[:4]), height, width,
                    num_frames=frames, num_inference_steps=1,
                    seed=list(range(b)),
                    plucker_fea=torch.cat([plucker] * b))
                end.record()
                end.synchronize()
                row.update(fits=True,
                           heads_step_s=round(start.elapsed_time(end) / 1e3,
                                              3),
                           peak_gb=round(torch.cuda.max_memory_allocated()
                                         / 1e9, 2))
                del lat, pred
            except torch.cuda.OutOfMemoryError as e:
                row.update(fits=False, error=str(e).splitlines()[0][:160])
            gc.collect()
            torch.cuda.empty_cache()
            results.append(row)
            print("[serve_probe] " + " ".join(f"{k}={v}" for k, v in
                                               row.items()), flush=True)
            if not row["fits"]:
                break
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump({"device": smi, "results": results}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
