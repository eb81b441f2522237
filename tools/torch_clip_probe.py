#!/usr/bin/env python3
"""Measure the parts of the PyTorch port's clip that ``chip_smoke.py`` does
not take apart, on one NVIDIA GPU:

    python3 tools/torch_clip_probe.py [--json FILE]

  * onekv at CLIP's self-attention (1, 257, 16, 80): the device time of
    each kernel a call launches (``torch.profiler``, 20 calls), against
    cuDNN's SDPA on the same inputs, and the CUDA-event time of a call
    alone and of 50 calls back to back (which take the host's time per
    call when the device waits for it);
  * the full-size Wan VAE (seeded weights, bf16) alone on the card, at the
    Wan2.1 clip's 336x592 and the Wan2.2 clip's 480x832, 81 frames: the
    encode of the video and the decode of its latents, untiled and on the
    reference's (30,52)/(15,26) grid: seconds (CUDA events, after a
    warm-up run) and the peak memory above the weights, or the error of a
    pass the card refuses.

Prints the card's name and power limit first, then one line per
measurement.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_us(fn, n=20):
    """{kernel name: device microseconds per call} of ``fn`` under the
    profiler, after a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name[:72]
            out[name] = out.get(name, 0.0) + (
                ev.time_range.end - ev.time_range.start) / n
    return out


def event_ms(fn, calls=1, reps=5):
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def probe_clip_attention(device):
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((1, 257, 16, 80), generator=g,
                           device=device).bfloat16() for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def onekv():
        return fa.flash_attention(q, k, v)

    def cudnn():
        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt)
    out = {}
    for name, fn in (("onekv", onekv), ("cudnn", cudnn)):
        kernels = device_us(fn)
        out[name] = {"device_us_by_kernel": kernels,
                     "device_us": sum(kernels.values()),
                     "event_ms_one_call": event_ms(fn),
                     "event_ms_back_to_back": event_ms(fn, calls=50)}
        print(f"[clip_self] {name} device_us={out[name]['device_us']:.2f} "
              f"event_ms={out[name]['event_ms_one_call']:.4f} "
              f"back_to_back_ms={out[name]['event_ms_back_to_back']:.4f} "
              f"kernels={json.dumps({k: round(v, 2) for k, v in kernels.items()})}",
              flush=True)
    return out


def probe_vae(device):
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.wan import vae as V
    vae = build(lambda: V.WanVAE(V.VAEConfig()), device=device,
                dtype=torch.bfloat16,
                generator=torch.Generator(device=device).manual_seed(0))
    out = {}
    for geometry, (h, w) in (("336x592", (336, 592)),
                             ("480x832", (480, 832))):
        g = torch.Generator(device=device).manual_seed(1)
        video = torch.rand((1, 3, 81, h, w), generator=g, device=device
                           ).mul(2).sub(1).bfloat16()
        latents = torch.randn((1, 16, 21, h // 8, w // 8), generator=g,
                              device=device).bfloat16()
        base = torch.cuda.memory_allocated()
        runs = {
            "encode": lambda: vae.encode(video),
            "decode": lambda: vae.decode(latents),
            "encode_tiled_reference_grid": lambda: V.vae_encode_tiled(
                vae, video, *V.REFERENCE_TILE),
            "decode_tiled_reference_grid": lambda: V.vae_decode_tiled(
                vae, latents, *V.REFERENCE_TILE)}
        for name, fn in runs.items():
            key = f"{geometry}_{name}"
            try:
                with torch.no_grad():
                    fn()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    ms = event_ms(fn, reps=2)
                out[key] = {"seconds": ms / 1e3, "peak_gb_above_weights": (
                    torch.cuda.max_memory_allocated() - base) / 1e9}
            except RuntimeError as e:     # the card refuses this pass
                out[key] = {"refused": str(e).splitlines()[0][:200]}
            torch.cuda.empty_cache()
            print(f"[vae] {key} {json.dumps(out[key])}", flush=True)
        del video, latents
    return out


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_clip_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    result = {"device": smi, "clip_self": probe_clip_attention(device),
              "vae": probe_vae(device)}
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
