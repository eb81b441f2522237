"""FantasyWorld-Wan2.2-Fun-A14B-Control-Camera inference in PyTorch, with
the reference's flags (``cli/infer_wan22.py``): image + camera JSON +
prompt -> ``video.mp4`` and ``recon_confthresh{c}.ply``.

    python -m fantasy_world_tpu_torch.cli.infer_wan22 \\
        --wan_ckpt_path DIR --model_ckpt_high high.pth \\
        --model_ckpt_low low.pth --image_path in.png \\
        --camera_json_path cams.json --prompt "..." --output_dir out

``--wan_ckpt_path`` holds the Wan2.2 layout (``convert/checkpoint.py:
load_wan22``): the two experts, their Reward-LoRAs (merged at 0.55), the
VAE and umT5. ``--moge_ckpt`` scales the camera path by MoGe's depth of the
image. It runs bf16 on the card (``--device cuda``, the default; the
inactive expert waits in pinned host memory) and f32 on the CPU only with
``--device cpu``; without a card and without ``--device cpu`` it exits.
``--auto_download`` fetches nothing. ``--quant``, ``--tea_cache_l1_thresh``
(the dual-expert plan), ``--segment_size`` (no segment spans the expert
boundary) and ``--gen_ckpt_path`` work as in ``cli/infer_wan21.py``; both
experts are quantized the same way, each on the card, before the low one
is pinned in host memory. ``--profile_dir`` writes a ``torch.profiler``
trace of the generation, as in ``cli/infer_wan21.py``. The flags of
options not ported yet (``--mesh_*``, ``--ulysses``) end the run with the
flag's name when set.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .infer_wan21 import (add_serving_args, check_common, serving_kwargs,
                          str2bool)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FantasyWorld Wan2.2 inference "
                                            "on one GPU (PyTorch)")
    p.add_argument("--image_path", type=str,
                   default="examples/images/input_image.png")
    p.add_argument("--end_image_path", type=str, default="")
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--neg_prompt", type=str, default="")
    p.add_argument("--camera_json_path", type=str, required=True)
    p.add_argument("--conf_threshold", type=float, default=1.5)
    p.add_argument("--wan_ckpt_path", type=str, required=True)
    p.add_argument("--model_ckpt_high", type=str, required=True)
    p.add_argument("--model_ckpt_low", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--fps", type=int, default=16)
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--using_scale", type=str2bool, default=True)
    p.add_argument("--timestep_boundary", type=int, default=900)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--stride", type=int, default=4)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--moge_ckpt", type=str, default=None,
                   help="MoGe-2 checkpoint for the scene-scale "
                        "normalization")
    p.add_argument("--auto_download", type=str2bool, default=True,
                   help="accepted; nothing is fetched, and missing "
                        "checkpoint files end the run")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: bf16 through the hand-written kernels; cpu: "
                        "f32 through their plain versions")
    add_serving_args(p)
    g = p.add_argument_group("not ported yet (setting one exits)")
    g.add_argument("--mesh_data", type=int, default=1)
    g.add_argument("--mesh_seq", type=int, default=1)
    g.add_argument("--mesh_model", type=int, default=1)
    g.add_argument("--ulysses", type=str2bool, default=False)
    return p.parse_args(argv)


def check_args(args) -> None:
    from ..convert.checkpoint import missing_files_wan22
    check_common(args, missing_files_wan22(
        args.wan_ckpt_path, args.model_ckpt_high, args.model_ckpt_low))


def run(args) -> dict:
    """The clip; returns {"frames", "prediction", "video": path written,
    "ply": path written}."""
    import torch

    from ..hostops.camera import cameras_json_to_camera_list
    from ..sampler import Wan22Sampler, read_image
    from ..utils.observability import profile_trace

    check_args(args)
    device = torch.device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    with open(args.camera_json_path) as fh:
        cameras = cameras_json_to_camera_list(
            json.load(fh), image_size=(args.height, args.width))
    sampler = Wan22Sampler.from_checkpoint(
        args.wan_ckpt_path, args.model_ckpt_high, args.model_ckpt_low,
        device=device, dtype=dtype, tokenizer_path=args.tokenizer_path,
        moge_ckpt=args.moge_ckpt, timestep_boundary=args.timestep_boundary,
        quant=args.quant)
    image = read_image(args.image_path)
    end_image = (read_image(args.end_image_path) if args.end_image_path
                 else None)
    t0 = time.perf_counter()
    with profile_trace(args.profile_dir):
        video, prediction = sampler.generate_video(
            prompt=args.prompt, neg_prompt=args.neg_prompt, image=image,
            end_image=end_image, camera_params=cameras,
            using_scale=args.using_scale, seed=args.seed,
            height=args.height, width=args.width,
            sample_steps=args.sample_steps, **serving_kwargs(args))
    dt = time.perf_counter() - t0
    print(f"[timing] generate {args.sample_steps} steps + decode: {dt:.1f}s "
          f"({dt / args.sample_steps:.2f} s/step) on {args.device}")
    paths = sampler.export(video, prediction, args.output_dir, fps=args.fps,
                           conf_threshold=args.conf_threshold,
                           stride=args.stride)
    print(f"outputs written to {args.output_dir}")
    return {"frames": video, "prediction": prediction, **paths}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
