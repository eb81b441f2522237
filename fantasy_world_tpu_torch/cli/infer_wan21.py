"""FantasyWorld-Wan2.1 inference in PyTorch, with the reference's flags
(``cli/infer_wan21.py``): image + camera JSON + prompt -> ``video.mp4`` and
``recon_confthresh{c}.ply``.

    python -m fantasy_world_tpu_torch.cli.infer_wan21 \\
        --wan_ckpt_path DIR --model_ckpt model.pth --image_path in.png \\
        --camera_json_path cams.json --prompt "..." --output_dir out

``--wan_ckpt_path`` holds the reference layout (``convert/checkpoint.py``);
``--moge_ckpt``, a MoGe-2 checkpoint, scales the camera path by the
image's predicted depth (``--using_scale``). It runs bf16 on the card
(``--device cuda``, the default) and f32 through the kernels' plain
versions on the CPU only with ``--device cpu``; without a card and without
``--device cpu`` it exits. ``--auto_download`` fetches nothing: missing
checkpoint files end the run with their names.

The serving options: ``--quant int8|fp8`` rewrites the fusion model's large
linears after load (``core/quant.py``); ``--tea_cache_l1_thresh`` (with
``--tea_cache_model_id``'s polynomial) skips the block stack on the steps
its plan picks; ``--segment_size`` runs the denoise in segments with a
progress line after each, and ``--gen_ckpt_path`` writes the partial state
there after each segment, so that a run cut short resumes from it.
``--profile_dir D`` writes a ``torch.profiler`` Chrome trace of the
generation (conditioning, denoise, decode) to ``D/trace.json``. The flags
of options not ported yet (``--mesh_*``, ``--ulysses``) end the run with
the flag's name when set.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# flag -> the value that leaves the option off; anything else is refused
NOT_PORTED = {"mesh_data": 1, "mesh_seq": 1, "mesh_model": 1,
              "ulysses": False}


def str2bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("yes", "true", "t", "1")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FantasyWorld inference on one "
                                            "GPU (PyTorch)")
    p.add_argument("--wan_ckpt_path", type=str, required=True)
    p.add_argument("--model_ckpt", type=str, required=True)
    p.add_argument("--image_path", type=str, required=True)
    p.add_argument("--camera_json_path", type=str, required=True)
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--neg_prompt", type=str, default=(
        "Bright tones, overexposed, static, blurred details, subtitles, "
        "style, works, paintings, images, static, overall gray, worst "
        "quality, low quality, JPEG compression residue, ugly, incomplete, "
        "extra fingers, poorly drawn hands, poorly drawn faces, deformed, "
        "disfigured, misshapen limbs, fused fingers, still picture, messy "
        "background, three legs, many people in the background, walking "
        "backwards"))
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--fps", type=int, default=16)
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=1024)
    p.add_argument("--using_scale", type=str2bool, default=True)
    p.add_argument("--height", type=int, default=336)
    p.add_argument("--width", type=int, default=592)
    p.add_argument("--frames", type=int, default=81)
    p.add_argument("--conf_threshold", type=float, default=1.0)
    p.add_argument("--stride", type=int, default=4)
    p.add_argument("--tokenizer_path", type=str, default=None,
                   help="umT5 tokenizer dir (defaults to "
                        "<wan_ckpt_path>/google/umt5-xxl if present)")
    p.add_argument("--auto_download", type=str2bool, default=True,
                   help="accepted; nothing is fetched, and missing "
                        "checkpoint files end the run")
    p.add_argument("--moge_ckpt", type=str, default=None,
                   help="MoGe-2 checkpoint for the scene-scale "
                        "normalization")
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


def add_serving_args(p) -> None:
    """--quant, the per-run TeaCache and segmented-denoise flags, and
    --profile_dir."""
    p.add_argument("--quant", type=str, default=None, choices=["int8", "fp8"],
                   help="quantize the denoiser's large linears after load: "
                        "int8 w8a8 (int32-accumulated products) or fp8 "
                        "weight storage (core/quant.py)")
    p.add_argument("--tea_cache_l1_thresh", type=float, default=None,
                   help="TeaCache: skip the block stack on the steps whose "
                        "accumulated modulation drift stays under this "
                        "relative-L1 threshold (the reference suggests "
                        "0.05 at 480P)")
    from ..pipelines.tea_cache import DEFAULT_MODEL_ID
    p.add_argument("--tea_cache_model_id", type=str, default=DEFAULT_MODEL_ID,
                   help="the TeaCache polynomial's model id")
    p.add_argument("--segment_size", type=int, default=None,
                   help="run the denoise in segments of this many steps, "
                        "with a progress line after each")
    p.add_argument("--gen_ckpt_path", type=str, default=None,
                   help="write the partial denoise state here after each "
                        "segment; a run cut short resumes from it, and it "
                        "is removed at the end")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the "
                        "generation into this directory")


def progress_printer(args):
    """The ``[denoise] step done/total`` printer when --segment_size is
    set, else None."""
    if not args.segment_size:
        return None
    return lambda done, total: print(f"[denoise] step {done}/{total}",
                                     flush=True)


def serving_kwargs(args) -> dict:
    """The generate_video arguments of the per-run serving flags."""
    return {"tea_cache_l1_thresh": args.tea_cache_l1_thresh,
            "tea_cache_model_id": args.tea_cache_model_id,
            "segment_size": args.segment_size,
            "gen_ckpt_path": args.gen_ckpt_path,
            "progress_callback": progress_printer(args)}


def check_common(args, missing, not_ported=NOT_PORTED) -> None:
    """Exit (SystemExit, naming the cause) for a flag of an option that is
    not ported (``not_ported``: flag -> its off value), a missing MoGe
    checkpoint, missing checkpoint files (``missing``), and ``--device
    cuda`` without a card."""
    import torch

    for flag, off in not_ported.items():
        if getattr(args, flag) != off:
            raise SystemExit(f"--{flag}: not ported yet")
    if args.moge_ckpt is not None and not os.path.isfile(args.moge_ckpt):
        raise SystemExit(f"--moge_ckpt: no MoGe checkpoint at "
                         f"{args.moge_ckpt}")
    if missing:
        raise SystemExit("checkpoint files missing (nothing is downloaded): "
                         + ", ".join(missing))
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run f32 on "
                         "the CPU")


def check_args(args) -> None:
    from ..convert.checkpoint import missing_files
    check_common(args, missing_files(args.wan_ckpt_path, args.model_ckpt))


def run(args) -> dict:
    """The clip; returns {"frames", "prediction", "video": path written,
    "ply": path written}."""
    import torch

    from ..core.quant import count_quantized
    from ..hostops.camera import cameras_json_to_camera_list
    from ..sampler import FantasyWorldSampler, read_image
    from ..utils.observability import profile_trace

    check_args(args)
    device = torch.device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    with open(args.camera_json_path) as fh:
        cameras = cameras_json_to_camera_list(
            json.load(fh), image_size=(args.height, args.width))
    sampler = FantasyWorldSampler.from_checkpoint(
        args.wan_ckpt_path, args.model_ckpt, device=device, dtype=dtype,
        tokenizer_path=args.tokenizer_path, moge_ckpt=args.moge_ckpt,
        quant=args.quant)
    if args.quant:
        print(f"[quant] {args.quant}: "
              f"{count_quantized(sampler.pipe.fusion)} linears")
    image = read_image(args.image_path)
    t0 = time.perf_counter()
    with profile_trace(args.profile_dir):
        video, prediction = sampler.generate_video(
            prompt=args.prompt, neg_prompt=args.neg_prompt, image=image,
            camera_params=cameras, using_scale=args.using_scale,
            seed=args.seed, height=args.height, width=args.width,
            num_frames=args.frames, sample_steps=args.sample_steps,
            **serving_kwargs(args))
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
