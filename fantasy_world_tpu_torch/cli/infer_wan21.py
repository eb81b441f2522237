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
``--device cpu`` it exits. ``--wan_ckpt_path`` is resolved on the local
disk (``convert/downloader.py:resolve_ckpt_dir``): the directory itself
when it holds the layout or a bundle (``cli/convert.py``), else the
preset's directory beside it. No hub is called: missing checkpoint files
end the run with their names and the preset's, and ``--auto_download`` is
accepted for the JAX CLI's sake and has no effect.

The serving options: ``--quant int8|fp8`` rewrites the fusion model's large
linears after load (``core/quant.py``); ``--tea_cache_l1_thresh`` (with
``--tea_cache_model_id``'s polynomial) skips the block stack on the steps
its plan picks; ``--segment_size`` runs the denoise in segments with a
progress line after each, and ``--gen_ckpt_path`` writes the partial state
there after each segment, so that a run cut short resumes from it.
``--profile_dir D`` writes a ``torch.profiler`` Chrome trace of the
generation (conditioning, denoise, decode) to ``D/trace.json``.

Multi-GPU: ``--mesh_data D --mesh_seq S --mesh_model M [--ulysses true]``
under torchrun, one process per rank (NCCL, one card each; gloo with
``--device cpu``)::

    torchrun --nproc_per_node 4 -m fantasy_world_tpu_torch.cli.infer_wan21 \
        --mesh_seq 2 --mesh_model 2 --ulysses true ...

The CFG pair splits over D, the latent frames over S, the DiT's heads and
FFN over M (``parallel/sharding.py``); ``--ulysses`` re-shards the long
attentions over S (``parallel/ulysses.py``). Rank 0 encodes, decodes and
writes the outputs. Every serving option combines with a mesh:
``--quant`` quantizes before the split (the int8 activation scales then
span the model ranks), TeaCache takes rank 0's plan on every rank, and
rank 0 writes ``--gen_ckpt_path``. ``--ulysses`` needs ``--mesh_seq`` > 1;
without torchrun a mesh exits naming the process count it needs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

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
                   help="accepted as in the JAX CLI; no effect: nothing "
                        "is fetched, and missing checkpoint files end the "
                        "run")
    p.add_argument("--moge_ckpt", type=str, default=None,
                   help="MoGe-2 checkpoint for the scene-scale "
                        "normalization")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: bf16 through the hand-written kernels; cpu: "
                        "f32 through their plain versions")
    add_serving_args(p)
    add_mesh_args(p)
    return p.parse_args(argv)


def add_mesh_args(p) -> None:
    """The multi-GPU flags (under torchrun, one process per rank)."""
    g = p.add_argument_group("multi-GPU (under torchrun, one process per "
                             "rank)")
    g.add_argument("--mesh_data", type=int, default=1,
                   help="ranks the CFG pair (and a served batch) splits "
                        "over")
    g.add_argument("--mesh_seq", type=int, default=1,
                   help="ranks the latent frames split over")
    g.add_argument("--mesh_model", type=int, default=1,
                   help="ranks the DiT's heads and FFN split over")
    g.add_argument("--ulysses", type=str2bool, default=False,
                   help="re-shard the long attentions over the seq ranks "
                        "(all-to-all) instead of gathering their keys")


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


def serving_kwargs(args, lead: bool = True) -> dict:
    """The generate_video arguments of the per-run serving flags (the
    progress lines only where ``lead``: rank 0 of a mesh)."""
    return {"tea_cache_l1_thresh": args.tea_cache_l1_thresh,
            "tea_cache_model_id": args.tea_cache_model_id,
            "segment_size": args.segment_size,
            "gen_ckpt_path": args.gen_ckpt_path,
            "progress_callback": progress_printer(args) if lead else None}


def check_common(args, missing) -> None:
    """Exit (SystemExit, naming the cause) for a missing MoGe checkpoint,
    missing checkpoint files (``missing``), and ``--device cuda`` without
    a card."""
    import torch

    if args.moge_ckpt is not None and not os.path.isfile(args.moge_ckpt):
        raise SystemExit(f"--moge_ckpt: no MoGe checkpoint at "
                         f"{args.moge_ckpt}")
    if missing:
        raise SystemExit("checkpoint files missing (nothing is downloaded): "
                         + ", ".join(missing))
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run f32 on "
                         "the CPU")


def resolve_layout(args, preset: str, attr: str = "wan_ckpt_path") -> list:
    """``args.<attr>`` through ``resolve_ckpt_dir``; [] when it resolved,
    else [why], for ``check_common``'s list of what is missing."""
    from ..convert.downloader import resolve_ckpt_dir
    try:
        setattr(args, attr, resolve_ckpt_dir(getattr(args, attr), preset))
        return []
    except FileNotFoundError as e:
        return [str(e)]


def mesh_shape(args):
    return args.mesh_data, args.mesh_seq, args.mesh_model


def check_mesh(args) -> None:
    """Exit for a mesh that cannot run: ``--ulysses`` without seq ranks,
    or a process count that is not the mesh's."""
    shape = mesh_shape(args)
    if getattr(args, "ulysses", False) and args.mesh_seq == 1:
        raise SystemExit("--ulysses: re-shards attention over the seq "
                         "ranks; give --mesh_seq > 1")
    n = shape[0] * shape[1] * shape[2]
    if n == 1:
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != n:
        first = next(f for f, v in zip(("mesh_data", "mesh_seq",
                                        "mesh_model"), shape) if v > 1)
        raise SystemExit(f"--{first}: a {shape[0]}x{shape[1]}x{shape[2]} "
                         f"mesh needs {n} processes, one per rank (multi-GPU "
                         f"runs under torchrun): launch with torchrun "
                         f"--nproc_per_node {n} (WORLD_SIZE is {world})")


def check_args(args) -> None:
    from ..convert.checkpoint import missing_files
    check_mesh(args)
    missing = resolve_layout(args, "Wan2.1-I2V-14B-480P")
    check_common(args, missing + missing_files(args.wan_ckpt_path,
                                               args.model_ckpt))


def run(args) -> dict:
    """The clip; returns {"frames", "prediction", "video": path written,
    "ply": path written} (all None on a mesh rank other than 0)."""
    import torch

    check_args(args)
    device, mesh = start_mesh(args)
    result = _generate(args, device, mesh)
    if mesh is not None:
        # not on a failure: torchrun ends the other ranks
        from ..parallel import distributed
        distributed.shutdown()
    return result


def start_mesh(args):
    """(this rank's device, its mesh, or None without one): the process
    group opened from torchrun's environment and the mesh of the flags;
    the device as ``--device`` names it in one process."""
    import torch
    device = torch.device(args.device)
    if max(mesh_shape(args)) == 1:
        return device, None
    from ..parallel import distributed, sharding
    distributed.initialize(device)
    device = distributed.rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device, sharding.make_mesh(*mesh_shape(args))


def where(args, mesh) -> str:
    """What the timing line says the run ran on."""
    return args.device if mesh is None else (
        f"{mesh.world} ranks ({'x'.join(map(str, mesh.shape))} mesh) on "
        f"{args.device}")


def _generate(args, device, mesh) -> dict:
    import torch

    from ..core.quant import count_quantized
    from ..hostops.camera import cameras_json_to_camera_list
    from ..sampler import FantasyWorldSampler, read_image
    from ..utils.observability import profile_trace

    lead = mesh is None or mesh.rank == 0
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    with open(args.camera_json_path) as fh:
        cameras = cameras_json_to_camera_list(
            json.load(fh), image_size=(args.height, args.width))
    # quantized whole, then split (JAX's order; the split of a quantized
    # model holds the bits its whole has)
    sampler = FantasyWorldSampler.from_checkpoint(
        args.wan_ckpt_path, args.model_ckpt, device=device, dtype=dtype,
        tokenizer_path=args.tokenizer_path, moge_ckpt=args.moge_ckpt,
        quant=args.quant, encoders=lead)
    if mesh is not None:
        sampler.pipe.shard(mesh)
    if args.quant:
        print(f"[quant] {args.quant}: "
              f"{count_quantized(sampler.pipe.fusion)} linears")
    image = read_image(args.image_path) if lead else None
    t0 = time.perf_counter()
    with profile_trace(args.profile_dir if lead else None):
        video, prediction = sampler.generate_video(
            prompt=args.prompt, neg_prompt=args.neg_prompt, image=image,
            camera_params=cameras, using_scale=args.using_scale,
            seed=args.seed, height=args.height, width=args.width,
            num_frames=args.frames, sample_steps=args.sample_steps,
            mesh=mesh, ulysses=args.ulysses, **serving_kwargs(args, lead))
    if not lead:
        return {"frames": None, "prediction": None, "video": None,
                "ply": None}
    dt = time.perf_counter() - t0
    print(f"[timing] generate {args.sample_steps} steps + decode: {dt:.1f}s "
          f"({dt / args.sample_steps:.2f} s/step) on {where(args, mesh)}")
    paths = sampler.export(video, prediction, args.output_dir, fps=args.fps,
                           conf_threshold=args.conf_threshold,
                           stride=args.stride)
    print(f"outputs written to {args.output_dir}")
    return {"frames": video, "prediction": prediction, **paths}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
