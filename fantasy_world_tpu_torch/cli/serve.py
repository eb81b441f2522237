"""Serve FantasyWorld generation over HTTP with batched denoising
(``cli/serve.py``).

A worker thread that owns the card drains same-shape jobs from an HTTP
queue and denoises them as one CFG-batched run
(``FantasyWorldSampler.generate_videos``, a CFG batch of 2B rows), then
exports the MP4 and the PLY of each job. ``--variant wan22`` serves the
Wan2.2-Fun-A14B-Control-Camera sampler, one job at a time.

    python -m fantasy_world_tpu_torch.cli.serve \\
        --ckpt_dir ./models/Wan2.1-I2V-14B-480P --model_ckpt model.pth \\
        --port 8000 --max_batch 2

    curl -X POST localhost:8000/v1/generate -d '{
        "prompt": "a boat sails past a lighthouse",
        "image_path": "examples/images/input_image.png",
        "camera_json": "examples/cameras/camera_data.json", "seed": 7}'
    curl localhost:8000/v1/jobs/<job_id>

It runs bf16 on the card (``--device cuda``, the default) and f32 through
the kernels' plain versions on the CPU only with ``--device cpu``; without
a card and without ``--device cpu`` it exits. The checkpoint flags are
required (``--model_ckpt``, or ``--model_ckpt_high`` and
``--model_ckpt_low``) unless ``--ckpt_dir`` is a bundle
(``cli/convert.py``); ``--ckpt_dir`` is resolved on the local disk as in
``cli/infer_wan21.py``, ``--auto_download`` has no effect, and missing
files end the run. ``--quant`` quantizes the denoiser once at start-up;
``--segment_size`` makes each batch report its progress on
``GET /v1/jobs/<id>``; a request's ``tea_cache_l1_thresh`` turns TeaCache
on for its batch.

Multi-GPU: ``--mesh_* [--ulysses]`` under torchrun, one process per rank::

    torchrun --nproc_per_node 2 -m fantasy_world_tpu_torch.cli.serve \
        --mesh_model 2 --ckpt_dir ... --port 8000 --max_batch 2

Rank 0 runs the server (HTTP, validation, the queue, batching, progress,
export); before each batch it broadcasts the batch's requests, and every
rank generates it over the mesh. The other ranks listen on no port: they
follow rank 0 (``follow``) until it stops, waiting for each batch over
a group of their own with no time limit (``distributed.control_group``),
so an idle server keeps its ranks. An interrupt of rank 0 (Ctrl-C,
SIGINT) stops the server, lets the batch in flight finish and sends the
stop, so every rank exits 0; a failure inside a batch ends the ranks, as
in ``cli/infer_wan21.py``. A request that fails validation never reaches
the other ranks.
The CUDA allocator runs on expandable segments unless
``PYTORCH_CUDA_ALLOC_CONF`` says otherwise or ranks share a card
(``serving/server.py:expandable_segments``).
The bound address is printed, so ``--port 0`` takes a free port.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import signal
import sys
import traceback

import numpy as np

from ..parallel import distributed
from .infer_wan21 import (check_common, check_mesh, resolve_layout,
                          start_mesh, str2bool, where)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FantasyWorld generation "
                                            "server on one GPU (PyTorch)")
    p.add_argument("--ckpt_dir", type=str, required=True,
                   help="the reference checkpoint layout "
                        "(convert/checkpoint.py)")
    p.add_argument("--variant", choices=["wan21", "wan22"], default="wan21",
                   help="wan21: one fusion model, same-key jobs denoised as "
                        "one CFG batch; wan22: the dual-expert "
                        "Fun-Control-Camera model, one job at a time")
    p.add_argument("--model_ckpt", type=str, default=None,
                   help="fusion model.pth (wan21; required)")
    p.add_argument("--model_ckpt_high", type=str, default=None)
    p.add_argument("--model_ckpt_low", type=str, default=None,
                   help="the experts' fusion checkpoints (wan22; required)")
    p.add_argument("--timestep_boundary", type=float, default=900.0)
    p.add_argument("--moge_ckpt", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--auto_download", type=str2bool, default=True,
                   help="accepted as in the JAX CLI; no effect: nothing "
                        "is fetched, and missing checkpoint files end the "
                        "run")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=4,
                   help="most same-key jobs in one denoise (a CFG batch of "
                        "2 x max_batch rows). The default 4 does not fit "
                        "an 80 GB card at 336x592, 81 frames: with the "
                        "encoders resident a batch of 2 clips peaks at "
                        "~72 GB and 3 run out of memory, in bf16 and in "
                        "int8 alike (PERF.md), so pass --max_batch 2 there")
    p.add_argument("--linger_s", type=float, default=2.0,
                   help="wait this long after the first queued job for "
                        "same-key jobs to fill the batch")
    p.add_argument("--output_root", type=str, default="serve_outputs")
    p.add_argument("--segment_size", type=int, default=None,
                   help="run each batch's denoise in segments of this many "
                        "steps; jobs then report their progress on "
                        "GET /v1/jobs/<id>")
    p.add_argument("--quant", type=str, default=None, choices=["int8", "fp8"],
                   help="quantize the denoiser's large linears at start-up "
                        "(core/quant.py)")
    p.add_argument("--auth_token", type=str, default=None,
                   help="require 'Authorization: Bearer <token>' on the "
                        "generate/jobs endpoints")
    p.add_argument("--io_root", type=str, default=None,
                   help="restrict request file paths (image_path, "
                        "camera_json, output_dir) to this directory -- "
                        "requests carry raw filesystem paths, so set this "
                        "(plus --auth_token) for any non-loopback --host")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: bf16 through the hand-written kernels; cpu: "
                        "f32 through their plain versions")
    g = p.add_argument_group("multi-GPU (under torchrun, one process per "
                             "rank; rank 0 serves)")
    g.add_argument("--mesh_data", type=int, default=1,
                   help="ranks a batch's CFG rows split over")
    g.add_argument("--mesh_seq", type=int, default=1,
                   help="ranks the latent frames split over")
    g.add_argument("--mesh_model", type=int, default=1,
                   help="ranks the DiT's heads and FFN split over")
    g.add_argument("--ulysses", action="store_true",
                   help="re-shard the long attentions over the seq ranks")
    return p.parse_args(argv)


def make_validate_fn(args):
    """Per-job POST-time validation: a malformed job gets a 400 instead of
    failing its whole batch at run time, and --io_root confines the paths."""

    def _inside(path):
        if args.io_root is None:
            return True
        root = os.path.realpath(args.io_root)
        rp = os.path.realpath(path)
        return rp == root or rp.startswith(root + os.sep)

    def validate(req):
        img = req.get("image_path")
        if not isinstance(img, str) or not img:
            return "'image_path' is required"
        if not _inside(img):
            return "image_path outside --io_root"
        if not os.path.isfile(img):
            return f"image_path not found: {img}"
        cam = req.get("camera_json")
        if cam is not None:
            if not isinstance(cam, str) or not _inside(cam):
                return "camera_json outside --io_root"
            if not os.path.isfile(cam):
                return f"camera_json not found: {cam}"
        out_dir = req.get("output_dir")
        if out_dir is not None:
            if not isinstance(out_dir, str):
                return "'output_dir' must be a string"
            if not _inside(out_dir):
                return "output_dir outside --io_root"
        seed = req.get("seed")
        if seed is not None and not isinstance(seed, int):
            return "'seed' must be an integer"
        for k in ("height", "width", "num_frames", "sample_steps"):
            v = req.get(k)
            if v is not None and (not isinstance(v, int) or v <= 0):
                return f"'{k}' must be a positive integer"
        return None

    return validate


def _cameras(req):
    from ..hostops.camera import cameras_json_to_camera_list
    with open(req["camera_json"]) as fh:
        return cameras_json_to_camera_list(
            json.load(fh), image_size=(req["height"], req["width"]))


def _export(sampler, args, job, req, video, pred, conf_threshold):
    out_dir = req.get("output_dir") or os.path.join(args.output_root, job.id)
    paths = sampler.export(video, pred, out_dir,
                           conf_threshold=req.get("conf_threshold",
                                                  conf_threshold),
                           stride=req.get("stride", 4))
    return {"output_dir": os.path.abspath(out_dir),
            "video": os.path.basename(paths["video"]),
            "frames": int(np.asarray(video).shape[0])}


def make_run_fn(sampler, args, mesh=None, wan22: bool = False):
    """(merged request dicts, the camera paths they name read (or None),
    ``progress(done, total, index=None)`` or None) -> one batch's clips:
    [(video, prediction)] per request on rank 0 (or in one process), [] on
    the other ranks of ``mesh``, which call it with the same requests.
    Wan2.1: one ``generate_videos`` call (a CFG batch of 2B rows); Wan2.2
    (``wan22``): one ``generate_video`` per request, its progress under
    its index."""
    kw = {}
    if mesh is not None and not mesh.trivial:
        kw = {"mesh": mesh, "ulysses": getattr(args, "ulysses", False)}

    def run21(reqs, cams, progress):
        r0 = reqs[0]
        return sampler.generate_videos(
            prompts=[r["prompt"] for r in reqs],
            image_paths=[r["image_path"] for r in reqs],
            camera_params=cams, neg_prompt=r0["neg_prompt"],
            using_scale=all(r["using_scale"] for r in reqs),
            seeds=[r["seed"] if r["seed"] is not None else 1024
                   for r in reqs],
            height=r0["height"], width=r0["width"],
            num_frames=r0["num_frames"], sample_steps=r0["sample_steps"],
            cfg_scale=r0["cfg_scale"], segment_size=args.segment_size,
            progress_callback=progress,
            tea_cache_l1_thresh=r0["tea_cache_l1_thresh"], **kw)

    def run22(reqs, cams, progress):
        out = []
        for i, req in enumerate(reqs):
            video, pred = sampler.generate_video(
                prompt=req["prompt"], neg_prompt=req["neg_prompt"],
                image_path=req["image_path"],
                camera_params=None if cams is None else cams[i],
                using_scale=req["using_scale"],
                seed=req["seed"] if req["seed"] is not None else 42,
                height=req["height"], width=req["width"],
                num_frames=req["num_frames"],
                sample_steps=req["sample_steps"],
                cfg_scale=req["cfg_scale"],
                tea_cache_l1_thresh=req["tea_cache_l1_thresh"],
                segment_size=args.segment_size,
                progress_callback=None if progress is None else
                functools.partial(progress, index=i), **kw)
            if video is not None:
                out.append((video, pred))
        return out

    return run22 if wan22 else run21


def make_batch_fn(sampler, args, mesh=None, wan22: bool = False):
    """jobs -> result dicts: the batch's requests merged with the defaults,
    their camera files read, the batch generated (``make_run_fn``), then
    one export per job.

    On a ``mesh`` this runs on rank 0, whose server owns the queue: the
    requests go to the other ranks (``follow``) first, over the control
    group (``distributed.control_group``, which waits out any idle time),
    so that every rank generates the same batch. A failure between that
    broadcast and the last collective ends this process (exit 1), as a
    failed ``cli.infer_wan21`` rank does: torchrun then ends the others,
    where a job error would leave them waiting in a collective."""
    from ..serving.server import DEFAULTS
    run = make_run_fn(sampler, args, mesh, wan22)
    meshed = mesh is not None and not mesh.trivial
    control = distributed.control_group() if meshed else None
    conf = 1.5 if wan22 else 1.0

    def batch_fn(jobs):
        reqs = [{**DEFAULTS, **j.request} for j in jobs]
        cams = None
        if any(r.get("camera_json") for r in reqs):
            if not wan22 and not all(r.get("camera_json") for r in reqs):
                raise ValueError("mixed camera/no-camera batch")
            cams = [_cameras(r) if r.get("camera_json") else None
                    for r in reqs]
        progress = None
        if args.segment_size:
            def progress(done, total, index=None):
                for j in (jobs if index is None else [jobs[index]]):
                    j.progress = {"done": done, "total": total}
        if not meshed:
            results = run(reqs, cams, progress)
        else:
            try:
                distributed.broadcast_object(reqs, group=control)
                results = run(reqs, cams, progress)
            except Exception:               # noqa: BLE001 -- ends the rank
                traceback.print_exc()
                sys.stderr.flush()
                os._exit(1)
        return [_export(sampler, args, job, req, video, pred, conf)
                for job, req, (video, pred) in zip(jobs, reqs, results)]

    return batch_fn


def follow(sampler, args, mesh) -> int:
    """A mesh rank other than 0: generate each batch that rank 0's server
    broadcasts, with the same arguments, until it broadcasts the stop
    (None), over the control group: the wait for a batch has no time
    limit, the server may idle as long as it likes. Listens on no port; an
    interrupt is left to rank 0, whose shutdown stops this loop. Returns
    how many batches it ran."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    run = make_run_fn(sampler, args, mesh, args.variant == "wan22")
    control = distributed.control_group()
    batches = 0
    while True:
        reqs = distributed.broadcast_object(None, group=control)
        if reqs is None:
            return batches
        run(reqs, None, None)
        batches += 1


def load_sampler(args, device=None, mesh=None):
    """The sampler of ``--variant`` on ``device`` (``--device`` when None),
    quantized with ``--quant`` and split over ``mesh``: the Wan2.1 model
    quantized whole, then split (JAX's order); the Wan2.2 experts built as
    this rank's parts (``place_experts``); umT5, CLIP, the VAE and MoGe on
    rank 0 only. Exits first on the checks of ``check_mesh`` and
    ``check_common``."""
    import torch
    from ..convert.bundle import is_bundle
    from ..convert.checkpoint import missing_files, missing_files_wan22
    check_mesh(args)
    resolved = resolve_layout(args, "Wan2.2-Fun-A14B-Control-Camera"
                              if args.variant == "wan22" else
                              "Wan2.1-I2V-14B-480P", attr="ckpt_dir")
    if is_bundle(args.ckpt_dir):
        need = ()
    elif args.variant == "wan22":
        need = (("--model_ckpt_high", args.model_ckpt_high),
                ("--model_ckpt_low", args.model_ckpt_low))
    else:
        need = (("--model_ckpt", args.model_ckpt),)
    for flag, val in need:
        if val is None:
            raise SystemExit(f"{flag} is required")
    missing = resolved + (
        missing_files_wan22(args.ckpt_dir, args.model_ckpt_high,
                            args.model_ckpt_low)
        if args.variant == "wan22" else
        missing_files(args.ckpt_dir, args.model_ckpt))
    check_common(args, missing)
    device = torch.device(args.device) if device is None else device
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    # rank 0 alone conditions and decodes: the other ranks load no encoders
    kw = dict(device=device, dtype=dtype, tokenizer_path=args.tokenizer_path,
              moge_ckpt=args.moge_ckpt, quant=args.quant,
              encoders=mesh is None or mesh.rank == 0)
    if args.variant == "wan22":
        from ..sampler import Wan22Sampler
        return Wan22Sampler.from_checkpoint(
            args.ckpt_dir, args.model_ckpt_high, args.model_ckpt_low,
            timestep_boundary=args.timestep_boundary, mesh=mesh, **kw)
    from ..sampler import FantasyWorldSampler
    sampler = FantasyWorldSampler.from_checkpoint(args.ckpt_dir,
                                                  args.model_ckpt, **kw)
    if mesh is not None:
        sampler.pipe.shard(mesh)
    return sampler


def main(argv=None) -> None:
    from ..serving.server import GenerationServer, expandable_segments
    args = parse_args(argv)
    # before the models take the card: every rank allocates from
    # expandable segments (unless ranks share a card)
    expandable_segments()
    check_mesh(args)
    device, mesh = start_mesh(args)
    sampler = load_sampler(args, device, mesh)
    if mesh is not None and mesh.rank != 0:
        batches = follow(sampler, args, mesh)
        print(f"[serve] rank {mesh.rank}: {batches} batches, stopped",
              flush=True)
        distributed.shutdown()
        return
    batch_fn = make_batch_fn(sampler, args, mesh, args.variant == "wan22")
    if args.host not in ("127.0.0.1", "localhost", "::1") \
            and not (args.auth_token and args.io_root):
        print("WARNING: non-loopback --host without --auth_token/--io_root: "
              "requests carry raw filesystem paths", flush=True)
    server = GenerationServer(batch_fn, host=args.host, port=args.port,
                              max_batch=args.max_batch,
                              linger_s=args.linger_s,
                              validate_fn=make_validate_fn(args),
                              auth_token=args.auth_token)
    print(f"serving on http://{args.host}:{server.port}  "
          f"(max_batch={args.max_batch}, linger={args.linger_s}s, "
          f"device={args.device}, quant={args.quant}, "
          f"{where(args, mesh)}, pid={os.getpid()})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    stop(server, mesh)
    if mesh is not None:
        print("[serve] rank 0: stopped", flush=True)
        distributed.shutdown()


def stop(server, mesh=None) -> None:
    """Shut rank 0's server down (the listen socket closed, queued jobs
    marked failed) and, on a mesh, let the batch in flight end and then
    send the other ranks the stop that ends ``follow``."""
    server.shutdown()
    if mesh is not None and not mesh.trivial:
        server.worker.join()
        distributed.broadcast_object(None, group=distributed.control_group())


if __name__ == "__main__":
    main(sys.argv[1:])
