"""Rank functions of the port's mesh tests (``test_torch_{ulysses,ring,
multigpu}.py``), run in spawned processes by
``fantasy_world_tpu_torch.parallel.distributed.spawn``.

This module imports torch and the port only -- never JAX, never the JAX
package -- so a rank loads neither; each rank reports what it loaded. The
parent test runs the JAX side and compares.
"""
import sys

import numpy as np
import torch


def foreign_modules():
    """The JAX modules and JAX-package modules this process has loaded."""
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "fantasy_world_tpu"
                  or m.startswith("fantasy_world_tpu."))


def _mesh_groups_ok(mesh):
    """Each axis group holds the ranks the JAX device grid puts on that
    axis with this rank's other coordinates."""
    import torch.distributed as dist
    from fantasy_world_tpu_torch.parallel.sharding import AXES, rank_of
    grid = np.arange(mesh.world).reshape(mesh.shape)
    coords = np.unravel_index(mesh.rank, mesh.shape)
    for a, name in enumerate(AXES):
        axis = mesh.axis(name)
        idx = list(coords)
        idx[a] = slice(None)
        want = sorted(int(r) for r in grid[tuple(idx)])
        got = ([mesh.rank] if axis.group is None
               else sorted(dist.get_process_group_ranks(axis.group)))
        assert got == want, (name, got, want)
        assert axis.index == coords[a]
    assert rank_of(coords, mesh.shape) == mesh.rank


def attention_cases(rank, case_file, out_file):
    """Each case of ``case_file`` (``{name}/{q,k,v}`` arrays and
    ``{name}/kind``): this rank's token split of q, k and v through the
    port's sequence-parallel attention of that kind, the whole output
    gathered; rank 0 writes them to ``out_file``."""
    import torch.distributed as dist
    from fantasy_world_tpu_torch.ops.attention import dot_product_attention
    from fantasy_world_tpu_torch.parallel import ring, sharding, ulysses
    world = dist.get_world_size()
    axis = sharding.Axis(dist.group.WORLD, world, rank)
    data = np.load(case_file)
    names = sorted({k.split("/")[0] for k in data.files})
    out = {}
    for name in names:
        q, k, v = (torch.from_numpy(data[f"{name}/{x}"]) for x in "qkv")
        kind = str(data[f"{name}/kind"])
        qs = sharding.even_split(q.shape[1], axis)
        ks = sharding.even_split(k.shape[1], axis)
        if f"{name}/kv_sizes" in data.files:
            ks = sharding.TokenSplit(axis.group,
                                     tuple(int(s) for s in
                                           data[f"{name}/kv_sizes"]), rank)
        ql, kl, vl = qs.take(q), ks.take(k), ks.take(v)
        if kind == "ulysses":
            o = ulysses.ulysses_attention(ql, kl, vl, q_split=qs, kv_split=ks)
        elif kind == "ring":
            o = ring.ring_attention(ql, kl, vl, kv_split=ks)
        elif kind == "dispatch":
            with ulysses.ulysses_context(object()):
                o = dot_product_attention(ql, kl, vl, q_split=qs,
                                          kv_split=ks)
                out[f"{name}/mode"] = np.asarray(ulysses.attention_mode(
                    q.shape[2], qs, ks))
        elif kind == "gather":
            o = dot_product_attention(ql, kl, vl, q_split=qs, kv_split=ks)
            out[f"{name}/mode"] = np.asarray(ulysses.attention_mode(
                q.shape[2], qs, ks))
        else:
            raise ValueError(kind)
        out[f"{name}/o"] = qs.gather(o).numpy()
    out["foreign"] = np.asarray(foreign_modules(), dtype=object)
    if rank == 0:
        np.savez(out_file, **out)


def fusion_case(rank, cfg, shape, ulysses_on, sd_file, in_file,
                out_file, steps=0):
    """The port's fusion model on a data x seq x model mesh: the state dict
    of ``sd_file`` sharded, then one ``joint_forward`` with the heads (or,
    with ``steps``, ``denoise`` of that many steps) on the inputs of
    ``in_file``; rank 0 writes the outputs to ``out_file``, every rank
    checks its process groups and what it loaded."""
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.parallel import sharding
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    mesh = sharding.make_mesh(*shape)
    _mesh_groups_ok(mesh)
    model = build(lambda: FusionModel(cfg), device="cpu",
                  dtype=torch.float32)
    model.load_state_dict(torch.load(sd_file))
    pipe = FantasyWorldPipeline(model)
    pipe.shard(mesh)
    inp = {k: torch.from_numpy(v) for k, v in np.load(in_file).items()}
    with torch.no_grad():
        if steps:
            f, h, w = (int(x) for x in inp["fhw"])
            lat, pred = pipe.denoise(
                inp["ctx_pos"], inp["ctx_neg"], inp["clip"], inp["y"],
                8 * h, 8 * w, num_frames=4 * (f - 1) + 1,
                num_inference_steps=steps, seed=7, plucker_fea=inp["pl"],
                mesh=mesh, ulysses=ulysses_on)
            out = {"latents": lat}
        else:
            noise, pred = model.joint_forward(
                inp["lat"], inp["t"], inp["ctx"], inp["clip"], inp["y"],
                plucker_fea=inp["pl"], return_prediction=True, mesh=mesh,
                ulysses=ulysses_on)
            out = {"noise": noise}
    assert (pred is None) == (rank != 0)
    assert not foreign_modules(), foreign_modules()
    if rank == 0:
        out.update({f"pred/{k}": v for k, v in pred.items()})
        np.savez(out_file, **{k: v.numpy() for k, v in out.items()})


def report_modules(rank, out_file):
    """After a collective, rank 0 writes what this rank has loaded of JAX
    and of the JAX package (one name per line) to ``out_file``."""
    import torch.distributed as dist
    from fantasy_world_tpu_torch.cli import serve  # noqa: F401
    from fantasy_world_tpu_torch.parallel import distributed, sharding  # noqa
    from fantasy_world_tpu_torch.parallel import ring, ulysses  # noqa: F401
    from fantasy_world_tpu_torch.pipelines import wan_video_22  # noqa: F401
    from fantasy_world_tpu_torch import sampler  # noqa: F401
    t = distributed.all_reduce_sum(torch.ones(1), dist.group.WORLD)
    assert t.item() == dist.get_world_size()
    t = distributed.all_reduce_max(torch.tensor([float(rank)]),
                                   dist.group.WORLD)
    assert t.item() == dist.get_world_size() - 1
    assert distributed.broadcast_object({"rank": rank}) == {"rank": 0}
    if rank == 0:
        with open(out_file, "w") as fh:
            fh.write("\n".join(foreign_modules()))


def sampler_case(rank, shape, wan, model, tok, image_path, cams, kw,
                 out_file):
    """``FantasyWorldSampler.generate_videos`` on a mesh over the
    reference layout: rank 0 writes each clip's frames and prediction, the
    others check that they got none."""
    from fantasy_world_tpu_torch.hostops.camera import load_camera_json
    from fantasy_world_tpu_torch.parallel import sharding
    from fantasy_world_tpu_torch.sampler import FantasyWorldSampler
    mesh = sharding.make_mesh(*shape)
    sampler = FantasyWorldSampler.from_checkpoint(
        wan, model, device="cpu", dtype=torch.float32, tokenizer_path=tok)
    sampler.pipe.shard(mesh)
    cams = load_camera_json(cams, (kw["height"], kw["width"]),
                            kw["num_frames"])
    clips = sampler.generate_videos(
        ["a river", "a valley"], image_paths=[image_path] * 2,
        camera_params=[cams] * 2, mesh=mesh, ulysses=True, **kw)
    assert (clips == []) == (rank != 0)
    if rank == 0:
        np.savez(out_file, **{f"{i}/video": v for i, (v, _) in
                              enumerate(clips)},
                 **{f"{i}/{k}": a for i, (_, p) in enumerate(clips)
                    for k, a in p.items()})


def norm_check_case(rank, per_shard, out_file):
    """``chip_smoke.mesh_norm_check`` over this process group at 64 tokens;
    ``per_shard``: the DiT's blocks given a norm over each rank's own
    columns (the fault the check is there to catch). Rank 0 writes (max
    abs error, bound) to ``out_file``."""
    import json

    import torch.distributed as dist
    import chip_smoke
    from fantasy_world_tpu_torch.models.wan import dit
    from fantasy_world_tpu_torch.ops.norms import rms_norm
    from fantasy_world_tpu_torch.parallel import sharding
    if per_shard:
        dit.sharded_rms_norm = lambda x, w, eps, axis: rms_norm(
            x, sharding.local_columns(w, axis), eps)
    axis = sharding.Axis(dist.group.WORLD, dist.get_world_size(), rank)
    err, bound = chip_smoke.mesh_norm_check(torch.device("cpu"), axis, 64)
    if rank == 0:
        with open(out_file, "w") as fh:
            json.dump([err, bound], fh)


def _mapped_model(cfg, sd):
    """A ``FusionModel`` whose tensors are those of ``sd`` (a state dict
    loaded with ``mmap=True``): the ranks share the file's pages instead
    of each holding a copy -- the DPT heads keep their production width,
    0.8-1.5 GB in f32. Nothing writes to them; a rank's split parts are
    its own copies."""
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    model = build(lambda: FusionModel(cfg), device="meta",
                  dtype=torch.float32)
    model.load_state_dict(sd, assign=True)
    return model


class _Cut(Exception):
    """Raised from a progress callback to cut a denoise after a segment."""


def _cut(done, total):
    raise _Cut


def serving_cases(rank, cfg, shape, ulysses_on, cases, sd_file, in_file,
                  out_file):
    """The serving options of the port's fusion model on a data x seq x
    model mesh, each case on a model loaded from ``sd_file`` afresh; rank 0
    writes every case's outputs to ``out_file`` (``{case}/{name}``):

      * ``{int8,fp8}_{qs,sq}``: the model quantized (``min_dim`` 16) then
        sharded, or sharded then quantized; one ``joint_forward``;
      * ``tea``: ``joint_forward_tea``'s compute branch from a zero
        residual, then its reuse branch with the residual it returned (the
        whole residual gathered from the ranks' parts);
      * ``tea_denoise``: the TeaCache denoise (``inputs['thresh']``, 4
        steps, the heads) in segments of 2 with a partial-state file, cut
        after the first segment and resumed from the file;
      * ``window``: the sliding-window denoise (windows of
        ``inputs['window']``, 2 steps) on the ``w_`` inputs.
    """
    import gc
    import os

    from fantasy_world_tpu_torch.core.quant import count_quantized
    from fantasy_world_tpu_torch.parallel import sharding
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    mesh = sharding.make_mesh(*shape)
    sd = torch.load(sd_file, mmap=True)
    inp = {k: torch.from_numpy(v) for k, v in np.load(in_file).items()}
    out = {}

    def pipe_of(order=(), mode=None):
        pipe = FantasyWorldPipeline(_mapped_model(cfg, sd))
        for step in order:
            if step == "q":
                pipe.quantize(mode, min_dim=16)
            else:
                pipe.shard(mesh)
        return pipe

    fwd = dict(mesh=mesh, ulysses=ulysses_on)
    for case in cases:
        # one case's model at a time
        pipe = model = None
        gc.collect()
        with torch.no_grad():
            if case.startswith(("int8", "fp8")):
                mode, order = case.split("_")
                pipe = pipe_of(order, mode)
                out[f"{case}/layers"] = torch.tensor(count_quantized(
                    pipe.fusion))
                out[f"{case}/noise"], _ = pipe.fusion.joint_forward(
                    inp["lat"], inp["t"], inp["ctx"], inp["clip"], inp["y"],
                    plucker_fea=inp["pl"], **fwd)
            elif case == "tea":
                model = pipe_of("s").fusion
                f, h, w = (int(x) for x in inp["grid"])
                B = inp["lat"].shape[0]
                part = sharding.token_split(B, (f, h, w), mesh)
                zero = sharding.take_tokens(
                    torch.zeros((B, f * h * w, cfg.dit.dim)), part)
                args = (inp["lat"], inp["t"], inp["ctx"], inp["clip"],
                        inp["y"])
                noise_c, res = model.joint_forward_tea(
                    *args, plucker_fea=inp["pl"], skip=False, residual=zero,
                    **fwd)
                noise_s, res_s = model.joint_forward_tea(
                    *args, plucker_fea=inp["pl"], skip=True, residual=res,
                    **fwd)
                assert res_s is res
                out.update({"tea/noise_compute": noise_c,
                            "tea/noise_reuse": noise_s,
                            "tea/residual": sharding.gather_tokens(res, part,
                                                                   mesh)})
            else:
                pipe = pipe_of("s")
                pre = "w_" if case == "window" else ""
                f, lh, lw = (int(x) for x in inp[pre + "fhw"])
                kw = dict(num_frames=4 * (f - 1) + 1, seed=7,
                          plucker_fea=inp[pre + "c_pl"], **fwd)
                cond = tuple(inp[pre + k] for k in ("ctx_pos", "ctx_neg",
                                                    "c_clip", "c_y")) + (
                    8 * lh, 8 * lw)
                if case == "window":
                    lat, pred = pipe.denoise(
                        *cond, num_inference_steps=2,
                        sliding_window_size=int(inp["window"][0]),
                        sliding_window_stride=int(inp["window"][1]), **kw)
                else:
                    path = os.path.join(os.path.dirname(out_file),
                                        f"partial_{'x'.join(map(str, shape))}"
                                        ".npz")
                    tea = dict(num_inference_steps=4,
                               tea_cache_l1_thresh=float(inp["thresh"]),
                               gen_ckpt_path=path, **kw)
                    try:
                        pipe.denoise(*cond, segment_size=2,
                                     progress_callback=_cut, **tea)
                        raise AssertionError("the cut run was not cut")
                    except _Cut:
                        pass
                    # rank 0 wrote it before any rank's progress ran
                    assert os.path.exists(path)
                    calls = []
                    lat, pred = pipe.denoise(
                        *cond, segment_size=1,
                        progress_callback=lambda *a: calls.append(a), **tea)
                    assert calls == [(2, 4), (3, 4), (4, 4)], calls
                    assert not os.path.exists(path)
                assert (pred is None) == (rank != 0 or case == "window")
                out[f"{case}/latents"] = lat
                for k, v in (pred or {}).items():
                    out[f"{case}/pred/{k}"] = v
    assert not foreign_modules(), foreign_modules()
    if rank == 0:
        np.savez(out_file, **{k: v.numpy() for k, v in out.items()})


def dual_case(rank, cfg, shape, ulysses_on, sd_files, in_file, out_file):
    """The port's Wan2.2 ``DualModelDenoiser`` on a mesh: both experts
    loaded from ``sd_files`` (high, low), ``shard``, then ``denoise`` with
    the inputs of ``in_file`` (its ``noise`` handed to the denoiser, as
    JAX drew it); rank 0 writes the latents, the prediction, the stages and
    every rank's control tokens' sum."""
    import torch.distributed as dist
    from fantasy_world_tpu_torch.parallel import sharding
    from fantasy_world_tpu_torch.pipelines import wan_video_22 as w22
    mesh = sharding.make_mesh(*shape)
    inp = {k: torch.from_numpy(v) for k, v in np.load(in_file).items()}
    noise = inp.pop("noise")
    w22.DualModelDenoiser.generate_noise = staticmethod(
        lambda shp, seed: noise.reshape(shp).clone())
    experts = [_mapped_model(cfg, torch.load(f, mmap=True))
               for f in sd_files]
    den = w22.DualModelDenoiser(*experts).shard(mesh)
    tokens = []
    for m in experts:
        ctrl_tok = m.dit.control_adapter_tokens
        m.dit.control_adapter_tokens = (
            lambda c, _f=ctrl_tok: tokens.append(_f(c)) or tokens[-1])
    stages, calls = [], []
    kw = {k: int(v) for k, v in zip(("height", "width", "num_frames",
                                     "num_inference_steps", "seed"),
                                    inp.pop("dims"))}
    with torch.no_grad():
        lat, pred = den.denoise(
            inp["ctx_pos"], inp["ctx_neg"], inp["y"],
            control_camera_latents=inp["ctrl"], stage_callback=stages.append,
            progress_callback=lambda *a: calls.append(a), mesh=mesh,
            ulysses=ulysses_on, **kw)
    assert (pred is None) == (rank != 0)
    assert calls == [(i, kw["num_inference_steps"])
                     for i in range(1, kw["num_inference_steps"] + 1)]
    # the control adapter runs on every rank: its tokens must agree
    sums = [None] * dist.get_world_size()
    dist.all_gather_object(sums, [float(t.double().sum()) for t in tokens])
    assert not foreign_modules(), foreign_modules()
    if rank == 0:
        out = {"latents": lat.numpy(),
               "stages": np.asarray("|".join(stages)),
               "token_sums": np.asarray(sums, np.float64)}
        out.update({f"pred/{k}": v.numpy() for k, v in pred.items()})
        np.savez(out_file, **out)


class _CollectiveStubSampler:
    """A sampler whose ``generate_videos`` meets the other ranks in an
    all-reduce over the default group (the data collectives' group) and
    returns one blank clip per prompt on rank 0."""

    def __init__(self):
        self.calls = []

    def generate_videos(self, prompts, mesh=None, **kw):
        import torch.distributed as dist
        total = torch.ones(1)
        dist.all_reduce(total)
        self.calls.append((list(prompts), int(total.item())))
        if mesh.rank != 0:
            return []
        return [(np.zeros((5, 8, 8, 3), np.uint8), {}) for _ in prompts]

    @staticmethod
    def export(video, pred, out_dir, **kw):
        import os
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "video.mp4")
        with open(path, "wb") as fh:
            fh.write(b"x")
        return {"video": path, "ply": None}


def idle_serve_case(rank, idle_s, out_root, out_file):
    """The served mesh (1x1x2) idling: rank 0 starts a ``GenerationServer``
    over ``serve.make_batch_fn``, waits ``idle_s`` with no job (longer than
    the process group's timeout), then serves one job and stops; rank 1
    follows. Rank 1 writes how many batches it ran and the collective's
    sum; rank 0 the job's status."""
    import argparse
    import json
    import time
    from fantasy_world_tpu_torch.cli import serve
    from fantasy_world_tpu_torch.parallel import sharding
    from fantasy_world_tpu_torch.serving.server import GenerationServer
    mesh = sharding.make_mesh(1, 1, 2)
    sampler = _CollectiveStubSampler()
    args = argparse.Namespace(segment_size=None, output_root=out_root,
                              ulysses=False, variant="wan21")
    if rank != 0:
        batches = serve.follow(sampler, args, mesh)
        with open(out_file, "w") as fh:
            json.dump({"batches": batches, "calls": sampler.calls}, fh)
        return
    server = GenerationServer(serve.make_batch_fn(sampler, args, mesh),
                              port=0, max_batch=1, linger_s=0.0)
    server.start()
    time.sleep(idle_s)
    job = server.submit({"prompt": "p", "image_path": "img.png"})
    deadline = time.time() + 60
    while job.status not in ("done", "error") and time.time() < deadline:
        time.sleep(0.05)
    serve.stop(server, mesh)
    assert job.status == "done", (job.status, job.error)
    assert sampler.calls == [(["p"], 2)], sampler.calls


def release_case(rank, out_file):
    """An all-reduce, ``release_shared`` (every rank meets at its barrier
    and drops its staging buffers), then another all-reduce over a group
    made after it; rank 0 saves both sums."""
    import torch.distributed as dist
    from fantasy_world_tpu_torch.parallel import distributed
    world = dist.get_world_size()
    first = distributed.all_reduce_sum(torch.full((3,), rank + 1.0), None
                                       if world == 1 else dist.group.WORLD)
    distributed.release_shared()
    assert not distributed._SHARED
    group = dist.new_group(list(range(world)))
    second = distributed.all_reduce_max(torch.full((3,), float(rank)), group)
    if rank == 0:
        torch.save({"sum": first, "max": second}, out_file)
