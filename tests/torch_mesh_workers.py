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
    from fantasy_world_tpu_torch.parallel import distributed, sharding  # noqa
    from fantasy_world_tpu_torch.parallel import ring, ulysses  # noqa: F401
    t = distributed.all_reduce_sum(torch.ones(1), dist.group.WORLD)
    assert t.item() == dist.get_world_size()
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
