"""Rank functions of the port's mesh tests (``test_torch_{ulysses,ring,
multigpu}.py``), run in spawned processes by
``fantasy_world_tpu_torch.parallel.distributed.spawn``.

This module imports torch and the port only -- never JAX, never the JAX
package -- so a rank loads neither; each rank reports what it loaded. The
parent test runs the JAX side and compares.
"""
import contextlib
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


def _pipe_groups_ok(pipe, shape):
    """On a (pipe, data, seq, model) ``shape`` grid of global ranks, each
    axis group holds the ranks on that axis with this rank's other
    coordinates, in axis order (the pipe group too), and the stage mesh's
    rank is ``sharding.rank_of`` its (data, seq, model) coordinates."""
    import torch.distributed as dist
    from fantasy_world_tpu_torch.parallel.sharding import AXES, rank_of
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    coords = np.unravel_index(pipe.rank, shape)
    axes = [pipe.pipe] + [pipe.inner.axis(name) for name in AXES]
    for a, axis in enumerate(axes):
        idx = list(coords)
        idx[a] = slice(None)
        want = [int(r) for r in grid[tuple(idx)]]
        got = ([pipe.rank] if axis.group is None
               else dist.get_process_group_ranks(axis.group))
        assert got == want, (a, got, want)
        assert axis.index == coords[a]
    assert rank_of(coords[1:], shape[1:]) == pipe.inner.rank


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


# ---------------------------------------------------------------------------
# the mesh trainer (test_torch_mesh_train.py)
# ---------------------------------------------------------------------------

def collective_inputs(world, seed=5):
    """Each rank's input and upstream gradient of every differentiable
    collective at ``world`` ranks (numpy, f32), drawn from ``seed``: the
    parent test recomputes the expected gradients from the same arrays."""
    rng = np.random.default_rng(seed + world)
    sizes = [3 if r % 2 == 0 else 1 for r in range(world)]   # ragged parts

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {
        "sizes": sizes,
        "x": [draw(4, 3) for _ in range(world)],
        "g": [draw(4, 3) for _ in range(world)],
        "xs": [draw(2, s, 3) for s in sizes],
        "gs": [draw(2, sum(sizes), 3) for _ in range(world)],
        "xa": [draw(world, 2, 3) for _ in range(world)],
        "ga": [draw(world, 2, 3) for _ in range(world)],
        "xc": draw(4, 2 * world),
        "gc": [draw(4, 2) for _ in range(world)],
    }


def _collective_grads(rank, world):
    """This rank's input gradient through each collective, the loss the
    sum of its output times this rank's upstream gradient (``g[rank]``) or,
    for a backward that assumes every rank goes on alike, rank 0's."""
    import torch.distributed as dist
    from fantasy_world_tpu_torch.parallel import distributed as D
    from fantasy_world_tpu_torch.parallel import sharding
    inp = collective_inputs(world)
    group = dist.group.WORLD
    axis = sharding.Axis(group, world, rank)

    def grad_of(x, fn, g):
        x = torch.tensor(x, requires_grad=True)
        (fn(x) * torch.from_numpy(g)).sum().backward()
        return x.grad.numpy()

    same, own = inp["g"][0], inp["g"][rank]
    return {
        "sum_identity": grad_of(inp["x"][rank], lambda x: D.all_reduce_sum(
            x, group, grad="identity"), same),
        "sum_sum": grad_of(inp["x"][rank], lambda x: D.all_reduce_sum(
            x, group, grad="sum"), own),
        "gather_slice": grad_of(inp["xs"][rank], lambda x: D.all_gather_cat(
            x, group, 1, inp["sizes"], grad="slice"), inp["gs"][0]),
        "gather_reduce_scatter": grad_of(
            inp["xs"][rank], lambda x: D.all_gather_cat(
                x, group, 1, inp["sizes"], grad="reduce_scatter"),
            inp["gs"][rank]),
        "all_to_all": grad_of(inp["xa"][rank], lambda x: D.all_to_all(
            x, group), inp["ga"][rank]),
        "sum_grad": grad_of(inp["x"][rank], lambda x: D.sum_grad(x, group),
                            own),
        "local_columns": grad_of(inp["xc"], lambda x: sharding.local_columns(
            x, axis), inp["gc"][rank]),
    }


def _attention_grads(rank, case):
    """dq, dk, dv of this rank's part of ``case`` (whole q, k, v, the
    upstream gradient g, the kind and the key split) through the port's
    Ulysses or ring attention, gathered whole."""
    import torch.distributed as dist
    from fantasy_world_tpu_torch.parallel import ring, sharding, ulysses
    world = dist.get_world_size()
    axis = sharding.Axis(dist.group.WORLD, world, rank)
    q, k, v, g = (torch.from_numpy(case[x]) for x in ("q", "k", "v", "g"))
    qs = sharding.even_split(q.shape[1], axis)
    ks = sharding.even_split(k.shape[1], axis)
    if case.get("kv_sizes") is not None:
        ks = sharding.TokenSplit(axis.group, tuple(case["kv_sizes"]), rank)
    ql, kl, vl = (t.clone().requires_grad_(True)
                  for t in (qs.take(q), ks.take(k), ks.take(v)))
    if case["kind"] == "ulysses":
        o = ulysses.ulysses_attention(ql, kl, vl, q_split=qs, kv_split=ks)
    else:
        o = ring.ring_attention(ql, kl, vl, kv_split=ks)
    (o * qs.take(g)).sum().backward()
    return {"dq": qs.gather(ql.grad).numpy(),
            "dk": ks.gather(kl.grad).numpy(),
            "dv": ks.gather(vl.grad).numpy()}


def _train_case(rank, case, model_spec):
    """Two AdamW steps of the port's trainer on a mesh from the whole
    weights (and LoRA factors) of ``model_spec``: each step's loss, every
    trainable tensor's gradient and value after it, gathered whole."""
    import argparse

    from fantasy_world_tpu_torch.cli.train import _optimizer
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.parallel import sharding
    from fantasy_world_tpu_torch.training.lora import (init_lora, lora_state,
                                                       make_lora_train_step)
    from fantasy_world_tpu_torch.training.step import make_train_step
    mesh = sharding.make_mesh(*case["shape"])
    cfg = model_spec["cfg"]
    model = build(lambda: FusionModel(cfg), device="cpu",
                  dtype=torch.float32, mesh=mesh)
    model.load_state_dict(sharding.shard_state_dict(model_spec["sd"], mesh))
    lora = case["mode"] == "lora"
    if lora:
        init_lora(model, model_spec["rank"],
                  generator=torch.Generator().manual_seed(0))
        trainable = lora_state(model)
        with torch.no_grad():
            for n, p in trainable.items():
                p.copy_(sharding.part_of_whole(model_spec["lora"][n], n,
                                               model))
    else:
        trainable = dict(model.named_parameters())
    opt, sched = _optimizer(argparse.Namespace(
        **model_spec["opt"][case["mode"]]), list(trainable.values()))
    make = make_lora_train_step if lora else make_train_step
    step = make(model, opt, sched, remat=True, mesh=mesh,
                ulysses=case["ulysses"])
    out = {}
    for i, batch in enumerate(model_spec["batches"][case["batch"]]):
        out[f"loss{i}"] = float(step(dict(batch)))
        for n, p in trainable.items():
            out[f"grad{i}/{n}"] = sharding.whole_tensor(
                p.grad, n, model, mesh).clone()
            out[f"param{i}/{n}"] = sharding.whole_tensor(
                p.detach(), n, model, mesh).clone()
    return out


@contextlib.contextmanager
def counted_launches():
    """{launch key: count} of the kernels the training calls inside the
    block would launch on the card, counted on the CPU by route and head
    dim at the plain versions' calls (every training forward keeps its
    stats)."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    seen = {k: 0 for k in fa.LAUNCHES}
    forward, backward = fa._forward, fa.flash_attention_backward_part

    def count_forward(q, k, v, scale, stats):
        assert stats
        seen[fa.route(q.shape[2], q.shape[3], k.shape[1]) + "_stats"] += 1
        return forward(q, k, v, scale, stats)

    def count_backward(q, k, v, o, lse2, do, scale, delta=None):
        d = fa.kernel_dim(q.shape[2], q.shape[3], k.shape[1])
        seen[f"bwd_dq_{d}"] += 1
        seen[f"bwd_dkv_{d}"] += 1
        return backward(q, k, v, o, lse2, do, scale, delta)

    fa._forward, fa.flash_attention_backward_part = (count_forward,
                                                     count_backward)
    try:
        yield seen
    finally:
        fa._forward, fa.flash_attention_backward_part = forward, backward


def _launch_contract(rank, case):
    """The kernel launches one step of ``chip_smoke.py``'s small_mesh_train
    on this rank would make (``counted_launches``; ``case``: shape,
    Ulysses, mode and a latent geometry), and
    ``chip_smoke.mesh_train_launches``' count."""
    import chip_smoke
    from fantasy_world_tpu_torch.parallel import sharding
    shape, uly = case["shape"], case["ulysses"]
    mesh = sharding.make_mesh(*shape)
    setup = chip_smoke.small_train_setup()
    height, width, frames = case["geometry"]
    batches = chip_smoke.train_batches(setup[0].dit, height, width, frames,
                                       shape[0], seed=0)
    batch = (batches[0] if shape[0] == 1
             else chip_smoke.stack_batches(batches))
    model, trainable = chip_smoke.small_train_model(
        setup, case["mode"], "cpu", torch.float32, mesh)
    with counted_launches() as seen:
        chip_smoke.train_on(model, trainable, chip_smoke._to(batch, "cpu"),
                            mesh, uly)
    fhw = ((frames - 1) // 4 + 1, height // 16, width // 16)
    want = chip_smoke.mesh_train_launches(
        setup[0], fhw, shape, chip_smoke.MESH_MODES["small", shape, uly],
        rank, 1, 16)
    return {"seen": seen, "want": want}


def mesh_train_cases(rank, spec_file, out_file):
    """The cases of ``spec_file`` (a ``torch.save``d dict) on this world:
    ``collectives`` (True: every differentiable collective's input
    gradient, each rank's), ``attention`` ({name: case} for
    ``_attention_grads``), ``train`` ({tag: case} for ``_train_case``,
    over ``model``) and ``contract`` ({tag: case} for
    ``_launch_contract``). Rank 0 writes {case/key: value} to ``out_file``."""
    import torch.distributed as dist
    spec = torch.load(spec_file, weights_only=False)
    world = dist.get_world_size()
    out = {}
    if spec.get("collectives"):
        mine = _collective_grads(rank, world)
        every = [None] * world
        dist.all_gather_object(every, mine)
        out.update({f"coll/{k}": [e[k] for e in every] for k in mine})
    for name, case in spec.get("attention", {}).items():
        out.update({f"attn/{name}/{k}": v
                    for k, v in _attention_grads(rank, case).items()})
    for tag, case in spec.get("train", {}).items():
        out.update({f"train/{tag}/{k}": v for k, v in
                    _train_case(rank, case, spec["model"]).items()})
    for tag, case in spec.get("contract", {}).items():
        every = [None] * world
        dist.all_gather_object(every, _launch_contract(rank, case))
        out[f"contract/{tag}"] = every
    out["foreign"] = foreign_modules()
    if rank == 0:
        torch.save(out, out_file)


# ---------------------------------------------------------------------------
# the pipeline-parallel trainer (test_torch_pp.py)
# ---------------------------------------------------------------------------

class ToyStage(torch.nn.Module):
    """The toy stage of JAX ``tests/test_pipeline_parallel.py``: each of its
    blocks h -> tanh(h @ k + b) * (1 + sc) + h."""

    def __init__(self, kernel, bias):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.as_tensor(kernel))
        self.bias = torch.nn.Parameter(torch.as_tensor(bias))


def toy_stage(stage, h, sc):
    for k, b in zip(stage.kernel, stage.bias):
        h = torch.tanh(h @ k + b) * (1.0 + sc) + h
    return h


def _gather_all(obj):
    import torch.distributed as dist
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, obj)
    return every


def _pp_toy(rank, case):
    """The toy stack through the port's ``pipeline_apply`` at S = world:
    the output (the last stage's; empty on the others) and each stage's
    parameter gradients of sum(out^2), computed on the last stage, every
    stage backpropagating from its result."""
    from fantasy_world_tpu_torch.parallel.pipeline import (make_pipe_mesh,
                                                           pipeline_apply,
                                                           stage_range)
    pipe = make_pipe_mesh(case["stages"])
    blocks = stage_range(case["kernel"].shape[0], pipe)
    sl = slice(blocks.start, blocks.stop)
    stage = ToyStage(case["kernel"][sl], case["bias"][sl])
    out = pipeline_apply(toy_stage, stage, torch.as_tensor(case["x"]),
                         (torch.as_tensor(case["scale"]),), pipe=pipe,
                         microbatches=case["M"])
    out.square().sum().backward()       # 0 from the others' empty output
    return {"out": out.detach().numpy(), "blocks": (sl.start, sl.stop),
            "kernel": stage.kernel.grad.numpy(),
            "bias": stage.bias.grad.numpy()}


def _pp_hop(rank, case):
    """The pipeline's forward hop (``RingShift(to="next")``) of this rank's
    x, and the mirror hop (``to="previous"``) that carries its gradient
    back: of sum(out * g[rank]) over every rank, the gradient by x is the
    next rank's g."""
    import torch.distributed as dist
    from fantasy_world_tpu_torch.parallel.distributed import RingShift
    group = dist.group.WORLD
    y = RingShift(torch.as_tensor(case["x"][rank]), group, "next").wait()
    dx = RingShift(torch.as_tensor(case["g"][rank]), group,
                   "previous").wait()
    return {"y": y.numpy(), "dx": dx.numpy()}


def _stage_model(cfg, sd, pipe):
    """This rank's ``StageDiT`` holding its part of the whole state dict
    ``sd``."""
    from fantasy_world_tpu_torch.parallel import sharding
    from fantasy_world_tpu_torch.training.pp import build_stage_dit
    model = build_stage_dit(cfg, pipe, device="cpu", dtype=torch.float32)
    own = {k: sd[k] for k in model.state_dict()}
    model.load_state_dict(sharding.shard_state_dict(own, pipe.inner))
    return model


def _pp_dit_blocks(rank, case, cfg, sd):
    """The port's ``pipeline_dit_blocks`` at S = world on the whole inputs
    (the output on the last stage)."""
    from fantasy_world_tpu_torch.ops import rope as rope_ops
    from fantasy_world_tpu_torch.parallel.pipeline import (
        make_pipe_mesh, pipeline_dit_blocks)
    pipe = make_pipe_mesh(case["stages"])
    model = _stage_model(cfg, sd, pipe)
    cos, sin = rope_ops.cos_sin_half_from_angles(
        rope_ops.build_angles_3d(cfg.head_dim, *case["grid"]), "cpu")
    with torch.no_grad():
        out = pipeline_dit_blocks(
            model.blocks, *(torch.as_tensor(case[k])
                            for k in ("x", "context", "t_mod")),
            cos, sin, pipe=pipe, microbatches=case["M"])
    return {"out": out.numpy()}


def _pp_steps(rank, case, cfg, sd, batch):
    """``case["steps"]`` steps of the port's ``make_pp_train_step`` on a
    pipe x (data, seq, model) mesh under SGD or AdamW, with Ulysses where
    ``case["ulysses"]``: each step's loss, and this rank's gradients and
    values after it, gathered whole over the model group ({name: array});
    the launches of every step (``counted_launches``)."""
    import argparse

    from fantasy_world_tpu_torch.cli.train import _optimizer
    from fantasy_world_tpu_torch.parallel import sharding
    from fantasy_world_tpu_torch.parallel.pipeline import make_pipe_mesh
    from fantasy_world_tpu_torch.training.pp import make_pp_train_step
    S, D, Sq, Mo = case["mesh"]
    pipe = make_pipe_mesh(S, data=D, seq=Sq, model=Mo)
    _pipe_groups_ok(pipe, case["mesh"])
    model = _stage_model(cfg, sd, pipe)
    params = dict(model.named_parameters())
    if case["opt"] == "sgd":
        opt, sched = torch.optim.SGD(params.values(), lr=case["lr"]), None
    else:
        opt, sched = _optimizer(argparse.Namespace(
            lr=case["lr"], warmup=1, weight_decay=0.1), params.values())
    step = make_pp_train_step(model, opt, sched, pipe=pipe,
                              microbatches=case["M"],
                              ulysses=case["ulysses"])
    out = {}
    for i in range(case["steps"]):
        with counted_launches() as seen:
            out[f"loss{i}"] = float(step(dict(batch)))
        out[f"launches{i}"] = seen
        for n, p in params.items():
            for what, t in (("grad", p.grad), ("param", p.detach())):
                out[f"{what}{i}/{n}"] = sharding.whole_tensor(
                    t, n, model, pipe.inner).clone().numpy()
    return out


def _pp_i2v(rank, case, cfg, sd, batch):
    """The i2v-conditioned ``pp_flow_match_loss`` at S = world."""
    from fantasy_world_tpu_torch.parallel.pipeline import make_pipe_mesh
    from fantasy_world_tpu_torch.training.pp import pp_flow_match_loss
    pipe = make_pipe_mesh(case["stages"])
    model = _stage_model(cfg, sd, pipe)
    with torch.no_grad():
        loss = pp_flow_match_loss(model, pipe=pipe, microbatches=case["M"],
                                  **batch)
    return {"loss": float(loss)}


def pp_cases(rank, spec_file, out_file):
    """The pipeline cases of ``spec_file`` on this world: "toy", "hop",
    "dit_blocks", "i2v", "contract", "contract_seq" (its seq ranks and
    Ulysses settings) and {tag: step case} under "steps" (each naming its
    entry of "models"); every rank's results gathered,
    rank 0 writes {case: [each rank's]} to ``out_file``."""
    spec = torch.load(spec_file, weights_only=False)
    out = {}
    if "toy" in spec:
        out["toy"] = _gather_all(_pp_toy(rank, spec["toy"]))
    if "hop" in spec:
        out["hop"] = _gather_all(_pp_hop(rank, spec["hop"]))
    if "dit_blocks" in spec:
        c = spec["dit_blocks"]
        out["dit_blocks"] = _gather_all(_pp_dit_blocks(rank, c, c["cfg"],
                                                       c["sd"]))
    if "i2v" in spec:
        c = spec["i2v"]
        out["i2v"] = _gather_all(_pp_i2v(rank, c, c["cfg"], c["sd"],
                                         c["batch"]))
    if "contract" in spec:
        out["contract"] = _gather_all(_pp_contract(rank, spec["contract"]))
    for uly in spec.get("contract_seq", {}).get("ulysses", ()):
        c = spec["contract_seq"]
        out[f"contract_seq_{uly}"] = _gather_all(_pp_contract(
            rank, c, c["seq"], uly))
    for tag, c in spec.get("steps", {}).items():
        model = spec["models"][c["model"]]
        out[tag] = _gather_all(_pp_steps(rank, c, model["cfg"], model["sd"],
                                         model["batch"]))
    out["foreign"] = foreign_modules()
    if rank == 0:
        torch.save(out, out_file)


def _pp_contract(rank, case, seq=1, ulysses=False):
    """The kernel launches one small_pipe step of ``chip_smoke.py`` makes on
    this rank (its reduced DiT at ``case["geometry"]``; on ``seq`` ranks a
    stage, small_pipe_seq's, with Ulysses under ``ulysses``), counted on
    the CPU (``counted_launches``), and ``chip_smoke.pipe_launches_of``'s
    count."""
    import chip_smoke
    from fantasy_world_tpu_torch.parallel.pipeline import make_pipe_mesh
    cfg = chip_smoke.small_pipe_config()
    geometry = case["geometry"]
    batch = chip_smoke.pipe_batch(cfg, geometry, 3, 16)
    pipe = make_pipe_mesh(chip_smoke.PIPE_STAGES, seq=seq)
    with counted_launches() as seen:
        chip_smoke.pipe_step(torch.device("cpu"), torch.float32, cfg, 3,
                             batch, pipe, ulysses=ulysses)
    want = chip_smoke.pipe_launches_of(cfg, geometry, 16, rank, seq, ulysses)
    return {"seen": seen, "want": want}
