#!/usr/bin/env python3
"""The multi-GPU path over NCCL, one rank per card, against one process.

    torchrun --standalone --nproc_per_node 4 tools/torch_mesh_check.py [--json FILE]

For a host with four cards (``chip_smoke.py``'s mesh phases run their
ranks on its one card over gloo instead). Every rank, on its own card:

  1. the reduced slice's 2-step denoise (``chip_smoke.small_mesh_denoise``)
     on 4-rank meshes -- (1, 4, 1) with Ulysses (2 heads over 4 ranks: the
     ring), (2, 1, 2), (1, 2, 2) with Ulysses, (4, 1, 1) -- each against
     the one-process run on rank 0's card within SLICE_TOL, with exact
     launches on every rank;
  2. Ulysses and the ring as direct calls at the full width's DiT self,
     bicross and VGGT global shapes (the 21 frames over 4 ranks) against
     the one-process kernel on the same inputs, timed;
  3. the full-width 2-step denoise with the heads at (1, 1, 4), all 40
     blocks, and at (1, 4, 1) with Ulysses, against the same seeded model
     run in one process on rank 0's card: seconds per step, peak GB.

Rank 0 prints one line per check, the cards' names and power limits, and a
JSON line last (also written to ``--json``); a failed check raises.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_MESHES = (((1, 4, 1), True), ((2, 1, 2), False), ((1, 2, 2), True),
                ((4, 1, 1), False))
FULL_MESHES = (((1, 1, 4), False), ((1, 4, 1), True))


def rel_l2(got, ref):
    return {k: ((got[k] - r).norm() / r.norm().clamp_min(1e-12)).item()
            for k, r in ref.items()}


def check(name, errs, launches, want, lead, out):
    """Rank 0's errors within SLICE_TOL and every rank's launches exact."""
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    ok = torch.tensor([int(launches == want)], device="cuda")
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    if not lead:
        return
    row = {"check": name, "rel_l2": errs, "launches_exact": bool(ok.item()),
           "rank0_launches": {k: v for k, v in launches.items() if v}}
    out.append(row)
    cs.say("mesh_check", **{k: json.dumps(v).replace(" ", "")
                            if isinstance(v, dict) else v
                            for k, v in row.items()})
    bad = {k: v for k, v in errs.items() if not v <= cs.SLICE_TOL}
    if bad or not ok.item():
        raise AssertionError(f"{name}: {bad or 'launch counts differ'}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from fantasy_world_tpu_torch.parallel import distributed, sharding
    if not distributed.is_multiprocess_env():
        raise SystemExit("run under torchrun, one process per card")
    distributed.initialize("cuda")
    dev = distributed.rank_device("cuda")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    lead = dist.get_rank() == 0
    if lead:
        fa.build_kernels()
    dist.barrier()
    fa.build_kernels()
    world, out, t_all = dist.get_world_size(), [], time.perf_counter()
    if lead:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        cs.say("mesh_check_backend", backend=dist.get_backend(),
               world=world, torch=torch.__version__)

    # 1. the reduced slice on every mesh of the world
    ref = None
    if lead:
        ref, _, _ = cs.small_mesh_denoise(dev, sharding.single(), False)
    fcfg, _ = cs.small_configs()
    height, width, frames = cs.SMALL_GEOMETRY
    fhw = ((frames - 1) // 4 + 1, height // 16, width // 16)
    for shape, uly in SMALL_MESHES:
        mesh = sharding.make_mesh(*shape)
        got, launches, seconds = cs.small_mesh_denoise(dev, mesh, uly)
        check(f"small_{'x'.join(map(str, shape))}{'_ulysses' * uly}",
              rel_l2(got, ref) if lead else None, launches,
              cs.mesh_launches(fcfg, fhw, shape,
                               cs.MESH_MODES["small", shape, uly],
                               cs.SMALL_STEPS, mesh.rank, 16), lead, out)

    # 2. the sequence-parallel attentions at full width
    axis = sharding.Axis(dist.group.WORLD, world, dist.get_rank())
    for row in cs.mesh_attention_calls(dev, axis, 5):
        row = dict(row, ranks=world)
        out.append(row)
        cs.say("mesh_check_attention", **{
            k: (f"{v:.3e}" if k in ("max_abs_err", "err_bound") else
                f"{v:.3f}" if isinstance(v, float) else v)
            for k, v in row.items()})
        if not row["max_abs_err"] <= row["err_bound"]:
            raise AssertionError(f"{row['shape']} {row['method']}")
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the full-width denoise
    height, width, frames = cs.MESH_GEOMETRY
    fhw = ((frames - 1) // 4 + 1, height // 16, width // 16)
    cfg = cs.mesh_fusion_config()
    if lead:
        lat, pred, steps, peak, _ = cs.mesh_denoise(dev, cfg, 1024)
        ref = {k: v.float().cpu() for k, v in cs.check_outputs(
            cfg, lat, pred, height, width, frames).items()}
        cs.say("mesh_check_one_process", step_seconds="|".join(
            f"{s:.3f}" for s in steps), peak_gb=f"{peak:.2f}")
        out.append({"check": "full_one_process", "step_seconds": steps,
                    "peak_gb": peak})
        del lat, pred
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    for shape, uly in FULL_MESHES:
        mesh = sharding.make_mesh(*shape)
        lat, pred, steps, peak, launches = cs.mesh_denoise(dev, cfg, 1024,
                                                           mesh, uly)
        stats = torch.tensor([*steps, peak], device="cuda")
        rows = [torch.empty_like(stats) for _ in range(world)]
        dist.all_gather(rows, stats)
        errs = None
        if lead:
            got = {k: v.float().cpu() for k, v in cs.check_outputs(
                cfg, lat, pred, height, width, frames).items()}
            errs = rel_l2(got, ref)
            cs.say("mesh_check_full", mesh="x".join(map(str, shape)),
                   ulysses=uly, rank_step_seconds="|".join(
                       "/".join(f"{s:.3f}" for s in r[:-1].tolist())
                       for r in rows),
                   rank_peak_gb="|".join(f"{r[-1].item():.2f}"
                                         for r in rows))
        check(f"full_{'x'.join(map(str, shape))}{'_ulysses' * uly}", errs,
              launches, cs.mesh_launches(cfg, fhw, shape,
                                         cs.MESH_MODES["full", shape, uly],
                                         cs.MESH_STEPS, mesh.rank, 512),
              lead, out)
        if lead:
            out[-1].update(rank_step_seconds=[r[:-1].tolist() for r in rows],
                           rank_peak_gb=[r[-1].item() for r in rows])
        del lat, pred
        gc.collect()
        torch.cuda.empty_cache()
    if lead:
        cs.say("mesh_check_done",
               seconds=f"{time.perf_counter() - t_all:.1f}")
        line = json.dumps({"mesh_check": out})
        print(line, flush=True)
        if args.json:
            with open(args.json, "w") as fh:
                fh.write(line + "\n")
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
