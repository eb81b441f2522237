#!/usr/bin/env python3
"""What the tensor-parallel split's distance from one process is made of,
and whether ``chip_smoke.py``'s full_mesh bound tells a wrong split from a
right one, at full width on one card.

    python3 tools/torch_tp_noise.py [--json FILE]

Runs ``chip_smoke.py``'s full_mesh denoise at 1x1x2 (``FusionConfig()``,
all 40 blocks, 336x592x81, 2 steps with the heads; two ranks sharing the
card over gloo) in three variants, each against the same seeded model run
in one process on the card (relative L2 per output):

  as_is           the port as it is;
  f32_partials    the row-parallel layers (``o``, ``ffn.fc2``) sum f32
                  partial products and round once, as one process's
                  matmul does: what is left is not their bf16 rounding;
  per_shard_norm  a wrong split, the negative control: the q/k RMS norms
                  taken over each rank's 2560 channels instead of the
                  whole 5120.

Each variant's ranks first run full_mesh's q/k norm check
(``chipcheck.mesh.mesh_norm_check``): max abs error beside its bound.

The variants are applied in the spawned ranks by rebinding the helpers
``models/wan/dit.py`` calls; nothing in the package changes. Prints the
card's name and power limit, one line per variant and a JSON line last
(also written to ``--json``).
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
sys.path.insert(0, REPO)
VARIANTS = ("as_is", "f32_partials", "per_shard_norm")
SEED = 1024


def apply_variant(variant: str) -> None:
    """Rebind the tensor-parallel helpers of ``models/wan/dit.py``."""
    import torch.nn.functional as F
    from fantasy_world_tpu_torch.models.wan import dit
    from fantasy_world_tpu_torch.ops.norms import rms_norm
    from fantasy_world_tpu_torch.parallel import sharding
    from fantasy_world_tpu_torch.parallel.distributed import all_reduce_sum
    if variant == "f32_partials":
        def row_linear(x, layer, axis):
            if axis is None or axis.size == 1:
                return sharding.row_linear(x, layer, axis)
            y = all_reduce_sum(F.linear(x.float(), layer.weight.float()),
                               axis.group)
            if layer.bias is not None:
                y = y + layer.bias.float()
            return y.to(x.dtype)
        dit.row_linear = row_linear
    elif variant == "per_shard_norm":
        def sharded_rms_norm(x, weight, eps, axis):
            return rms_norm(x, sharding.local_columns(weight, axis), eps)
        dit.sharded_rms_norm = sharded_rms_norm
    elif variant != "as_is":
        raise ValueError(variant)


def _variant_rank(rank, variant):
    import torch.distributed as dist
    from fantasy_world_tpu_torch.chipcheck.common import MESH_DIR
    from fantasy_world_tpu_torch.chipcheck.jobs import rank_setup
    from fantasy_world_tpu_torch.chipcheck.mesh import (full_mesh_rank,
                                                        mesh_norm_check)
    from fantasy_world_tpu_torch.parallel import sharding
    dev = rank_setup()
    apply_variant(variant)
    axis = sharding.Axis(dist.group.WORLD, dist.get_world_size(), rank)
    err, bound = mesh_norm_check(dev, axis)
    if rank == 0:
        with open(os.path.join(MESH_DIR, "norm.json"), "w") as fh:
            json.dump({"max_abs_err": err, "err_bound": bound}, fh)
    full_mesh_rank(rank, (1, 1, 2), False, None, SEED)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from fantasy_world_tpu_torch.chipcheck.common import MESH_DIR, say
    from fantasy_world_tpu_torch.chipcheck.inputs import (MESH_GEOMETRY,
                                                          check_outputs,
                                                          mesh_fusion_config)
    from fantasy_world_tpu_torch.chipcheck.jobs import mesh_run
    from fantasy_world_tpu_torch.chipcheck.kernels import phase_build
    from fantasy_world_tpu_torch.chipcheck.mesh import mesh_denoise
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    phase_build()
    dev = torch.device("cuda", 0)
    cfg = mesh_fusion_config()
    lat, pred, steps, peak, _ = mesh_denoise(dev, cfg, SEED)
    ref = {k: v.float().cpu() for k, v in check_outputs(
        cfg, lat, pred, *MESH_GEOMETRY).items()}
    del lat, pred
    gc.collect()
    torch.cuda.empty_cache()
    say("tp_noise_one_process",
        step_seconds="|".join(f"{s:.3f}" for s in steps),
        peak_gb=f"{peak:.2f}")
    rows = []
    for variant in VARIANTS:
        t0 = time.perf_counter()
        records = mesh_run(_variant_rank, 2, variant)
        got = torch.load(os.path.join(MESH_DIR, "outputs.pt"))
        with open(os.path.join(MESH_DIR, "norm.json")) as fh:
            norm = json.load(fh)
        errs = {k: ((got[k] - r).norm() / r.norm().clamp_min(1e-12)).item()
                for k, r in ref.items()}
        row = {"variant": variant, "rel_l2": errs,
               "norm_max_abs_err": norm["max_abs_err"],
               "norm_err_bound": norm["err_bound"],
               "rank_step_seconds": [r["steps"] for r in records],
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        say("tp_noise", variant=variant,
            norm_max_abs_err=f"{norm['max_abs_err']:.3e}",
            norm_err_bound=f"{norm['err_bound']:.3e}",
            rel_l2=json.dumps({k: float(f"{v:.3e}")
                               for k, v in errs.items()}).replace(" ", ""),
            seconds=f"{row['seconds']:.1f}")
    say("tp_noise_done", seconds=f"{time.perf_counter() - t_all:.1f}")
    line = json.dumps({"tp_noise": rows})
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
