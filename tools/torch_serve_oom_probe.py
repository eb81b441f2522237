#!/usr/bin/env python3
"""Which change runs ``chip_smoke.py``'s full_serve batch out of memory:

    python3 tools/torch_serve_oom_probe.py [--json FILE]
    python3 tools/torch_serve_oom_probe.py --variant NAME   # one, in process

Runs ``chip_smoke.py``'s phases from the full-width denoise to the served
batch of two clips -- full_slice, full_verify, [full_windowed], full_clip,
full_serve -- once per variant, each in a fresh process:

  * ``base``: as ``chip_smoke.py`` runs them (the Wan VAE's residual blocks
    out of place, full_windowed after the training steps, so not here);
  * ``vae_inplace``: the Wan VAE's residual blocks in place
    (``ResidualBlock(inplace=True)``, as the 38-block VAE runs them);
  * ``windowed_first``: full_windowed right after full_verify, before the
    clip;
  * ``both``: the two changes together;
  * ``both_expandable``: both, under
    ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` from the start;
  * ``both_server``: both, ``PYTORCH_CUDA_ALLOC_CONF`` unset, so the
    server turns expandable segments on when it is made, after the
    earlier phases (``serving/server.py:expandable_segments``), as it does
    for any caller that made it in a process already using the card.

The first four set ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:False``,
the allocator's default, so that the server leaves it as it is.

Each prints the allocator's state before full_serve (allocated, reserved,
and reserved but unallocated GB), the serve batches' seconds and peaks, or
the error that ended the run, as one JSON line; run without ``--variant``
it prints the card's name and power limit first, then one line per
variant.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFF, ON = "expandable_segments:False", "expandable_segments:True"
BOTH = ("vae_inplace", "windowed_first")
VARIANTS = {"base": ((), OFF),
            "vae_inplace": (("vae_inplace",), OFF),
            "windowed_first": (("windowed_first",), OFF),
            "both": (BOTH, OFF),
            "both_expandable": (BOTH, ON),
            "both_server": (BOTH, None)}


def allocator_state() -> dict:
    """GB allocated, reserved, and reserved but unallocated (the cached
    blocks a fragmented cache cannot hand out whole)."""
    import torch
    stats = torch.cuda.memory_stats()
    alloc = stats["allocated_bytes.all.current"] / 1e9
    reserved = stats["reserved_bytes.all.current"] / 1e9
    return {"allocated_gb": round(alloc, 2),
            "reserved_gb": round(reserved, 2),
            "unallocated_gb": round(reserved - alloc, 2),
            "inactive_split_gb": round(
                stats["inactive_split_bytes.all.current"] / 1e9, 2)}


def run_variant(name: str) -> dict:
    """The phases in process with the variant's changes; the result."""
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from fantasy_world_tpu_torch.models.wan import vae as vae_mod
    changes, _ = VARIANTS[name]
    if "vae_inplace" in changes:
        init = vae_mod.ResidualBlock.__init__

        def inplace_init(self, din, dout, inplace=False):
            init(self, din, dout, inplace=True)
        vae_mod.ResidualBlock.__init__ = inplace_init
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = {"variant": name, "changes": list(changes),
           "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}
    t0 = time.perf_counter()
    try:
        cs.phase_build()
        _, _, pipe, cond, plucker_fea = cs.phase_full_slice(device)
        cs.phase_full_verify(device, pipe)
        if "windowed_first" in changes:
            cs.phase_full_windowed(device, pipe, cond, plucker_fea)
        _, cpipe, moge = cs.phase_full_clip(device, pipe)
        out["before_serve"] = allocator_state()
        _, batches, _ = cs.phase_full_serve(device, cpipe, moge)
        out["batches"] = [{"jobs": b["jobs"], "steps": b["steps"],
                           "seconds": round(b["seconds"], 3),
                           "peak_gb": round(b["peak_gb"], 2)}
                          for b in batches]
        out["ok"] = True
    except Exception as e:                # the finding, not a crash
        out["ok"] = False
        out["error"] = " ".join(str(e).split())[:600]
        out["at_error"] = allocator_state()
    out["seconds"] = round(time.perf_counter() - t0, 1)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--variant", choices=sorted(VARIANTS), default=None,
                   help="run one variant in this process")
    p.add_argument("--variants", default=",".join(VARIANTS),
                   help="the variants to run, in order")
    p.add_argument("--json", default=None, help="write the results here")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_oom_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.variant:
        print("RESULT " + json.dumps(run_variant(args.variant)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    results = []
    for name in args.variants.split(","):
        env = {k: v for k, v in os.environ.items()
               if k != "PYTORCH_CUDA_ALLOC_CONF"}
        if VARIANTS[name][1]:
            env["PYTORCH_CUDA_ALLOC_CONF"] = VARIANTS[name][1]
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--variant", name], env=env, cwd=REPO,
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        res = (json.loads(lines[-1][len("RESULT "):]) if lines else
               {"variant": name, "ok": False, "exit": proc.returncode,
                "error": proc.stderr.strip().splitlines()[-1:]})
        res["serve_line"] = [ln for ln in proc.stdout.splitlines()
                             if ln.startswith("[full_serve]")][-1:]
        results.append(res)
        print(json.dumps(res), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"device": smi, "results": results}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
