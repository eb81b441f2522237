#!/usr/bin/env python3
"""Time this tree's attention kernels against another tree's on one NVIDIA
GPU, in turns, in one process.

    mkdir -p archive_check/base                     # git-ignored
    git archive <commit> fantasy_world_tpu_torch/csrc | tar -x -C archive_check/base
    python3 tools/torch_kernel_ab.py --baseline archive_check/base [--json FILE]
        [--tree OTHER] [--routes onekv ...] [--denoise_steps N]

Both trees' ``fantasy_world_tpu_torch/csrc/`` are compiled with the port's
own build (``ops/flash_attention.py:build_kernels``, nvcc, sm_90a) and
every call goes through that module's wrappers, pointed at one set of
libraries or the other; the two trees must share the C entry points. On
seeded bf16 inputs it times, with CUDA events:

  * at the training shapes of ``chip_smoke.py`` (batch 1): the stats
    forward, ``fa_bwd_dq`` and ``fa_bwd_dkv``;
  * at the denoise shapes (CFG batch 2): the forward.

Each kernel runs baseline, this tree, this tree, baseline, and the line
gives all four times and the ratio of the means. It also holds this tree's
outputs to the baseline's with ``chip_smoke.py``'s bounds (out_tol,
grad_tol): both trees compute the same function. Prints the card's name and
power limit first, one line per shape, and with ``--json`` writes the
numbers to FILE. ``--tree`` times another tree in this tree's place (two
variants of a kernel against each other); ``--routes`` keeps the shapes
whose forward takes one of the given routes. ``--denoise_steps N`` then
builds ``chip_smoke.py``'s full-depth model once and times an N-step
denoise (CUDA events per step) on each tree's kernels in the same turns,
after one warm-up run on each.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--baseline", required=True, type=Path,
                   help="root of the other tree (a checkout of a commit)")
    p.add_argument("--tree", type=Path, default=REPO,
                   help="the tree timed against the baseline (default: "
                        "this one)")
    p.add_argument("--routes", nargs="+", default=None,
                   help="only the shapes whose forward takes these routes")
    p.add_argument("--denoise_steps", type=int, default=0,
                   help="also time an N-step full-depth denoise in turns")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--json", type=Path, default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from fantasy_world_tpu_torch.ops import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    def build(csrc: Path):
        fa.CSRC, fa._ENTRY_POINTS, fa._BUILD_LOG = csrc, None, ""
        libs = fa.build_kernels()
        return libs, cs.ptxas_summary(fa.build_log()) or "cached"

    own_csrc = fa.CSRC
    base, base_regs = build(args.baseline / "fantasy_world_tpu_torch" / "csrc")
    new, new_regs = build(args.tree / "fantasy_world_tpu_torch" / "csrc")
    fa.CSRC = own_csrc
    print(f"[build] baseline={base_regs} this_tree={new_regs}", flush=True)

    def on(libs, fn):
        def run():
            fa._ENTRY_POINTS = libs
            return fn()
        return run

    def turns(fn):
        """baseline, this tree, this tree, baseline: (times, ratio)."""
        ts = [cs.time_ms(on(libs, fn), args.reps)
              for libs in (base, new, new, base)]
        return ts, (ts[0] + ts[3]) / (ts[1] + ts[2])

    def err_over_bound(got, ref, tol):
        return ((got.float() - ref.float()).abs().max().item() / tol(ref))

    def kept(shapes):
        return [s for s in shapes if args.routes is None
                or s[3] in args.routes]

    g = torch.Generator(device=device).manual_seed(11)
    results = []
    for name, (B, Lq, H, D), Lk, kernel in kept(cs.TRAIN_SHAPES):
        q, k, v, do = (torch.randn((B, n, H, D), generator=g, device=device
                                   ).bfloat16() for n in (Lq, Lk, Lk, Lq))
        scale = D ** -0.5
        o, m2, l = on(base, lambda: fa.flash_attention_stats(q, k, v))()
        lse2 = m2 + torch.log2(l)
        dq, delta = on(base, lambda: fa.launch_bwd_dq(q, k, v, o, lse2, do,
                                                      scale))()
        grads = {"base": (dq, *on(base, lambda: fa.launch_bwd_dkv(
            q, k, v, lse2, do, delta, scale))())}
        grads["new"] = on(new, lambda: fa.launch_backward(q, k, v, o, lse2,
                                                          do, scale))()
        o_new = on(new, lambda: fa.flash_attention_stats(q, k, v))()[0]
        check = {"o": err_over_bound(o_new, o, cs.out_tol)}
        check.update({n: err_over_bound(a, b, cs.grad_tol) for n, a, b in
                      zip(("dq", "dk", "dv"), grads["new"], grads["base"])})
        row = {"shape": name, "kind": "train", "B": B, "Lq": Lq, "Lk": Lk,
               "H": H, "D": D, "err_over_bound_vs_baseline": check}
        for part, fn in (
                ("stats", lambda: fa.flash_attention_stats(q, k, v)),
                ("dq", lambda: fa.launch_bwd_dq(q, k, v, o, lse2, do, scale)),
                ("dkv", lambda: fa.launch_bwd_dkv(q, k, v, lse2, do, delta,
                                                  scale))):
            row[part], row[f"{part}_speedup"] = turns(fn)
        base_bwd = row["dq"][0] + row["dkv"][0] + row["dq"][3] + row["dkv"][3]
        new_bwd = row["dq"][1] + row["dkv"][1] + row["dq"][2] + row["dkv"][2]
        row["bwd_speedup"] = base_bwd / new_bwd
        results.append(row)
        cs.say("ab_train", shape=name, D=D, **{
            part: "|".join(f"{t:.3f}" for t in row[part])
            for part in ("stats", "dq", "dkv")},
            speedup="|".join(f"{part}:{row[f'{part}_speedup']:.3f}"
                             for part in ("stats", "dq", "dkv", "bwd")),
            err_over_bound="|".join(f"{n}:{e:.3f}" for n, e in check.items()))
        if not all(e <= 1 for e in check.values()):
            raise AssertionError(f"{name}: this tree disagrees with the "
                                 f"baseline: {check}")
        del q, k, v, do, o, m2, l, lse2, dq, delta, grads, o_new
        torch.cuda.empty_cache()

    for name, (B, Lq, H, D), Lk, kernel in kept(cs.SHAPES):
        q, k, v = (torch.randn((B, n, H, D), generator=g, device=device
                               ).bfloat16() for n in (Lq, Lk, Lk))
        check = err_over_bound(on(new, lambda: fa.flash_attention(q, k, v))(),
                               on(base, lambda: fa.flash_attention(q, k, v))(),
                               cs.out_tol)
        ts, ratio = turns(lambda: fa.flash_attention(q, k, v))
        results.append({"shape": name, "kind": "denoise", "kernel": kernel,
                        "B": B, "Lq": Lq, "Lk": Lk, "H": H, "D": D,
                        "fwd": ts, "fwd_speedup": ratio,
                        "err_over_bound_vs_baseline": {"o": check}})
        cs.say("ab_denoise", shape=name, kernel=kernel,
               fwd="|".join(f"{t:.3f}" for t in ts), speedup=f"{ratio:.3f}",
               err_over_bound=f"o:{check:.3f}")
        if not check <= 1:
            raise AssertionError(f"{name}: this tree's forward disagrees "
                                 f"with the baseline's ({check})")
        del q, k, v
        torch.cuda.empty_cache()

    if args.denoise_steps:
        results.append(time_denoise(cs, on, base, new, device,
                                    args.denoise_steps))

    if args.json:
        os.makedirs(args.json.parent, exist_ok=True)
        args.json.write_text(json.dumps(
            {"baseline": str(args.baseline), "tree": str(args.tree),
             "build": {
                "baseline": base_regs, "this_tree": new_regs},
             "order": "baseline, this tree, this tree, baseline",
             "results": results}, indent=1))
    return 0


def time_denoise(cs, on, base, new, device, steps):
    """Seconds per step of a ``steps``-step denoise of ``chip_smoke.py``'s
    full-depth model (random weights, seed 1024) on the baseline's kernels
    and this tree's, in turns after a warm-up run on each."""
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import (FusionConfig,
                                                             FusionModel)
    from fantasy_world_tpu_torch.models.wan.camera import (
        CameraPoseEncoder, CameraPoseEncoderConfig)
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    cfg, (height, width, frames) = FusionConfig(), (336, 592, 81)
    g = torch.Generator(device=device).manual_seed(1024)
    pipe = FantasyWorldPipeline(
        build(lambda: FusionModel(cfg), device=device, dtype=torch.bfloat16,
              generator=g),
        build(lambda: CameraPoseEncoder(CameraPoseEncoderConfig()),
              device=device, dtype=torch.bfloat16, generator=g))
    cond = cs.conditioning(cfg.dit, height, width, frames,
                           torch.Generator("cpu").manual_seed(1024), 512)
    plucker = pipe.encode_plucker(cond[4])

    def denoise():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        ev[0].record()
        pipe.denoise(*cond[:4], height, width, num_frames=frames,
                     num_inference_steps=steps, seed=1024,
                     plucker_fea=plucker,
                     progress_callback=lambda i, n: ev[i].record())
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) / 1e3 for i in range(steps)]

    on(base, denoise)()
    on(new, denoise)()
    runs = [on(libs, denoise)() for libs in (base, new, new, base)]
    cs.say("ab_step", steps=steps, seconds="|".join(
        ",".join(f"{t:.3f}" for t in r) for r in runs))
    return {"kind": "denoise_step", "steps": steps, "seconds": runs,
            "order": "baseline, this tree, this tree, baseline"}


if __name__ == "__main__":
    sys.exit(main())
