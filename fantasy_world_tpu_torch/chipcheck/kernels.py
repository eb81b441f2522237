"""The kernel phases: the build, each forward kernel against its plain
version at every shape of ``SHAPES``, the stats forward and the backward
pair at the training shapes, and the quantized linears.
"""
from __future__ import annotations

import time

from .common import (HEADLINE, MESH_CELLS, MESH_TRAIN_SHAPES, QLINEAR_ROWS,
                     QLINEAR_SHAPES, SHAPES, STATS_RTOL, TRAIN_SHAPES, fmt,
                     grad_tol, max_err, out_tol, ptxas_summary, qlinear_bound,
                     say, time_ms, time_sdpa, yardsticks)
from .launches import layers_per_step


def phase_build():
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    fa.build_kernels()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        kernel_registers_spills=ptxas_summary(fa.build_log()) or "cached")


def new_per_kernel():
    """The per-kernel table the kernel phases fill: {route: its largest
    error so far and its rows by shape}."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    return {k: {"max_abs_err": 0.0, "by_shape": []} for k in fa.ROUTES}


# a plain version's reference call is timed as it runs; under this many ms
# its first call's costs (the allocator growing its pool) would be a
# visible part of the time, and one more call, warm, is timed instead
PLAIN_RETIME_MS = 100.0


def plain_call(fn):
    """(``fn()``, its time in ms by CUDA events): the call itself, or, where
    it took under ``PLAIN_RETIME_MS``, one more call after it."""
    import torch
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    if ms < PLAIN_RETIME_MS:
        ms = time_ms(fn, 1, warm=False)
    return out, ms


def phase_kernels(device):
    import torch
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.convert.checkpoint import wan22_fusion_config
    g = torch.Generator(device=device).manual_seed(0)
    from fantasy_world_tpu_torch.models.wan.dit import TI2V_5B
    layers = {k: v + layers_per_step(wan22_fusion_config())[k]
              for k, v in layers_per_step(FusionConfig()).items()}
    layers.update(ti2v_dit_self=TI2V_5B.num_layers,
                  ti2v_dit_cross_text=TI2V_5B.num_layers,
                  flf2v_dit_cross_text=FusionConfig().dit.num_layers)
    # the track head's: one launch a block a refinement iteration
    from fantasy_world_tpu_torch.models.vggt.track import TrackConfig
    tc = TrackConfig()
    layers.update({name: tc.iters * tc.depth for name, *_ in SHAPES
                   if name.startswith("track_")})
    # the options: one launch per adapter block, or per IRG block, of a
    # forward that takes them
    layers.update(pose_split=FusionConfig().dit.camera_adapter_end,
                  **{name: FusionConfig().num_irg for name, *_ in SHAPES
                     if name.startswith("bicross_temporal_")})
    layers.update(MESH_CELLS)
    per_kernel = new_per_kernel()
    for name, (B, Lq, H, D), Lk, kernel in SHAPES:
        if fa.route(H, D, Lk) != kernel:
            raise AssertionError(f"{name} routes to {fa.route(H, D, Lk)}")
        q = torch.randn((B, Lq, H, D), generator=g, device=device).bfloat16()
        k = torch.randn((B, Lk, H, D), generator=g, device=device).bfloat16()
        v = torch.randn((B, Lk, H, D), generator=g, device=device).bfloat16()
        scale = D ** -0.5
        out = fa.flash_attention(q, k, v)
        # the plain versions are the slowest part of this phase: the
        # reference call is the timed one (``plain_call``)
        ref, plain_ms = plain_call(lambda: fa.attention_plain(q, k, v, scale))
        err, tol = max_err(out, ref), out_tol(ref)
        ms = time_ms(lambda: fa.flash_attention(q, k, v), 5)
        y = yardsticks("fwd", (B, Lq, Lk, H, D), ms, time_sdpa(q, k, v, 5))
        # beside onekv, the online-softmax kernel on the same inputs: a
        # yardstick the main path never takes (it routes by Lk)
        if kernel == "onekv":
            dg = fa.kernel_dim(H, D, fa.ONEKV_MAX_LK + 1)
            qg, kg, vg = (torch.nn.functional.pad(t, (0, dg - D))
                          for t in (q, k, v))
            y["online_ms"] = time_ms(
                lambda: fa.launch("generic", qg, kg, vg, scale), 5)
            del qg, kg, vg
        # below the kernel's head dim the wrapper copies q, k, v into a
        # zero-padded tensor first: the kernel alone on padded inputs
        dk = fa.kernel_dim(H, D, Lk)
        if dk != D:
            qp, kp, vp = (torch.nn.functional.pad(t, (0, dk - D))
                          for t in (q, k, v))
            y["padded_kernel_ms"] = time_ms(
                lambda: fa.launch(kernel, qp, kp, vp, scale), 5)
            del qp, kp, vp
        # the ring's calls take the stats forward: its output and (m2, l)
        # against the plain version's, and its time
        if name.startswith("ring_"):
            so, sm, sl = fa.flash_attention_stats(q, k, v)
            ro, rm, rl = fa.attention_plain_stats(q, k, v, scale)
            y["stats_max_abs_err"] = max_err(so, ro)
            y["stats_rel_err"] = max(
                ((sm - rm).abs() / rm.abs().clamp_min(1.0)).max().item(),
                ((sl - rl).abs() / rl).max().item())
            if not (y["stats_max_abs_err"] <= out_tol(ro)
                    and y["stats_rel_err"] <= STATS_RTOL):
                raise AssertionError(f"{name}: stats {y['stats_max_abs_err']}"
                                     f", {y['stats_rel_err']}")
            y["stats_ms"] = time_ms(lambda: fa.flash_attention_stats(q, k, v),
                                    5)
            del so, sm, sl, ro, rm, rl
        say("kernel", shape=name, kernel=kernel, max_abs_err=f"{err:.3e}",
            bound=f"{tol:.3e}", ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}",
            online_ms=fmt(y.get("online_ms")),
            padded_kernel_ms=fmt(y.get("padded_kernel_ms")),
            stats_ms=fmt(y.get("stats_ms")),
            tflops=f"{y['tflops']:.1f}",
            bound_ms=f"{y['bound_ms']:.4f}", bound_by=y["bound_by"],
            share=f"{y['share']:.4f}",
            library_ms="|".join(f"{b}:{fmt(t)}" for b, t in
                                y["library_ms_by_backend"].items()),
            layers_per_step=layers[name])
        if not err <= tol:
            raise AssertionError(f"{name}: max abs error {err} > {tol}")
        pk = per_kernel[kernel]
        pk["max_abs_err"] = max(pk["max_abs_err"], err)
        pk["by_shape"].append({"shape": name, "ms": ms, "plain_ms": plain_ms,
                               "max_abs_err": err, "err_bound": tol,
                               "layers_per_step": layers[name], **y})
        if name == HEADLINE[kernel]:
            pk.update(ms=ms, plain_ms=plain_ms, **y)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return per_kernel


def phase_train_kernels(device, per_kernel):
    """Stats forward, dq and dk/dv against their plain versions at the
    training shapes, one process's and the mesh trainer's; adds the stats
    and backward numbers to per_kernel."""
    import torch
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=device).manual_seed(1)
    for k in ("bwd_dq", "bwd_dkv"):
        per_kernel[k] = {"max_abs_err": 0.0, "by_shape": []}
    for name, (B, Lq, H, D), Lk, kernel in TRAIN_SHAPES + MESH_TRAIN_SHAPES:
        if fa.route(H, D, Lk) != kernel:
            raise AssertionError(f"{name} routes to {fa.route(H, D, Lk)}")
        q = torch.randn((B, Lq, H, D), generator=g, device=device).bfloat16()
        k = torch.randn((B, Lk, H, D), generator=g, device=device).bfloat16()
        v = torch.randn((B, Lk, H, D), generator=g, device=device).bfloat16()
        do = torch.randn((B, Lq, H, D), generator=g, device=device
                         ).bfloat16()
        scale = D ** -0.5
        o, m2, l = fa.flash_attention_stats(q, k, v)
        # the plain backward computes dq, dk and dv in one pass: it stands
        # beside the sum of the two kernels; each plain version is timed as
        # its reference call runs (``plain_call``)
        plain = {}
        (ro, rm2, rl), plain["stats"] = plain_call(
            lambda: fa.attention_plain_stats(q, k, v, scale))
        lse2 = m2 + torch.log2(l)
        dq, delta = fa.launch_bwd_dq(q, k, v, o, lse2, do, scale)
        dk, dv = fa.launch_bwd_dkv(q, k, v, lse2, do, delta, scale)
        ref, plain["bwd"] = plain_call(lambda: fa.attention_backward_plain(
            q, k, v, o, lse2, do, scale))
        errs = {"o": max_err(o, ro), "m2": max_err(m2, rm2),
                "l": max_err(l, rl)}
        o_tol = out_tol(ro)
        rel = {"m2": ((m2 - rm2).abs() / rm2.abs().clamp_min(1)).max().item(),
               "l": ((l - rl).abs() / rl).max().item()}
        g_tol = {}
        for gname, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            errs[gname] = max_err(got, want)
            g_tol[gname] = grad_tol(want)
        del ref, ro, rm2, rl
        ms = {"stats": time_ms(lambda: fa.flash_attention_stats(q, k, v), 5),
              "dq": time_ms(lambda: fa.launch_bwd_dq(q, k, v, o, lse2, do,
                                                      scale), 5),
              "dkv": time_ms(lambda: fa.launch_bwd_dkv(q, k, v, lse2, do,
                                                        delta, scale), 5)}
        ms["bwd"] = ms["dq"] + ms["dkv"]
        # the library's forward stands beside the stats forward, its
        # backward (dq, dk and dv in one call) beside each backward kernel
        lib_fwd = time_sdpa(q, k, v, 5)
        lib_bwd = time_sdpa(q, k, v, 3, do=do)
        dims = (B, Lq, Lk, H, D)
        ys = {"stats": yardsticks("stats", dims, ms["stats"], lib_fwd),
              "dq": yardsticks("dq", dims, ms["dq"], lib_bwd),
              "dkv": yardsticks("dkv", dims, ms["dkv"], lib_bwd)}
        say("train_kernel", shape=name, kernel=kernel, D=D,
            max_abs_err="|".join(f"{n}:{e:.3e}" for n, e in errs.items()),
            o_bound=f"{o_tol:.3e}",
            grad_bound="|".join(f"{n}:{t:.3e}" for n, t in g_tol.items()),
            **{f"{n}_ms": f"{ms[n]:.3f}" for n in ms},
            **{f"{n}_plain_ms": f"{plain[n]:.3f}" for n in plain},
            tflops="|".join(f"{n}:{y['tflops']:.1f}" for n, y in ys.items()),
            bound_ms="|".join(f"{n}:{y['bound_ms']:.4f}"
                              for n, y in ys.items()),
            share="|".join(f"{n}:{y['share']:.4f}" for n, y in ys.items()),
            library_fwd_ms="|".join(f"{b}:{fmt(t)}"
                                    for b, t in lib_fwd.items()),
            library_bwd_ms="|".join(f"{b}:{fmt(t)}"
                                    for b, t in lib_bwd.items()))
        bad = [] if errs["o"] <= o_tol else ["o"]
        bad += [n for n in ("m2", "l") if not rel[n] <= STATS_RTOL]
        bad += [n for n in ("dq", "dk", "dv") if not errs[n] <= g_tol[n]]
        if bad:
            raise AssertionError(f"{name}: {bad} beyond their bounds: "
                                 f"abs {errs} (o bound {o_tol}, gradient "
                                 f"bounds {g_tol}), relative {rel}")
        fwd = per_kernel[kernel]
        fwd["max_abs_err"] = max(fwd["max_abs_err"], errs["o"])
        fwd.setdefault("stats_by_shape", []).append(
            {"shape": name, "ms": ms["stats"], "plain_ms": plain["stats"],
             "max_abs_err": errs["o"], "err_bound": o_tol, **ys["stats"]})
        fwd["stats_max_abs_err"] = max(fwd.get("stats_max_abs_err", 0.0),
                                       errs["o"])
        if name == HEADLINE[kernel]:
            fwd["stats_ms"] = ms["stats"]
            fwd["stats_plain_ms"] = plain["stats"]
            fwd["stats_yardsticks"] = ys["stats"]
        for kname, part, grads in (("bwd_dq", "dq", ("dq",)),
                                   ("bwd_dkv", "dkv", ("dk", "dv"))):
            pk = per_kernel[kname]
            pk["max_abs_err"] = max([pk["max_abs_err"]]
                                    + [errs[n] for n in grads])
            pk["by_shape"].append({"shape": name, "D": D, "ms": ms[part],
                                   "plain_ms": plain["bwd"],
                                   "max_abs_err": {n: errs[n] for n in grads},
                                   "err_bound": {n: g_tol[n] for n in grads},
                                   **ys[part]})
            if name == HEADLINE[kname]:
                pk.update(ms=ms[part], plain_ms=plain["bwd"],
                          backward_ms=ms["bwd"], **ys[part])
        del q, k, v, do, o, m2, l, lse2, dq, delta, dk, dv
        torch.cuda.empty_cache()


def phase_qlinear(device):
    """int8 and fp8 ``qlinear`` at the production shapes against the same
    arithmetic reckoned in f32 (int8: the activations quantized as qlinear
    does, the integer product in f32; fp8: the dequantized weight), within
    two bf16 ulps of the largest output; the times of int8 qlinear, its
    three parts (activation quant, ``torch._int_mm``, rescale), fp8 qlinear
    and the bf16 ``F.linear``, beside their bounds."""
    import torch
    import torch.nn.functional as F
    from fantasy_world_tpu_torch.core import quant
    g = torch.Generator(device).manual_seed(21)
    out = {}
    for name, k, n in QLINEAR_SHAPES:
        x = torch.randn((QLINEAR_ROWS, k), generator=g, device=device,
                        dtype=torch.bfloat16)
        lin = torch.nn.Linear(k, n, device=device, dtype=torch.bfloat16)
        with torch.no_grad():
            lin.weight.uniform_(-k ** -0.5, k ** -0.5, generator=g)
            lin.bias.uniform_(-k ** -0.5, k ** -0.5, generator=g)
        q8 = quant.QuantLinear.from_linear(lin, "int8")
        f8 = quant.QuantLinear.from_linear(lin, "fp8")
        with torch.no_grad():
            got8 = quant.qlinear(x, q8)
            xq, sx = quant.quantize_activations(x)
            ref8 = ((xq.float() @ q8.weight.float().t()) * sx * q8.kscale
                    + lin.bias.float())
            del xq
            err8, tol8 = max_err(got8, ref8), out_tol(ref8)
            del got8, ref8
            gotf = quant.qlinear(x, f8)
            wf = (f8.weight.float() * f8.kscale[:, None]).to(x.dtype)
            reff = F.linear(x.float(), wf.float(), lin.bias.float())
            errf, tolf = max_err(gotf, reff), out_tol(reff)
            del gotf, reff, wf
            xq, sx = quant.quantize_activations(x)
            y32 = quant.int_mm(xq, q8.weight)
            ms = {"int8_ms": time_ms(lambda: quant.qlinear(x, q8), 5),
                  "act_quant_ms": time_ms(
                      lambda: quant.quantize_activations(x), 5),
                  "int_mm_ms": time_ms(lambda: quant.int_mm(xq, q8.weight),
                                       5),
                  "rescale_ms": time_ms(
                      lambda: quant.rescale(y32, sx, q8, x.dtype), 5),
                  "fp8_ms": time_ms(lambda: quant.qlinear(x, f8), 5),
                  "bf16_ms": time_ms(
                      lambda: F.linear(x, lin.weight, lin.bias), 5)}
            del xq, sx, y32
        bounds = {m: qlinear_bound(QLINEAR_ROWS, k, n, m)
                  for m in ("int8", "fp8", "bf16")}
        out[name] = dict(ms, int8_err=err8, int8_tol=tol8, fp8_err=errf,
                         fp8_tol=tolf)
        glue = (ms["act_quant_ms"] + ms["rescale_ms"]) / ms["int8_ms"]
        say("qlinear", shape=f"{QLINEAR_ROWS}x{k}->{n}",
            **{kk: f"{v:.3f}" for kk, v in ms.items()},
            **{f"{m}_bound_ms": f"{b:.3f}" for m, (b, _) in bounds.items()},
            int8_bound_by=bounds["int8"][1],
            glue_share=f"{glue:.3f}",
            int8_max_abs_err=f"{err8:.3e}", int8_tol=f"{tol8:.3e}",
            fp8_max_abs_err=f"{errf:.3e}", fp8_tol=f"{tolf:.3e}")
        if not (err8 <= tol8 and errf <= tolf):
            raise AssertionError(f"qlinear {name}: int8 {err8} (bound "
                                 f"{tol8}), fp8 {errf} (bound {tolf})")
        del x, lin, q8, f8
        torch.cuda.empty_cache()
    return out
