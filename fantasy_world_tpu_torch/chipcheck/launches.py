"""The exact kernel launches each path of the card check must make: per
denoise, per clip's encoders, per training step, per mesh rank (``MESH_MODES``
says how each sequence-parallel attention runs), per pipeline stage, per
serving case, per window, per TI2V-5B step and per track head forward.
"""
from __future__ import annotations

import math

import numpy as np

from .common import SHAPES, add_counts
from .inputs import (MESH_GEOMETRY, PIPE_MICROBATCHES, PIPE_STAGES,
                     SERVE_PROMPTS, SMALL_GEOMETRY, SMALL_SERVING_GEOMETRY,
                     SMALL_TEMPORAL, SMALL_WINDOW, SMALL_WINDOW_GEOMETRY,
                     small_clip_configs, small_configs, small_wan22_configs)


def layers_per_step(cfg):
    """The configuration's count of each attention shape in ``SHAPES`` per
    denoise step (without the last step's heads, and CLIP and MoGe, which
    run once per image): what each shape adds to its route's launches,
    which ``phase_full_slice`` measures. A Wan2.2 configuration (the
    control adapter) counts the ``wan22_`` shapes, a Wan2.1 one the
    others but the ``serve_`` ones, which only ``phase_full_serve`` runs."""
    n_dit, n_x, n_irg = cfg.dit.num_layers, len(cfg.xattn_set()), cfg.num_irg
    counts = {"dit_self": n_dit, "dit_cross_text": n_dit,
              "bicross_video_to_geometry": n_x,
              "bicross_geometry_to_video": n_x, "vggt_frame": n_irg,
              "vggt_global": n_irg}
    if cfg.dit.has_image_input:
        counts["dit_cross_clip"] = n_dit
    prefix = "wan22_" if cfg.dit.add_control_adapter else ""
    out = {name: 0 for name, *_ in SHAPES}
    out.update({prefix + name: n for name, n in counts.items()})
    return out


def expected_launches(cfg, steps, clip=None, moge=None, skipped=0):
    """Kernel launches of a denoise: per step DiT self (generic), bicross
    both ways (generic), DiT cross text, and CLIP where the model takes it
    (onekv), VGGT frame + global (d64); the camera-head trunk (onekv) on the
    last step; none on the ``skipped`` steps (TeaCache replaces their block
    stack). With ``clip`` and ``moge``, the encoders' launches of one clip
    (``encoder_launches``)."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    n_irg = len(cfg.xattn_set())
    trunk = 4 * cfg.vggt.camera_head.trunk_depth
    cross = 2 if cfg.dit.has_image_input else 1
    run = steps - skipped
    out = {k: 0 for k in fa.LAUNCHES}
    out.update(generic=run * (cfg.dit.num_layers + 2 * n_irg),
               onekv=run * cross * cfg.dit.num_layers + trunk,
               d64=run * 2 * cfg.num_irg)
    for k, v in encoder_launches(clip, moge).items():
        out[k] += v
    return out


def encoder_launches(clip=None, moge=None):
    """The kernel launches of one clip's encoders: with ``clip`` (a
    CLIPVisionConfig), the image encoder's self-attention, one launch per
    block it runs (all but the last) on its route; with ``moge`` (a
    MoGeConfig and its token count), DINOv2's, one per block."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    out = {}
    if clip is not None:
        route = fa.route(clip.num_heads, clip.dim // clip.num_heads,
                         clip.num_patches + 1)
        out[route] = out.get(route, 0) + clip.num_layers - 1
    if moge is not None:
        mcfg, tokens = moge
        enc = mcfg.encoder
        route = fa.route(enc.num_heads, enc.dim // enc.num_heads, tokens)
        out[route] = out.get(route, 0) + enc.depth
    return out


def moge_tokens(cfg, image_hw, resolution_level=9):
    """DINOv2's sequence length for an (H, W) image at the resolution level
    ``moge_infer`` uses: the patch grid of its token budget plus the class
    token."""
    h, w = image_hw
    lo, hi = cfg.num_tokens_range
    n = int(lo + (resolution_level / 9) * (hi - lo))
    return int((n / (w / h)) ** 0.5) * int((n * (w / h)) ** 0.5) + 1


def expected_train_launches(cfg, steps, remat=True):
    """Kernel launches of ``steps`` training steps (no heads): per forward
    pass the stats forward of every attention -- DiT self and both bicross
    directions (generic), DiT cross text + CLIP (onekv), VGGT frame + global
    (d64) -- twice under per-block recompute; per backward dq and dk/dv of
    every attention the loss reaches, counted at the head dim its kernel
    runs at. The geometry tokens after the last IRG block feed only the
    heads, which the loss does not run, so the last bicross's
    geometry-side attention gets no gradient and no backward."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    n_x = len(cfg.xattn_set())
    n_dit, n_irg = cfg.dit.num_layers, cfg.num_irg
    passes = steps * (2 if remat else 1)
    out = {k: 0 for k in fa.LAUNCHES}
    out.update(generic_stats=passes * (n_dit + 2 * n_x),
               onekv_stats=passes * 2 * n_dit, d64_stats=passes * 2 * n_irg)
    vggt = cfg.vggt.aggregator.block_cfg
    big = fa.ONEKV_MAX_LK + 1
    for D, n in ((fa.kernel_dim(cfg.dit.num_heads, cfg.dit.head_dim, big),
                  3 * n_dit),
                 (fa.kernel_dim(cfg.bicross.num_heads, cfg.bicross.head_dim,
                                big),
                  2 * n_x - ((n_irg - 1) in cfg.xattn_set())),
                 (fa.kernel_dim(vggt.num_heads, vggt.head_dim, big),
                  2 * n_irg)):
        for k in ("bwd_dq", "bwd_dkv"):
            out[f"{k}_{D}"] += steps * n
    return out


def track_launches(tc, forwards=1):
    """d64 launches of the track head: per refinement iteration and block,
    time attention, virtual <- points, virtual self, points <- virtual."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    out = {k: 0 for k in fa.LAUNCHES}
    out["d64"] = forwards * tc.iters * tc.depth * 4
    return out


def no_launches():
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    return {k: 0 for k in fa.LAUNCHES}


def pose_dit_launches(dcfg, tokens, frames):
    """Kernel launches of one ``WanDiT.forward`` with Plucker features (one
    token each per video token) over ``tokens`` tokens in ``frames``
    latent frames: per block the self-attention (generic) and the text and
    CLIP cross-attentions (onekv); on each adapter block the pose
    attention, over one frame's Plucker tokens ('latent_split') or all of
    them ('latent_overall'), on the route those keys take."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    n = dcfg.num_layers
    out = no_launches()
    out["generic"] += n
    out["onekv"] += n * (2 if dcfg.has_image_input else 1)
    keys = (tokens // frames if dcfg.pose_inject_method == "latent_split"
            else tokens)
    out[fa.route(dcfg.num_heads, dcfg.head_dim, keys)] += min(
        dcfg.camera_adapter_end, n)
    return out


def joint_launches(cfg, uncond=False):
    """Kernel launches of one ``joint_forward`` without the heads: a
    denoise step's (``expected_launches``) without the camera trunk; with
    ``uncond`` the IRG blocks' two bicross attentions each are gone."""
    out = expected_launches(cfg, 1)
    out["onekv"] -= 4 * cfg.vggt.camera_head.trunk_depth
    if uncond:
        out["generic"] -= 2 * len(cfg.xattn_set())
    return out


def temporal_launches(bcfg, T, S, R, M):
    """``Bicross.forward_temporal``: the video frames over their windows'
    W * M geometry tokens, and back over S video tokens."""
    import math
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    out = no_launches()
    W = math.ceil(R / T)
    for keys in (W * M, S):
        out[fa.route(bcfg.num_heads, bcfg.head_dim, keys)] += 1
    return out


def small_option_launches(fusion, dits, inputs):
    """What ``small_option_runs`` should launch on the card."""
    cfg = fusion.cfg
    want = {"camera_token": joint_launches(cfg),
            "uncond": joint_launches(cfg, uncond=True),
            "temporal": temporal_launches(cfg.bicross, *SMALL_TEMPORAL)}
    for method, dit in dits.items():
        want[method] = pose_dit_launches(dit.cfg, inputs["tokens"],
                                         inputs["frames"])
    return want


# How each sequence-parallel attention of a mesh runs -- (DiT self, VGGT
# global, bicross both ways) -- written out, not asked of the port's
# dispatch, so that a wrong dispatch shows as wrong launches. Keyed by the
# config (small_configs: 2 heads everywhere; FusionConfig(): DiT 40, VGGT
# 16, bicross 12), the mesh and Ulysses. "local": one seq rank, nothing
# split; "gather": the keys gathered (no Ulysses); "ulysses": the heads
# divide by the seq ranks (the DiT's over its 1/M model share); "ring":
# they do not.
MESH_MODES = {
    ("small", (1, 2, 1), True): ("ulysses", "ulysses", "ulysses"),
    ("small", (2, 2, 2), False): ("gather", "gather", "gather"),
    ("small", (1, 4, 1), True): ("ring", "ring", "ring"),
    ("small", (2, 1, 2), False): ("local", "local", "local"),
    ("small", (1, 2, 2), True): ("ring", "ulysses", "ulysses"),
    ("small", (4, 1, 1), False): ("local", "local", "local"),
    # small_mesh_serving: int8 / fp8, Wan2.2 (same heads) and the server
    # at 1x1x2; the windows of 3 latent frames (split 2 | 1) at 1x2x1
    ("small", (1, 1, 2), False): ("local", "local", "local"),
    ("small_window", (1, 2, 1), True): ("ulysses", "ulysses", "ulysses"),
    # tools/torch_mesh_check.py's windows over 4 cards
    ("small_window", (1, 2, 2), True): ("ring", "ulysses", "ulysses"),
    ("full", (1, 1, 2), False): ("local", "local", "local"),
    ("full", (1, 2, 1), True): ("ulysses", "ulysses", "ulysses"),
    ("full", (1, 1, 4), False): ("local", "local", "local"),
    ("full", (1, 4, 1), True): ("ulysses", "ulysses", "ulysses"),
}


def attention_mode_launches(mode, H, D, q_split, kv_split):
    """{launch key: count} of one attention of this rank run as ``mode``
    (``MESH_MODES``)."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    if mode in ("local", "gather"):
        return {fa.route(H, D, kv_split.length): 1}
    if mode == "ulysses":
        return {fa.route(H // q_split.n, D, kv_split.length): 1}
    if mode == "ring":
        return {fa.route(H, D, max(kv_split.sizes)) + "_stats": kv_split.n}
    raise ValueError(mode)


def mesh_launches(cfg, fhw, shape, modes, steps, rank, text_len, skipped=0,
                  heads=True):
    """Kernel launches of one rank of a ``shape`` mesh over a denoise of
    ``steps`` steps with the heads on the last (rank 0's): per DiT block
    its self-attention (seq-parallel) and cross-attentions at 1/M of the
    heads, per IRG block frame attention (local) and global attention
    (seq-parallel), per coupled block bicross both ways (seq-parallel);
    the camera trunk on rank 0. ``modes``: a ``MESH_MODES`` entry.
    ``skipped``: TeaCache steps whose block stack did not run; ``heads``
    False: no heads step (a window's forward)."""
    from collections import Counter

    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.parallel import sharding
    f, h, w = fhw
    d, s, m = shape
    psi = cfg.vggt.aggregator.patch_start_idx
    sizes = tuple(len(c) for c in np.array_split(np.arange(f), s))
    seq_index = int(np.unravel_index(rank, shape)[1])
    frames = sharding.TokenSplit(None, sizes, seq_index)
    s_dit, s_agg = frames.scaled(h * w), frames.scaled(h * w + psi)
    dc, bc = cfg.dit, cfg.bicross
    vb = cfg.vggt.aggregator.block_cfg
    hd = dc.num_heads // m
    step = Counter()
    m_self, m_glob, m_bi = modes
    self_attn = attention_mode_launches(m_self, hd, dc.head_dim, s_dit,
                                        s_dit)
    glob = attention_mode_launches(m_glob, vb.num_heads, vb.head_dim, s_agg,
                                   s_agg)
    v2g = attention_mode_launches(m_bi, bc.num_heads, bc.head_dim, s_dit,
                                  s_agg)
    g2v = attention_mode_launches(m_bi, bc.num_heads, bc.head_dim, s_agg,
                                  s_dit)
    for _ in range(dc.num_layers):
        step.update(self_attn)
        step[fa.route(hd, dc.head_dim, text_len)] += 1
        if dc.has_image_input:
            step[fa.route(hd, dc.head_dim, 257)] += 1
    for i in range(cfg.num_irg):
        step[fa.route(vb.num_heads, vb.head_dim, h * w + psi)] += 1
        step.update(glob)
        if i in cfg.xattn_set():
            step.update(v2g)
            step.update(g2v)
    out = {k: 0 for k in fa.LAUNCHES}
    for k, v in step.items():
        out[k] += v * (steps - skipped)
    if rank == 0 and heads:
        out["onekv"] += 4 * cfg.vggt.camera_head.trunk_depth
    return out


def mesh_window_launches(cfg, hw, frames, window, shape, modes, steps, rank,
                         text_len):
    """``mesh_launches`` of a sliding-window denoise over ``frames`` latent
    frames in windows of ``window`` = (size, stride): each window a
    forward over its frames, no heads."""
    from fantasy_world_tpu_torch.pipelines.temporal_tiler import window_plan
    return add_counts(*(mesh_launches(cfg, (t1 - t0, *hw), shape, modes, steps,
                                      rank, text_len, heads=False)
                        for t0, t1 in window_plan(frames, *window)))


def attention_mode_backward(mode, H, D, q_split, kv_split):
    """{launch key: count} of the backward of one attention of this rank
    run as ``mode`` (``MESH_MODES``): dq and dk/dv once, at the head dim
    the kernels run at; the ring's once per hop."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    if mode in ("local", "gather"):
        d, n = fa.kernel_dim(H, D, kv_split.length), 1
    elif mode == "ulysses":
        d, n = fa.kernel_dim(H // q_split.n, D, kv_split.length), 1
    elif mode == "ring":
        d, n = fa.kernel_dim(H, D, max(kv_split.sizes)), kv_split.n
    else:
        raise ValueError(mode)
    return {f"bwd_dq_{d}": n, f"bwd_dkv_{d}": n}


def mesh_train_launches(cfg, fhw, shape, modes, rank, steps, text_len):
    """Kernel launches of one rank of a ``shape`` mesh over ``steps``
    training steps (``expected_train_launches`` on a mesh): every
    attention's stats forward, twice under per-block recompute, and its
    backward, as ``modes`` (a ``MESH_MODES`` entry) runs them -- the DiT's
    at 1/M of its heads -- less the last bicross's geometry-side backward
    (its output feeds only the heads, which the loss does not run)."""
    from collections import Counter

    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.parallel import sharding
    f, h, w = fhw
    d, s, m = shape
    psi = cfg.vggt.aggregator.patch_start_idx
    sizes = tuple(len(c) for c in np.array_split(np.arange(f), s))
    frames = sharding.TokenSplit(None, sizes,
                                 int(np.unravel_index(rank, shape)[1]))
    s_dit, s_agg = frames.scaled(h * w), frames.scaled(h * w + psi)
    dc, bc = cfg.dit, cfg.bicross
    vb = cfg.vggt.aggregator.block_cfg
    hd = dc.num_heads // m
    fwd, bwd = Counter(), Counter()

    def attention(mode, H, D, q_split, kv_split, backward=True):
        for k, v in attention_mode_launches(mode, H, D, q_split,
                                            kv_split).items():
            fwd[k if k.endswith("_stats") else k + "_stats"] += v
        if backward:
            bwd.update(attention_mode_backward(mode, H, D, q_split,
                                               kv_split))

    def whole(n):
        return sharding.TokenSplit(None, (n,), 0)

    m_self, m_glob, m_bi = modes
    for _ in range(dc.num_layers):
        attention(m_self, hd, dc.head_dim, s_dit, s_dit)
        attention("local", hd, dc.head_dim, None, whole(text_len))
        if dc.has_image_input:
            attention("local", hd, dc.head_dim, None, whole(257))
    last = cfg.num_irg - 1
    for i in range(cfg.num_irg):
        attention("local", vb.num_heads, vb.head_dim, None,
                  whole(h * w + psi))
        attention(m_glob, vb.num_heads, vb.head_dim, s_agg, s_agg)
        if i in cfg.xattn_set():
            attention(m_bi, bc.num_heads, bc.head_dim, s_dit, s_agg)
            attention(m_bi, bc.num_heads, bc.head_dim, s_agg, s_dit,
                      backward=i != last)
    out = {k: 0 for k in fa.LAUNCHES}
    for k, v in fwd.items():
        out[k] += v * 2 * steps
    for k, v in bwd.items():
        out[k] += v * steps
    return out


def pipe_seq_split(geometry, seq, rank):
    """The tokens of ``rank``'s frames (a ``TokenSplit``) on a (stages, 1,
    ``seq``, 1) pipe mesh at ``geometry``."""
    from fantasy_world_tpu_torch.parallel.sharding import TokenSplit
    height, width, frames = geometry
    f, hw = (frames - 1) // 4 + 1, (height // 16) * (width // 16)
    sizes = tuple(len(c) * hw for c in np.array_split(np.arange(f), seq))
    return TokenSplit(None, sizes, rank % seq)


def pipe_launches_of(cfg, geometry, text_len, rank, seq=1, ulysses=False,
                     stages=PIPE_STAGES, microbatches=PIPE_MICROBATCHES):
    """``pipe_train_launches`` of ``rank`` of a (``stages``, data, ``seq``,
    1) pipe mesh: the gather, or Ulysses under ``ulysses``, on seq
    ranks."""
    blocks = cfg.num_layers // stages
    if seq == 1:
        return pipe_train_launches(cfg, blocks, pipe_tokens(geometry),
                                   text_len, microbatches)
    return pipe_train_launches(
        cfg, blocks, None, text_len, microbatches,
        mode="ulysses" if ulysses else "gather",
        split=pipe_seq_split(geometry, seq, rank))


def pipe_tokens(geometry):
    height, width, frames = geometry
    return ((frames - 1) // 4 + 1) * (height // 16) * (width // 16)


def pipe_train_launches(cfg, blocks, tokens, text_len,
                        microbatches=PIPE_MICROBATCHES, mode="local",
                        split=None):
    """Kernel launches of one pipeline step on a rank holding
    ``blocks`` blocks: each block runs each of its data rank's
    ``microbatches`` through its self-attention (``tokens`` keys) and its
    cross-attentions (the text's and CLIP's keys), each a stats forward
    twice under per-block recompute and one backward, dq and dk/dv, at
    the head dim its kernel runs at. ``split``: where the stage splits its
    frames over seq ranks, this rank's tokens (a ``TokenSplit``) and
    ``mode`` how the self-attention runs over them ("gather", "ulysses" or
    "ring", as ``attention_mode_launches`` counts them); the
    cross-attentions take the rank's queries against the whole keys."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.parallel.sharding import TokenSplit

    def whole(n):
        return TokenSplit(None, (n,), 0)

    split = split or whole(tokens)
    out = {k: 0 for k in fa.LAUNCHES}
    n = blocks * microbatches
    H, D = cfg.num_heads, cfg.head_dim
    attentions = [(mode, split), ("local", whole(text_len))] + (
        [("local", whole(257))] if cfg.has_image_input else [])
    for how, keys in attentions:
        for k, v in attention_mode_launches(how, H, D, split, keys).items():
            out[k if k.endswith("_stats") else k + "_stats"] += 2 * n * v
        for k, v in attention_mode_backward(how, H, D, split, keys).items():
            out[k] += n * v
    return out


def mesh_mode_frames(name):
    """The latent frames over which ``MESH_MODES[name, ...]`` is taken."""
    return {"small": (SMALL_GEOMETRY[2] - 1) // 4 + 1,
            "small_window": SMALL_WINDOW[0],
            "full": (MESH_GEOMETRY[2] - 1) // 4 + 1}[name]


def serving_launches(case, shape, uly, rank):
    """The launches a small_mesh_serving case makes on ``rank``."""
    fcfg = small_configs()[0]
    h, w, n = SMALL_SERVING_GEOMETRY
    fhw = ((n - 1) // 4 + 1, h // 16, w // 16)
    modes = MESH_MODES["small", shape, uly]
    if case in ("int8", "fp8"):
        return mesh_launches(fcfg, fhw, shape, modes, 2, rank, 16)
    if case == "wan22":
        return mesh_launches(small_wan22_configs()[0], fhw, shape, modes, 3,
                             rank, 16)
    if case == "server":
        ccfg, _, _, clipc, _ = small_clip_configs()
        out = mesh_launches(ccfg, fhw, shape, modes, 2, rank, 512)
        if rank == 0:
            for _ in SERVE_PROMPTS:
                out = add_counts(out, encoder_launches(clip=clipc))
        return out
    if case == "tea":
        return mesh_launches(fcfg, fhw, shape, modes, 4, rank, 16,
                             skipped=1)
    h, w, n = SMALL_WINDOW_GEOMETRY
    f = (n - 1) // 4 + 1
    return mesh_window_launches(
        fcfg, (h // 16, w // 16), f, SMALL_WINDOW, shape,
        MESH_MODES["small_window", shape, uly], 2, rank, 16)


def expected_window_launches(cfg, plan, height, width, steps):
    """Kernel launches of a sliding-window denoise (no heads): per window
    of each step, every attention of the fusion forward on the route its
    window's key count takes -- DiT self over the window's video tokens,
    DiT cross (text, and CLIP where the model takes it), bicross both ways
    (geometry tokens: a frame's video tokens plus the aggregator's special
    tokens), VGGT frame and global (d64)."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    pt = cfg.dit.patch_size
    per_frame = (height // 8 // pt[1]) * (width // 8 // pt[2])
    extra = cfg.vggt.aggregator.patch_start_idx
    d, b = cfg.dit, cfg.bicross
    n_x = len(cfg.xattn_set())
    out = {k: 0 for k in fa.LAUNCHES}
    for t0, t1 in plan:
        video, geom = (t1 - t0) * per_frame, (t1 - t0) * (per_frame + extra)
        out[fa.route(d.num_heads, d.head_dim, video)] += d.num_layers
        # text keys (at most 512) and CLIP's 257
        cross = 2 if d.has_image_input else 1
        out[fa.route(d.num_heads, d.head_dim, 512)] += cross * d.num_layers
        for lk in (geom, video):
            out[fa.route(b.num_heads, b.head_dim, lk)] += n_x
        out["d64"] += 2 * cfg.num_irg
    return {k: v * steps for k, v in out.items()}


def ti2v_launches(cfg, steps):
    """A TI2V denoise's launches: per step, each block's self-attention
    (generic at these lengths) and text cross-attention (onekv)."""
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    out = {k: 0 for k in fa.LAUNCHES}
    out.update(generic=steps * cfg.num_layers, onekv=steps * cfg.num_layers)
    return out
