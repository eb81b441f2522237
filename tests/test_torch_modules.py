"""Each module of the port's denoise slice against its JAX counterpart: the
same seeded numpy inputs and the same weights (a JAX ``init_fusion`` tree
carried across with ``convert/from_jax.py``), in f32 on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from fantasy_world_tpu.convert.camera import convert_pose_encoder
from fantasy_world_tpu.models.fusion import bicross as jbi
from fantasy_world_tpu.models.fusion.model import FusionConfig, init_fusion
from fantasy_world_tpu.models.vggt import blocks as jvb
from fantasy_world_tpu.models.vggt import heads as jheads
from fantasy_world_tpu.models.vggt import model as jvm
from fantasy_world_tpu.models.vggt.aggregator import (AggregatorConfig,
                                                      assemble_tokens)
from fantasy_world_tpu.models.vggt.model import VGGTConfig
from fantasy_world_tpu.models.wan import camera as jcam
from fantasy_world_tpu.models.wan import dit as jdit
from fantasy_world_tpu.models.wan.dit import WanDiTConfig
from fantasy_world_tpu.ops import norms as jnorms
from fantasy_world_tpu.ops import rope as jrope
from fantasy_world_tpu.schedulers import FlowMatchScheduler as JSched

from fantasy_world_tpu_torch.convert.from_jax import (
    fusion_config_from, fusion_state_dict, pose_config_from,
    pose_encoder_state_dict)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.fusion.model import FusionModel
from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
from fantasy_world_tpu_torch.ops import norms, rope
from fantasy_world_tpu_torch.schedulers.flow_match import FlowMatchScheduler

torch.set_num_threads(1)

# f32 on both sides; differences are summation order in the matmuls and
# reductions, relative to the output's largest magnitude
RTOL = 1e-4

# every head dim differs and exceeds 1 head: DiT 4x16, VGGT 4x8, bicross
# 4x12, camera trunk 4x16
CFG = FusionConfig(
    dit=WanDiTConfig(dim=64, ffn_dim=128, num_heads=4, num_layers=3,
                     text_dim=32, clip_feature_dim=48, plucker_dim=40,
                     camera_adapter_end=2),
    vggt=VGGTConfig(embed_dim=32, wan_dim=64, dpt_layer_idx=(1, 1, 0, 0),
                    dpt_features=16, dpt_out_channels=(8, 16, 32, 32),
                    camera_num_heads=4,
                    aggregator=AggregatorConfig(embed_dim=32, depth=2,
                                                num_heads=4)),
    bicross=jbi.BicrossConfig(m1_dim=64, m2_dim=32, hidden=48, num_heads=4),
    start_index=1)
POSE_CFG = jcam.CameraPoseEncoderConfig(dim=64, context_dim=40)
F_, H_, W_ = 3, 4, 6          # token grid: latent frames, rows, columns


def _wake(params, rng):
    """Random values for the zero-initialised gates so they contribute."""
    for b in params["bicross"]:
        for k in ("gamma_m1", "gamma_m2"):
            b[k] = rng.standard_normal(b[k].shape).astype(np.float32) * 0.5
    for blk in params["dit"]["blocks"]:
        if "camera" in blk:
            fc2 = blk["camera"]["v_group2"]["fc2"]
            fc2["kernel"] = rng.standard_normal(
                fc2["kernel"].shape).astype(np.float32) * 0.1
    ch = params["vggt"]["camera_head"]
    ch["camera_time_upsample"]["kernel"] = rng.standard_normal(
        ch["camera_time_upsample"]["kernel"].shape).astype(np.float32) * 0.1
    ch["empty_pose_tokens"] = rng.standard_normal(
        ch["empty_pose_tokens"].shape).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(0)
    params = _wake(init_fusion(0, CFG, jnp.float32), rng)
    model = build(lambda: FusionModel(fusion_config_from(CFG)), device="cpu",
                  dtype=torch.float32)
    model.load_state_dict(fusion_state_dict(params, model), strict=True)
    # the pose encoder has no JAX init: its JAX tree comes from the port's
    # random state dict through the JAX package's converter, then back
    # at conv widths other than the default 128: the port takes them from
    # the JAX tree
    g = torch.Generator().manual_seed(1)
    src_cfg = dataclasses.replace(pose_config_from(POSE_CFG),
                                  hidden=(96, 64, 80))
    pose_src = build(lambda: CameraPoseEncoder(src_cfg),
                     device="cpu", dtype=torch.float32, generator=g)
    pose_tree = convert_pose_encoder(
        {"pe." + k: v.numpy() for k, v in pose_src.state_dict().items()},
        "pe.")
    pose_cfg = pose_config_from(POSE_CFG, pose_tree)
    assert pose_cfg.hidden == (96, 64, 80)
    pose = build(lambda: CameraPoseEncoder(pose_cfg),
                 device="cpu", dtype=torch.float32)
    pose.load_state_dict(pose_encoder_state_dict(pose_tree, pose), strict=True)
    return {"p": params, "m": model, "pose_tree": pose_tree, "pose": pose}


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


T = torch.from_numpy


def _dit_rope(head_dim):
    ang = jrope.build_angles_3d(head_dim, F_, H_, W_)
    return jrope.cos_sin_half_from_angles(ang), \
        rope.cos_sin_half_from_angles(rope.build_angles_3d(head_dim, F_, H_,
                                                           W_))


def case_norms(env):
    x, s = _x(2, 7, 24), _x(24, seed=1)
    sh, sc = _x(2, 1, 24, seed=2), _x(2, 1, 24, seed=3)
    w, b = _x(24, seed=4), _x(24, seed=5)
    j = [jnorms.rms_norm(x, s), jnorms.layer_norm(x, {"scale": w, "bias": b}),
         jnorms.layer_norm_modulate(x, sh, sc, None),
         jnorms.layer_norm_modulate(_x(4, 7, 24), sh, sc,
                                    {"scale": w, "bias": b}, 1e-5)]
    t = [norms.rms_norm(T(x), T(s)), norms.layer_norm(T(x), T(w), T(b)),
         norms.layer_norm_modulate(T(x), T(sh), T(sc)),
         norms.layer_norm_modulate(T(_x(4, 7, 24)), T(sh), T(sc), T(w), T(b),
                                   1e-5)]
    return j, t


def case_rope(env):
    (jc, js), (tc, ts) = _dit_rope(16)
    x = _x(2, F_ * H_ * W_, 3, 16)
    pos = jrope.grid_positions_2d(H_, W_, n_special=5)[None].repeat(2, 0)
    jc2, js2 = jrope.rope2d_tables_from_positions(jnp.asarray(pos), 8)
    tc2, ts2 = rope.rope2d_tables_from_positions(T(pos), 8)
    x2 = _x(2, pos.shape[1], 4, 8, seed=1)
    ang = jrope.build_angles_3d(12, F_, H_, W_, n_extra_per_frame=5)
    tang = rope.build_angles_3d(12, F_, H_, W_, n_extra_per_frame=5)
    t_steps = np.array([999.0, 3.5], np.float32)
    j = [jrope.apply_rope_half(x, jc, js),
         jrope.apply_rope_2d_tables(x2, jc2, js2), ang,
         jrope.sinusoidal_embedding_1d(256, jnp.asarray(t_steps))]
    t = [rope.apply_rope_half(T(x), tc, ts),
         rope.apply_rope_2d_tables(T(x2), tc2, ts2), tang,
         rope.sinusoidal_embedding_1d(256, T(t_steps))]
    return j, t


def _dit_inputs(env):
    d = CFG.dit
    x = _x(2, F_ * H_ * W_, d.dim)
    ctx = _x(2, 257 + 9, d.dim, seed=1)
    t_mod = _x(2, 6, d.dim, seed=2, scale=0.3)
    pl = _x(2, F_ * H_ * W_, d.plucker_dim, seed=3)
    return x, ctx, t_mod, pl


def case_dit_block(env):
    x, ctx, t_mod, pl = _dit_inputs(env)
    (jc, js), (tc, ts) = _dit_rope(CFG.dit.head_dim)
    j, t = [], []
    for i in (0, 2):          # with and without the camera adapter
        jp, tb = env["p"]["dit"]["blocks"][i], env["m"].dit.blocks[i]
        j.append(jdit.dit_block_apply(jp, x, ctx, t_mod, jc, js, CFG.dit,
                                      plucker_fea=pl, apply_pose=True))
        t.append(tb(T(x), T(ctx), T(t_mod), tc, ts, plucker_fea=T(pl),
                    apply_pose=True))
    # the camera gate: an all-zero Plucker input turns the adapter off
    jp, tb = env["p"]["dit"]["blocks"][0], env["m"].dit.blocks[0]
    z = np.zeros_like(pl)
    j.append(jdit.dit_block_apply(jp, x, ctx, t_mod, jc, js, CFG.dit,
                                  plucker_fea=z, apply_pose=True))
    t.append(tb(T(x), T(ctx), T(t_mod), tc, ts, plucker_fea=T(z),
                apply_pose=True))
    return j, t


def case_dit_block_split(env):
    x, ctx, t_mod, pl = _dit_inputs(env)
    (jc, js), (tc, ts) = _dit_rope(CFG.dit.head_dim)
    jp, tb = env["p"]["dit"]["blocks"][1], env["m"].dit.blocks[1]
    jx, jmods = jdit.dit_block_attn_half(jp, x, ctx, t_mod, jc, js, CFG.dit,
                                         plucker_fea=pl, apply_pose=True)
    tx, tmods = tb.attn_half(T(x), T(ctx), T(t_mod), tc, ts,
                             plucker_fea=T(pl), apply_pose=True)
    return ([jx, *jmods, jdit.dit_block_ffn_half(jp, jx, jmods, CFG.dit)],
            [tx, *tmods, tb.ffn_half(tx, tmods)])


def case_dit_embeddings(env):
    d, jp, tm = CFG.dit, env["p"]["dit"], env["m"].dit
    ts = np.array([900.0, 12.0], np.float32)
    lat = _x(2, d.in_dim, F_, 2 * H_, 2 * W_)
    ctx, clip = _x(2, 9, d.text_dim, seed=1), _x(2, 257, d.clip_feature_dim,
                                                 seed=2)
    jt, jtm = jdit.time_embedding(jp, d, jnp.asarray(ts))
    tt, ttm = tm.time_embed(T(ts))
    jtok, grid = jdit.patchify(jp, d, lat)
    ttok, tgrid = tm.patchify(T(lat))
    assert grid == tgrid
    xo = _x(2, F_ * H_ * W_, d.dim, seed=3)
    jhead = jdit.head_apply(jp, d, xo, jt)
    thead = tm.head(T(xo), tt)
    return ([jt, jtm, jdit.text_embedding(jp, ctx),
             jdit.img_embedding(jp, clip), jtok, jhead,
             jdit.unpatchify(d, jhead, grid)],
            [tt, ttm, tm.text_embed(T(ctx)), tm.img_emb(T(clip)), ttok, thead,
             tm.unpatchify(thead, grid)])


def case_vggt_block(env):
    a = CFG.vggt.aggregator
    B, P = 2, 5 + H_ * W_
    pos = jrope.grid_positions_2d(H_, W_, n_special=5)[None].repeat(B * F_, 0)
    jtab = jrope.rope2d_tables_from_positions(jnp.asarray(pos), a.block_cfg
                                              .head_dim)
    ttab = rope.rope2d_tables_from_positions(T(pos), a.block_cfg.head_dim)
    x = _x(B * F_, P, a.embed_dim)
    e0 = _x(B, 6, a.embed_dim, seed=1, scale=0.3)   # broadcast over frames
    jp = env["p"]["vggt"]["aggregator"]["frame_blocks"][1]
    tb = env["m"].vggt.aggregator.frame_blocks[1]
    jx, je = jvb.vggt_block_attn_half(jp, a.block_cfg, x, jtab, e0)
    tx, te = tb.attn_half(T(x), ttab, T(e0))
    return ([jvb.vggt_block_apply(jp, a.block_cfg, x, jtab, e0), jx, *je],
            [tb(T(x), ttab, T(e0)), tx, *te])


def case_bicross(env):
    bc = CFG.bicross
    P = 5 + H_ * W_
    x1 = _x(2, F_ * H_ * W_, bc.m1_dim)
    x2 = _x(2, F_ * P, bc.m2_dim, seed=1)
    jr1 = jrope.cos_sin_half_from_angles(
        jrope.build_angles_3d(bc.head_dim, F_, H_, W_))
    jr2 = jrope.cos_sin_half_from_angles(
        jrope.build_angles_3d(bc.head_dim, F_, H_, W_, n_extra_per_frame=5))
    tr1 = rope.cos_sin_half_from_angles(
        rope.build_angles_3d(bc.head_dim, F_, H_, W_))
    tr2 = rope.cos_sin_half_from_angles(
        rope.build_angles_3d(bc.head_dim, F_, H_, W_, n_extra_per_frame=5))
    j = jbi.bicross_apply(env["p"]["bicross"][1], bc, x1, x2, jr1, jr2)
    t = env["m"].bicross[1](T(x1), T(x2), tr1, tr2)
    return list(j), list(t)


def case_process_wan_input(env):
    v = CFG.vggt
    feats = _x(2, F_, H_, W_, v.wan_dim)
    ts = np.array([700.0, 700.0], np.float32)
    jproj, je0 = jvm.process_wan_input(env["p"]["vggt"], v, feats,
                                       jnp.asarray(ts))
    tproj, te0 = env["m"].vggt.process_wan_input(T(feats), T(ts))
    jtok, jpos = assemble_tokens(env["p"]["vggt"]["aggregator"],
                                 v.aggregator, jproj)
    ttok, tpos = env["m"].vggt.aggregator.assemble_tokens(tproj)
    return [jproj, je0, jtok, jpos], [tproj, te0, ttok, tpos]


def _agg_tokens(seed=0):
    """Per-layer (B, S, P, 2C) aggregator intermediates."""
    v = CFG.vggt
    return [_x(2, F_, 5 + H_ * W_, 2 * v.embed_dim, seed=seed + i)
            for i in range(v.aggregator.depth)]


def case_camera_head(env):
    v = CFG.vggt
    toks = _agg_tokens()
    j = jheads.camera_head_forward(env["p"]["vggt"]["camera_head"],
                                   v.camera_head, toks[-1])
    t = env["m"].vggt.camera_head(T(toks[-1]))
    return j, t


def case_dpt_head(env):
    v = CFG.vggt
    toks = _agg_tokens(seed=3)
    j, t = [], []
    for name, out_dim, act in (("depth_head", 2, "exp"),
                               ("point_head", 4, "inv_log")):
        j += list(jheads.dpt_head_forward(env["p"]["vggt"][name],
                                          v.dpt_head(out_dim, act), toks,
                                          (H_, W_), 5))
        t += list(getattr(env["m"].vggt, name)([T(x) for x in toks],
                                               (H_, W_), 5))
    return j, t


def case_camera_pose_encoder(env):
    plucker = _x(1, 9, 32, 48, 6)           # 9 frames -> 5 -> 3 latent
    j = jcam.camera_pose_encoder_apply(env["pose_tree"], POSE_CFG, plucker)
    return [j], [env["pose"](T(plucker))]


def case_flow_match(env):
    j, t = JSched().set_timesteps(7), FlowMatchScheduler().set_timesteps(7)
    return ([j.sigmas, j.timesteps, j.sigma_pairs()],
            [t.sigmas, t.timesteps, t.sigma_pairs()])


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a)


@pytest.mark.parametrize("case", sorted(CASES))
def test_module_matches_jax(env, case):
    with torch.no_grad():
        j, t = CASES[case](env)
    assert len(j) == len(t)
    for i, (a, b) in enumerate(zip(j, t)):
        a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
        assert a.shape == b.shape, (case, i, a.shape, b.shape)
        assert np.isfinite(b).all(), (case, i)
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)
        assert err <= RTOL, (case, i, err)
