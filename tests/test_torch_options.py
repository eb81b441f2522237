"""The port's remaining single-device model options against the JAX
package, in f32 on the CPU: the 'latent_split' / 'latent_overall' pose
injection (a block and the standalone DiT, at ``tests/test_dit.py``'s tiny
sizes), temporal bicross, the camera-token projector and token assembly,
``joint_forward`` with camera tokens, with ``uncond`` and with the
'latent_overall' adapter (at ``tests/test_torch_modules.py``'s tiny fusion
config), the 'latent_split'-in-fusion refusal, and the latent adapter's
weights through ``from_jax`` and through the reference-layout loader.
Weights: JAX init trees, their zero-initialised adapters and gates given
random values, carried across by ``convert/from_jax.py``."""
import dataclasses

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from fantasy_world_tpu.convert.wan_dit import convert_wan_dit
from fantasy_world_tpu.models.fusion import bicross as jbi
from fantasy_world_tpu.models.fusion.model import (init_fusion,
                                                   joint_forward,
                                                   prepare_scan_params)
from fantasy_world_tpu.models.vggt import aggregator as jagg
from fantasy_world_tpu.models.wan import dit as jdit
from fantasy_world_tpu.ops import rope as jrope

from fantasy_world_tpu_torch.convert.checkpoint import (_dit_permuted_names,
                                                        _permute,
                                                        dit_state_dict_from,
                                                        load_into)
from fantasy_world_tpu_torch.convert.from_jax import (dit_state_dict,
                                                      encoder_config_from,
                                                      fusion_config_from,
                                                      fusion_state_dict)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.fusion.bicross import temporal_slice_plan
from fantasy_world_tpu_torch.models.fusion.model import FusionModel
from fantasy_world_tpu_torch.models.wan.dit import (LatentPoseAdapter, WanDiT,
                                                    WanDiTConfig)
from fantasy_world_tpu_torch.ops import rope
from test_torch_modules import CFG as FUSION_CFG
from test_torch_modules import _wake

torch.set_num_threads(1)

# f32 on both sides: summation order only, relative to the largest
# magnitude of each output
RTOL = 1e-4
METHODS = ("latent_split", "latent_overall")
# tests/test_dit.py's tiny DiT; every block carries a latent adapter
TINY = dict(dim=96, in_dim=8, ffn_dim=128, out_dim=4, text_dim=32,
            freq_dim=64, eps=1e-6, patch_size=(1, 2, 2), num_heads=4,
            num_layers=2, has_image_input=True, camera_adapter_end=2,
            plucker_dim=48)
F_, H_, W_ = 3, 4, 6              # latent frames and token grid
N_PLUCKER = 5                     # Plucker tokens per latent frame


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


T = torch.from_numpy


def _rel_max(got, want):
    a = np.asarray(want, np.float64)
    b = (got.detach().numpy() if isinstance(got, torch.Tensor)
         else np.asarray(got)).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.isfinite(b).all()
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


def _wake_latent(tree, rng, scale=0.05):
    """Random values for the zero-initialised latent k/v projections."""
    for blk in tree["blocks"]:
        for name in ("k_proj", "v_proj"):
            kern = blk["camera"][name]["kernel"]
            blk["camera"][name]["kernel"] = (rng.standard_normal(kern.shape)
                                             * scale).astype(np.float32)
    return tree


@pytest.fixture(scope="module", params=METHODS)
def dit_pair(request):
    jcfg = jdit.WanDiTConfig(**TINY, pose_inject_method=request.param)
    tree = _wake_latent(jdit.init_wan_dit(0, jcfg, jnp.float32),
                        np.random.default_rng(1))
    cfg = encoder_config_from(WanDiTConfig, jcfg)
    m = build(lambda: WanDiT(cfg), device="cpu", dtype=torch.float32)
    m.load_state_dict(dit_state_dict(tree, m), strict=True)
    return jcfg, tree, cfg, m.eval()


def test_latent_pose_block_matches_jax(dit_pair):
    jcfg, tree, cfg, m = dit_pair
    x = _x(2, F_ * H_ * W_, cfg.dim)
    ctx = _x(2, 257 + 20, cfg.dim, seed=1)
    t_mod = _x(2, 6, cfg.dim, seed=2, scale=0.3)
    pl = _x(2, F_ * N_PLUCKER, cfg.plucker_dim, seed=3)
    cos, sin = jrope.cos_sin_half_from_angles(
        jrope.build_angles_3d(cfg.head_dim, F_, H_, W_))
    tcos, tsin = rope.cos_sin_half_from_angles(
        rope.build_angles_3d(cfg.head_dim, F_, H_, W_))
    want = jdit.dit_block_apply(tree["blocks"][0], x, ctx, t_mod, cos, sin,
                                jcfg, plucker_fea=pl, apply_pose=True,
                                plucker_frames=F_)
    plain = jdit.dit_block_apply(tree["blocks"][0], x, ctx, t_mod, cos, sin,
                                 jcfg)
    with torch.no_grad():
        got = m.blocks[0](T(x), T(ctx), T(t_mod), tcos, tsin,
                          plucker_fea=T(pl), apply_pose=True,
                          plucker_frames=F_)
    assert _rel_max(got, want) <= RTOL
    # the woken adapter moves the block
    assert _rel_max(want, plain) > 1e-3
    assert isinstance(m.blocks[0].cross_attn.processor, LatentPoseAdapter)


def test_latent_pose_forward_matches_jax(dit_pair):
    jcfg, tree, cfg, m = dit_pair
    x = _x(2, 4, F_, 2 * H_, 2 * W_)
    y = _x(2, 4, F_, 2 * H_, 2 * W_, seed=1)
    ctx = _x(2, 20, cfg.text_dim, seed=2)
    clip = _x(2, 257, cfg.clip_feature_dim, seed=3)
    pl = _x(2, F_ * N_PLUCKER, cfg.plucker_dim, seed=4)
    ts = np.array([500.0, 120.0], np.float32)
    want = jdit.wan_dit_forward(tree, jcfg, jnp.asarray(x), jnp.asarray(ts),
                                jnp.asarray(ctx), clip_feature=jnp.asarray(
                                    clip), y=jnp.asarray(y),
                                plucker_fea=jnp.asarray(pl))
    with torch.no_grad():
        got = m(T(x), T(ts), T(ctx), clip_feature=T(clip), y=T(y),
                plucker_fea=T(pl))
    assert _rel_max(got, want) <= RTOL


def test_latent_adapter_checkpoint_loads(dit_pair):
    """The latent adapter's reference keys (bias-free k/v projections
    under ``cross_attn.processor``): a reference-layout state dict goes
    through JAX ``convert_wan_dit`` and through ``dit_state_dict_from`` +
    ``load_into`` to the same forward; a configuration naming another
    method refuses it, naming the mismatch, and so does a latent
    configuration given the 'adaln' adapter's tensors."""
    jcfg, _, cfg, m = dit_pair
    sd = m.state_dict()
    keys = [k for k in sd if ".processor." in k]
    assert sorted(keys) == sorted(
        f"blocks.{i}.cross_attn.processor.{n}_proj.weight"
        for i in range(cfg.num_layers) for n in "kv")
    g = torch.Generator().manual_seed(4)
    ref = {k: torch.randn(v.shape, generator=g) * 0.2 for k, v in sd.items()}
    for name, hd in _dit_permuted_names(cfg):
        ref[name] = _permute(ref[name], hd, inverse=True)
    tree = convert_wan_dit({k: v.numpy() for k, v in ref.items()}, jcfg)
    assert set(tree["blocks"][0]["camera"]) == {"k_proj", "v_proj"}
    fresh = build(lambda: WanDiT(cfg), device="cpu", dtype=torch.float32)
    load_into(fresh, dit_state_dict_from(ref, cfg), "dit")
    x, y = _x(1, 4, F_, 2 * H_, 2 * W_), _x(1, 4, F_, 2 * H_, 2 * W_, seed=1)
    ctx, clip = _x(1, 20, cfg.text_dim, seed=2), _x(1, 257, 1280, seed=3)
    pl = _x(1, F_ * N_PLUCKER, cfg.plucker_dim, seed=4)
    ts = np.array([700.0], np.float32)
    want = jdit.wan_dit_forward(tree, jcfg, jnp.asarray(x), jnp.asarray(ts),
                                jnp.asarray(ctx), clip_feature=jnp.asarray(
                                    clip), y=jnp.asarray(y),
                                plucker_fea=jnp.asarray(pl))
    with torch.no_grad():
        got = fresh(T(x), T(ts), T(ctx), clip_feature=T(clip), y=T(y),
                    plucker_fea=T(pl))
    assert _rel_max(got, want) <= RTOL
    adaln_cfg = dataclasses.replace(cfg, pose_inject_method="adaln")
    meta = build(lambda: WanDiT(adaln_cfg), device="meta",
                 dtype=torch.float32)
    with pytest.raises(ValueError, match=r"block 0.*'latent_split or "
                                         r"latent_overall'.*'adaln'"):
        load_into(meta, dit_state_dict_from(ref, cfg), "dit")
    adaln_sd = build(lambda: WanDiT(adaln_cfg), device="cpu",
                     dtype=torch.float32).state_dict()
    with pytest.raises(ValueError, match=r"'adaln'.*pose_inject_method="
                                         + repr(cfg.pose_inject_method)):
        load_into(build(lambda: WanDiT(cfg), device="meta",
                        dtype=torch.float32), adaln_sd, "dit")


@pytest.mark.parametrize("R,T_,S,M", [(5, 3, 12, 7), (6, 3, 8, 4),
                                      (4, 4, 6, 3)])
def test_forward_temporal_matches_jax(R, T_, S, M):
    """Uneven (5 frames over 3 windows: padded slots), even with two
    frames a window, and one frame a window."""
    idx, valid = temporal_slice_plan(R, T_)
    j_idx, j_valid = jbi.temporal_slice_plan(R, T_)
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(valid, j_valid)
    assert valid.all() == (R % T_ == 0)
    bc = FUSION_CFG.bicross
    rng = np.random.default_rng(7)
    p = jbi.init_bicross(3, bc, jnp.float32)
    # random gates and biases, so the zero tokens of the padded slots
    # carry the projections' biases
    p = {k: ({**v, "bias": rng.standard_normal(v["bias"].shape).astype(
        np.float32) * 0.3} if isinstance(v, dict) else
        rng.standard_normal(v.shape).astype(np.float32) * 0.5)
        for k, v in p.items()}
    model = build(lambda: FusionModel(fusion_config_from(FUSION_CFG)),
                  device="meta", dtype=torch.float32)
    tree = init_fusion(0, FUSION_CFG, jnp.float32)
    tree["bicross"] = [p] * FUSION_CFG.num_irg
    mod = model.bicross[0].to_empty(device="cpu")
    sd = fusion_state_dict(tree, model)
    mod.load_state_dict({k[len("bicross.0."):]: v for k, v in sd.items()
                         if k.startswith("bicross.0.")}, strict=True)
    x1 = _x(2, T_ * S, bc.m1_dim, seed=1)
    x2 = _x(2, R * M, bc.m2_dim, seed=2)
    want = jbi.bicross_apply_temporal(p, bc, jnp.asarray(x1),
                                      jnp.asarray(x2), T_, S, R, M)
    with torch.no_grad():
        got = mod.forward_temporal(T(x1), T(x2), T_, S, R, M)
    for g, w in zip(got, want):
        assert _rel_max(g, w) <= RTOL


@pytest.fixture(scope="module")
def fusion():
    tree = _wake(init_fusion(0, FUSION_CFG, jnp.float32),
                 np.random.default_rng(0))
    model = build(lambda: FusionModel(fusion_config_from(FUSION_CFG)),
                  device="cpu", dtype=torch.float32)
    model.load_state_dict(fusion_state_dict(tree, model), strict=True)
    return tree, model.eval()


def test_cam_token_projector_matches_jax(fusion):
    tree, model = fusion
    agg_p, agg = tree["vggt"]["aggregator"], model.vggt.aggregator
    C = FUSION_CFG.vggt.aggregator.embed_dim
    for V in (1, 5, 9):
        cam = _x(2, V, 9, seed=V)
        want = jagg.cam_token_projector(agg_p["cam_token_projector"], cam, C)
        with torch.no_grad():
            got = agg.CamTokenProjector(T(cam))
        assert tuple(got.shape) == (2 * (V + 3) // 4, 1, C)
        assert _rel_max(got, want) <= RTOL
    patches = _x(2, F_, H_, W_, C, seed=11)
    cam = _x(2, 4 * F_ - 3, 9, seed=12)
    jt, jpos = jagg.assemble_tokens(agg_p, FUSION_CFG.vggt.aggregator,
                                    jnp.asarray(patches), jnp.asarray(cam))
    with torch.no_grad():
        tt, tpos = agg.assemble_tokens(T(patches), T(cam))
        plain, _ = agg.assemble_tokens(T(patches))
    assert _rel_max(tt, jt) <= RTOL
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert not torch.equal(tt[:, 0], plain[:, 0])
    assert torch.equal(tt[:, 1:], plain[:, 1:])
    for V in (4, 6, 8):
        with pytest.raises(ValueError, match="V % 4 == 1"):
            agg.CamTokenProjector(torch.zeros(1, V, 9))
        with pytest.raises(Exception):          # JAX's reshape refuses too
            jagg.cam_token_projector(agg_p["cam_token_projector"],
                                     jnp.zeros((1, V, 9)), C)


def _joint_inputs(batch=2):
    d = FUSION_CFG.dit
    return (_x(batch, 16, F_, 2 * H_, 2 * W_),
            np.array([800.0, 800.0][:batch], np.float32),
            _x(batch, 7, d.text_dim, seed=1),
            _x(batch, 257, d.clip_feature_dim, seed=2),
            _x(batch, 20, F_, 2 * H_, 2 * W_, seed=3),
            _x(batch, F_ * H_ * W_, d.plucker_dim, seed=4, scale=0.3))


def _port_joint(model, heads, **kw):
    lat, ts, ctx, clip, y, pl = _joint_inputs()
    tkw = {k: (T(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    with torch.no_grad():
        return model.joint_forward(T(lat), T(ts), T(ctx), T(clip), T(y),
                                   plucker_fea=T(pl),
                                   return_prediction=heads, **tkw)


def _joint_pair(tree, model, cfg, heads, **kw):
    lat, ts, ctx, clip, y, pl = _joint_inputs()
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = joint_forward(tree, prepare_scan_params(tree, cfg), cfg,
                         jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(ctx),
                         jnp.asarray(clip), jnp.asarray(y),
                         plucker_fea=jnp.asarray(pl),
                         return_prediction=heads, **jkw)
    return want, _port_joint(model, heads, **kw)


def _check_joint(want, got):
    assert _rel_max(got[0], want[0]) <= RTOL
    if want[1] is not None:
        assert set(got[1]) == set(want[1])
        for k in want[1]:
            assert _rel_max(got[1][k], want[1][k]) <= RTOL, k


@pytest.mark.parametrize("option", ["camera_token", "uncond"])
def test_joint_forward_option_matches_jax(fusion, option):
    """Camera tokens (V = 4f - 3 pose encodings) and the uncond bicross
    skip, each against JAX, and each moving the noise prediction off the
    plain forward's (the woken bicross gates carry the geometry stream,
    camera slots included, into the video stream)."""
    tree, model = fusion
    kw = ({"camera_token": _x(2, 4 * F_ - 3, 9, seed=5)}
          if option == "camera_token" else {"uncond": True})
    want, got = _joint_pair(tree, model, FUSION_CFG, False, **kw)
    _check_joint(want, got)
    plain = _port_joint(model, False)
    assert _rel_max(got[0], plain[0]) > 1e-3


def test_latent_overall_fusion_matches_jax_and_split_refuses():
    """'latent_overall' in the fusion stack runs as in JAX (whose stack
    passes no latent frame count); 'latent_split' there raises a
    ValueError that says so, where the JAX stack's reshape fails."""
    dit = dataclasses.replace(FUSION_CFG.dit,
                              pose_inject_method="latent_overall")
    cfg = dataclasses.replace(FUSION_CFG, dit=dit)
    tree = init_fusion(0, cfg, jnp.float32)
    for blk in tree["dit"]["blocks"][:cfg.dit.camera_adapter_end]:
        _wake_latent({"blocks": [blk]}, np.random.default_rng(2))
    model = build(lambda: FusionModel(fusion_config_from(cfg)),
                  device="cpu", dtype=torch.float32)
    model.load_state_dict(fusion_state_dict(tree, model), strict=True)
    want, got = _joint_pair(tree, model.eval(), cfg, False)
    _check_joint(want, got)
    split = dataclasses.replace(cfg, dit=dataclasses.replace(
        dit, pose_inject_method="latent_split"))
    model = build(lambda: FusionModel(fusion_config_from(split)),
                  device="cpu", dtype=torch.float32,
                  generator=torch.Generator().manual_seed(0))
    lat, ts, ctx, clip, y, pl = _joint_inputs()
    with pytest.raises(ValueError, match="latent_split.*fusion"):
        model.joint_forward(T(lat), T(ts), T(ctx), T(clip), T(y),
                            plucker_fea=T(pl))
    with torch.no_grad():       # without Plucker features it runs
        out, _ = model.joint_forward(T(lat), T(ts), T(ctx), T(clip), T(y))
    assert torch.isfinite(out).all()
    # the fusion loader names a method mismatch too
    adaln = build(lambda: FusionModel(fusion_config_from(FUSION_CFG)),
                  device="meta", dtype=torch.float32)
    with pytest.raises(ValueError, match=r"block 0.*pose_inject_method="
                                         r"'adaln'"):
        load_into(adaln, fusion_state_dict(tree, build(
            lambda: FusionModel(fusion_config_from(cfg)), device="meta",
            dtype=torch.float32)), "fusion")
