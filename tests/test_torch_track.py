"""The port's VGGT track head against JAX ``models/vggt/track.py``, in f32
on the CPU, one test per function at ``tests/test_track.py``'s tiny
``TrackConfig``: ``bilinear_sample`` (both padding modes), the two
embeddings, the correlation pyramid, the update former, the tracker loop
and ``track_head_forward`` over the feature-only DPT. The port's weights
go to JAX through JAX's own converters (``convert_update_former``,
``convert_tracker``, ``convert_dpt_head``), so the port's parameter names
are the checkpoint's; JAX's ``init_track_head`` tree comes across through
``convert/from_jax.py``, with the VGGT model's ``head_prediction``."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax
import jax.numpy as jnp

from fantasy_world_tpu.convert.track import (convert_tracker,
                                             convert_update_former)
from fantasy_world_tpu.convert.vggt import convert_dpt_head
from fantasy_world_tpu.models.fusion import bicross as jbi
from fantasy_world_tpu.models.fusion.model import FusionConfig as JFusionCfg
from fantasy_world_tpu.models.fusion.model import init_fusion
from fantasy_world_tpu.models.vggt import heads as jheads
from fantasy_world_tpu.models.vggt import model as jvm
from fantasy_world_tpu.models.vggt import track as jt
from fantasy_world_tpu.models.vggt.aggregator import AggregatorConfig
from fantasy_world_tpu.models.wan.dit import WanDiTConfig

from fantasy_world_tpu_torch.convert.from_jax import (
    encoder_config_from, fusion_config_from, fusion_state_dict,
    track_head_state_dict)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.fusion.model import FusionModel
from fantasy_world_tpu_torch.models.vggt import heads as pheads
from fantasy_world_tpu_torch.models.vggt import track as pt

torch.set_num_threads(1)

# f32 on both sides: the primitives are exact up to summation order
# (absolute, on values of order 1-10); the learned stacks relative to the
# largest magnitude of each output
ATOL = 1e-5
RTOL = 1e-4
J_CFG = jt.TrackConfig(latent_dim=8, hidden_size=16, corr_levels=2,
                       corr_radius=1, iters=2, depth=2, num_heads=8,
                       num_virtual_tracks=4)
CFG = encoder_config_from(pt.TrackConfig, J_CFG)
J_DPT = jheads.DPTHeadConfig(dim_in=32, patch_size=4,
                             features=J_CFG.latent_dim,
                             out_channels=(8, 8, 8, 8),
                             intermediate_layer_idx=(3, 2, 1, 0),
                             pos_embed=False, down_ratio=2,
                             feature_only=True)
DPT = encoder_config_from(pheads.DPTHeadConfig, J_DPT)


def _jit(fn, **static):
    """The JAX function compiled once with its configs bound: eager, the
    tracker loop dispatches op by op (~20 s on the CPU)."""
    return jax.jit(functools.partial(fn, **static))


def _rel(got, want):
    a, b = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


def _np_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _port(ctor, seed):
    return build(ctor, device="cpu", dtype=torch.float32,
                 generator=torch.Generator().manual_seed(seed)).eval()


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_bilinear_sample_matches_jax(mode):
    """In-range, boundary and out-of-range coordinates."""
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    coords = rng.uniform(-2.5, 12.5, (2, 13, 2)).astype(np.float32)
    coords[0, :4] = [[0, 0], [10, 8], [10.5, 3], [-1, 8]]
    want = np.asarray(jt.bilinear_sample(jnp.asarray(img),
                                         jnp.asarray(coords), mode))
    got = pt.bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords),
                             mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_embeddings_match_jax():
    """``get_2d_embedding`` (linear frequencies, interleaved) and the
    sin/cos position table (host f64, identical)."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(-30, 30, (2, 7, 2)).astype(np.float32)
    want = np.asarray(jt.get_2d_embedding(jnp.asarray(xy), 4))
    got = pt.get_2d_embedding(torch.from_numpy(xy), 4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(pt.get_2d_sincos_pos_embed(28, (5, 9)),
                                  jt.get_2d_sincos_pos_embed(28, (5, 9)))


def test_corr_pyramid_matches_jax():
    """Odd sizes pool to floor (13x17 -> 6x8 -> 3x4); each level sampled
    in its window, zeros outside."""
    rng = np.random.default_rng(2)
    B, S, C, H, W, N = 1, 3, 8, 13, 17, 5
    fmaps = rng.standard_normal((B, S, C, H, W)).astype(np.float32)
    targets = rng.standard_normal((B, S, N, C)).astype(np.float32)
    coords = rng.uniform(-1, 16, (B, S, N, 2)).astype(np.float32)
    jpyr = jt.build_corr_pyramid(jnp.asarray(fmaps), 3)
    ppyr = pt.build_corr_pyramid(torch.from_numpy(fmaps), 3)
    for a, b in zip(jpyr, ppyr):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=ATOL)
    want = np.asarray(jt.corr_pyramid_sample(
        jpyr, jnp.asarray(targets), jnp.asarray(coords), 2))
    got = pt.corr_pyramid_sample(ppyr, torch.from_numpy(targets),
                                 torch.from_numpy(coords), 2).numpy()
    assert got.shape == (B, S, N, 3 * 25)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_update_former_matches_jax():
    m = _port(lambda: pt.EfficientUpdateFormer(CFG), 0)
    p = convert_update_former(_np_sd(m), depth=CFG.depth)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, CFG.transformer_dim)).astype(
        np.float32)
    want = _jit(jt.update_former_apply, cfg=J_CFG)(p, x=jnp.asarray(x))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= RTOL


def test_tracker_predict_matches_jax():
    """Both iterations' coordinates, vis and conf; frame 0 stays at the
    query."""
    m = _port(lambda: pt.TrackerPredictor(CFG), 1)
    p = convert_tracker(_np_sd(m), depth=CFG.depth)
    rng = np.random.default_rng(4)
    B, S, HH, WW, N = 1, 3, 8, 8, 5
    fmaps = rng.standard_normal((B, S, CFG.latent_dim, HH, WW)).astype(
        np.float32)
    queries = rng.uniform(1, 13, (B, N, 2)).astype(np.float32)
    jc, jv, jconf = _jit(jt.tracker_predict, cfg=J_CFG)(
        p, query_points=jnp.asarray(queries), fmaps=jnp.asarray(fmaps))
    with torch.no_grad():
        c, v, conf = m(torch.from_numpy(queries), torch.from_numpy(fmaps))
    assert len(c) == len(jc) == CFG.iters
    for a, b in zip(jc, c):
        assert _rel(b.numpy(), a) <= RTOL
        np.testing.assert_allclose(b[:, 0].numpy(), queries, atol=1e-5)
    assert _rel(v.numpy(), jv) <= RTOL
    assert _rel(conf.numpy(), jconf) <= RTOL


def _tokens(rng, B=1, S=2, ph=4, pw=4):
    return [rng.standard_normal((B, S, 5 + ph * pw, 32)).astype(np.float32)
            for _ in range(4)]


def test_track_head_forward_matches_jax():
    """The feature-only DPT (down_ratio 2, no position embedding) and the
    tracker: the feature maps, then every output of ``track_head_forward``;
    the port's TrackHead weights through JAX ``convert_dpt_head`` and
    ``convert_tracker``."""
    m = _port(lambda: pt.TrackHead(CFG, DPT), 2)
    assert not hasattr(m.feature_extractor.scratch, "output_conv2")
    sd = _np_sd(m)
    p = {"feature_extractor": convert_dpt_head(sd, "feature_extractor"),
         "tracker": convert_tracker(sd, "tracker", depth=CFG.depth)}
    rng = np.random.default_rng(5)
    toks = _tokens(rng)
    queries = rng.uniform(2, 10, (1, 3, 2)).astype(np.float32)
    jtoks = [jnp.asarray(t) for t in toks]
    ptoks = [torch.from_numpy(t) for t in toks]
    want_f = _jit(jheads.dpt_head_forward, cfg=J_DPT, spatial_hw=(4, 4),
                  patch_start_idx=5)(p["feature_extractor"],
                                     aggregated_tokens=jtoks)
    with torch.no_grad():
        got_f = m.feature_extractor(ptoks, (4, 4), 5)
        assert tuple(got_f.shape) == (1, 5, CFG.latent_dim, 8, 8)
        assert _rel(got_f.numpy(), want_f) <= RTOL
        c, v, conf = m(ptoks, (4, 4), 5, torch.from_numpy(queries))
    jc, jv, jconf = _jit(jt.track_head_forward, cfg=J_CFG, dpt_cfg=J_DPT,
                         spatial_hw=(4, 4), patch_start_idx=5)(
        p, aggregated_tokens=jtoks, query_points=jnp.asarray(queries))
    assert c[-1].shape == (1, 5, 3, 2) and v.shape == conf.shape == (1, 5, 3)
    for a, b in zip(jc, c):
        assert _rel(b.numpy(), a) <= RTOL
    assert _rel(v.numpy(), jv) <= RTOL
    assert _rel(conf.numpy(), jconf) <= RTOL


def test_jax_track_head_tree_carries_across():
    """JAX ``init_track_head``'s tree (split q/k/v kernels) into the port's
    TrackHead (packed ``in_proj_weight``, ``virual_tracks``): the same
    outputs."""
    p = jt.init_track_head(0, J_CFG, J_DPT, jnp.float32)
    m = build(lambda: pt.TrackHead(CFG, DPT), device="cpu",
              dtype=torch.float32)
    sd = track_head_state_dict(p, m)
    assert sd["tracker.updateformer.time_blocks.0.attn.in_proj_weight"
              ].shape == (48, 16)
    assert "tracker.updateformer.virual_tracks" in sd
    m.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(6)
    toks = _tokens(rng)
    queries = rng.uniform(2, 10, (1, 4, 2)).astype(np.float32)
    jc, jv, jconf = _jit(jt.track_head_forward, cfg=J_CFG, dpt_cfg=J_DPT,
                         spatial_hw=(4, 4), patch_start_idx=5)(
        p, aggregated_tokens=[jnp.asarray(t) for t in toks],
        query_points=jnp.asarray(queries))
    with torch.no_grad():
        c, v, conf = m([torch.from_numpy(t) for t in toks], (4, 4), 5,
                       torch.from_numpy(queries))
    assert _rel(c[-1].numpy(), jc[-1]) <= RTOL
    assert _rel(v.numpy(), jv) <= RTOL and _rel(conf.numpy(), jconf) <= RTOL


def test_vggt_head_prediction_with_track_matches_jax(monkeypatch):
    """``enable_track``: the fusion model's VGGT holds a track head over
    its feature-only DPT (``track``, ``track_dpt``: the tracker's latent
    width, down ratio 2, no position embedding); ``head_prediction`` with
    query points returns "track", "vis" and "track_conf" as JAX's, the
    whole fusion tree carried across by ``fusion_state_dict``; without
    query points the track head does not run. Both packages' ``track``
    property gives the tiny ``TrackConfig`` here: with the production one
    (4 iterations of a random 6-block former) the coordinates feed back
    through the sampling, and f32 rounding (7e-8 relative after one
    iteration) grows ~40x an iteration."""
    assert jvm.VGGTConfig().track == J_CFG.__class__()
    assert pt.TrackConfig() == CFG.__class__()
    monkeypatch.setattr(jvm.VGGTConfig, "track", property(lambda s: J_CFG))
    from fantasy_world_tpu_torch.models.vggt import model as pvm
    monkeypatch.setattr(pvm.VGGTConfig, "track", property(lambda s: CFG))
    jcfg = JFusionCfg(
        dit=WanDiTConfig(dim=64, ffn_dim=128, num_heads=4, num_layers=2,
                         text_dim=32, clip_feature_dim=64, plucker_dim=48),
        vggt=jvm.VGGTConfig(embed_dim=32, wan_dim=64,
                            dpt_layer_idx=(1, 1, 0, 0), dpt_features=16,
                            dpt_out_channels=(8, 16, 32, 32),
                            camera_num_heads=4, enable_track=True,
                            aggregator=AggregatorConfig(embed_dim=32,
                                                        depth=2,
                                                        num_heads=4)),
        bicross=jbi.BicrossConfig(m1_dim=64, m2_dim=32, hidden=48,
                                  num_heads=4),
        start_index=1)
    tree = init_fusion(0, jcfg, jnp.float32)
    cfg = fusion_config_from(jcfg)
    assert cfg.vggt.enable_track and cfg.vggt.track == CFG
    assert dataclasses.asdict(cfg.vggt.track_dpt) == {
        k: (tuple(v) if isinstance(v, list) else v)
        for k, v in dataclasses.asdict(jcfg.vggt.track_dpt).items()}
    fusion = build(lambda: FusionModel(cfg), device="cpu",
                   dtype=torch.float32)
    fusion.load_state_dict(fusion_state_dict(tree, fusion), strict=True)
    rng = np.random.default_rng(7)
    B, S, ph, pw = 1, 2, 4, 4
    toks = [rng.standard_normal((B, S, 5 + ph * pw, 64)).astype(np.float32)
            for _ in range(2)]
    queries = rng.uniform(4, 60, (B, 3, 2)).astype(np.float32)
    want = _jit(jvm.head_prediction, cfg=jcfg.vggt, spatial_hw=(ph, pw),
                patch_start_idx=5)(
        tree["vggt"], aggregated_tokens=[jnp.asarray(t) for t in toks],
        query_points=jnp.asarray(queries))
    with torch.no_grad():
        ptoks = [torch.from_numpy(t) for t in toks]
        got = fusion.vggt.head_prediction(ptoks, (ph, pw), 5,
                                          torch.from_numpy(queries))
        plain = fusion.vggt.head_prediction(ptoks, (ph, pw), 5)
    assert set(got) == set(want) and {"track", "vis", "track_conf"} <= set(
        got)
    assert set(plain) == set(got) - {"track", "vis", "track_conf"}
    assert tuple(got["track"].shape) == (B, 5, 3, 2)
    for k in want:
        assert _rel(got[k].numpy(), want[k]) <= RTOL, k
