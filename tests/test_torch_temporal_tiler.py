"""The port's temporal tiler against the JAX package, in f32 on the CPU:
the window plan, the blend ramps, the tiled forward of a toy function that
mixes frames, and the Wan2.1 sliding-window denoise at the tiny fusion
config of tests/test_torch_slice.py (the same weights, conditioning and
torch-seeded noise), with the options it refuses."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from __graft_entry__ import _demo_config
from fantasy_world_tpu.models.fusion.model import init_fusion
from fantasy_world_tpu.pipelines import temporal_tiler as jtt
from fantasy_world_tpu.pipelines.wan_video import FantasyWorldPipeline as JPipe

from fantasy_world_tpu_torch.convert.from_jax import (fusion_config_from,
                                                      fusion_state_dict)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.fusion.model import FusionModel
from fantasy_world_tpu_torch.pipelines import temporal_tiler as tt
from fantasy_world_tpu_torch.pipelines.wan_video import FantasyWorldPipeline
from test_torch_slice import _conditioning, _wake

torch.set_num_threads(1)

# the toy forward: f32 on both sides, a few sums; the denoise: f32 through
# 3 DiT blocks and 2 VGGT block pairs per window, 2 steps, relative to the
# largest magnitude
TOY_RTOL = 1e-6
RTOL = 1e-3


@pytest.mark.parametrize("T,size,stride", [(21, 11, 10), (21, 8, 4),
                                           (5, 2, 1), (7, 7, 7), (9, 4, 3)])
def test_window_plan_and_masks_match_jax(T, size, stride):
    plan = tt.window_plan(T, size, stride)
    assert plan == jtt.window_plan(T, size, stride)
    assert plan[0][0] == 0 and plan[-1][1] == T
    border = size - stride
    for t0, t1 in plan:
        for left, right in ((t0 == 0, t1 == T), (False, False)):
            np.testing.assert_array_equal(
                tt.build_1d_mask(t1 - t0, left, right, border),
                jtt.build_1d_mask(t1 - t0, left, right, border))


def test_tiled_forward_of_a_frame_mixing_function():
    """Each window's output mixes its frames (a running sum over time) and
    the pass-through context, so the blend weights show."""
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 3, 9, 2, 2)).astype(np.float32)
    y = rng.standard_normal((2, 4, 9, 2, 2)).astype(np.float32)
    ctx = rng.standard_normal((2, 5)).astype(np.float32)

    def jfn(latents, y, ctx, scale):
        return (jnp.cumsum(latents, axis=2) * scale + y[:, :3]
                + ctx[:, :1, None, None, None])

    def tfn(latents, y, ctx, scale):
        return (torch.cumsum(latents, dim=2) * scale + y[:, :3]
                + ctx[:, :1, None, None, None])
    want = jtt.temporal_tiled_forward(
        jfn, {"latents": jnp.asarray(lat), "y": jnp.asarray(y),
              "ctx": jnp.asarray(ctx)}, 4, 3, scale=0.5)
    got = tt.temporal_tiled_forward(
        tfn, {"latents": torch.from_numpy(lat), "y": torch.from_numpy(y),
              "ctx": torch.from_numpy(ctx)}, 4, 3, scale=0.5)
    assert got.dtype == torch.float32 and tuple(got.shape) == lat.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOY_RTOL,
                               atol=TOY_RTOL)
    whole = tfn(torch.from_numpy(lat), torch.from_numpy(y),
                torch.from_numpy(ctx), 0.5)
    assert not torch.allclose(got, whole)


@pytest.fixture(scope="module")
def pipes():
    cfg = _demo_config(dim=64, layers=3, start_index=1, agg_dim=64)
    params = _wake(init_fusion(0, cfg, jnp.float32),
                   np.random.default_rng(0))
    model = build(lambda: FusionModel(fusion_config_from(cfg)), device="cpu",
                  dtype=torch.float32)
    model.load_state_dict(fusion_state_dict(params, model), strict=True)
    return JPipe(cfg=cfg, params={"fusion": params}), \
        FantasyWorldPipeline(model)


@pytest.mark.parametrize("size,stride", [(2, 1), (3, 3)])
def test_windowed_denoise_matches_jax(pipes, size, stride):
    """2 steps over 3 latent frames: windows of 2 with stride 1 (two
    windows, blended), and one window over all of them."""
    jpipe, pipe = pipes
    f, h, w = 3, 64, 64
    nf = 4 * (f - 1) + 1
    cond = _conditioning(f, h, w)
    kw = dict(num_frames=nf, num_inference_steps=2, seed=7,
              sliding_window_size=size, sliding_window_stride=stride)
    jl, jpred = jpipe.denoise(*(jnp.asarray(c) for c in cond[:4]), h, w,
                              plucker_fea=jnp.asarray(cond[4]),
                              torch_compat_noise=True, **kw)
    calls = []
    tl, tpred = pipe.denoise(*(torch.from_numpy(c) for c in cond[:4]), h, w,
                             plucker_fea=torch.from_numpy(cond[4]),
                             progress_callback=lambda *a: calls.append(a),
                             **kw)
    assert jpred is None and tpred is None
    assert calls == [(1, 2), (2, 2)]
    a = np.asarray(jl, np.float64)
    assert np.abs(tl.numpy() - a).max() / np.abs(a).max() <= RTOL


@pytest.mark.parametrize("option", [{"tea_cache_l1_thresh": 0.1},
                                    {"segment_size": 1},
                                    {"gen_ckpt_path": "partial.npz"}])
def test_windowed_denoise_refuses_options(pipes, option):
    _, pipe = pipes
    cond = _conditioning(3, 64, 64)
    with pytest.raises(ValueError, match="sliding_window_size"):
        pipe.denoise(*(torch.from_numpy(c) for c in cond[:4]), 64, 64,
                     num_frames=9, num_inference_steps=2,
                     sliding_window_size=2, **option)
