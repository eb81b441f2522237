"""TeaCache and the segmented, resumable denoise of the port against the
JAX package, in f32 on the CPU: the drift schedule and the skip plan, the
plans of a fusion model and of the Wan2.2 experts, the gated forward, the
TeaCache denoise with its progress calls (Wan2.1, and Wan2.2 across the
expert boundary), and on the port alone: segmented equals unsegmented,
a run cut after its first segment resumes to the uninterrupted result, a
TeaCache run ignores a checkpoint without a residual, and the file is gone
at the end."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax
import jax.numpy as jnp

from fantasy_world_tpu.models.fusion.model import (init_fusion,
                                                   joint_forward_tea,
                                                   prepare_scan_params)
from fantasy_world_tpu.pipelines import tea_cache as jtc
from fantasy_world_tpu.pipelines import wan_video_22 as jw22
from fantasy_world_tpu.pipelines.wan_video import FantasyWorldPipeline as JPipe
from fantasy_world_tpu.schedulers import FlowMatchScheduler as JSched

from fantasy_world_tpu_torch.convert.from_jax import (fusion_config_from,
                                                      fusion_state_dict)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.fusion.model import FusionModel
from fantasy_world_tpu_torch.pipelines import tea_cache as tc
from fantasy_world_tpu_torch.pipelines import wan_video_22 as w22
from fantasy_world_tpu_torch.pipelines.wan_video import (FantasyWorldPipeline,
                                                         segment_ends)
from test_torch_sampler import J_CFG
from test_torch_slice import _wake
import test_torch_wan22 as t22

torch.set_num_threads(1)

# f32 on both sides through 3 DiT blocks, 2 VGGT block pairs, the heads
# and 4 Euler steps: summation order, relative to the largest magnitude
RTOL = 1e-4
# the random tiny-width modulations drift by ~0.5-1.0 a step, where the
# 480P polynomial gives 1e4-3e5: a threshold of 3e5 makes plans that both
# skip and compute (4 steps: compute, skip, compute, compute)
THRESH = 3e5
STEPS = 4
F, H, W = 2, 64, 64
NF = 4 * (F - 1) + 1


def tiny_conditioning(f, h, w, batch=1):
    """Random encoder outputs in the widths of ``test_torch_sampler``'s
    tiny config: contexts, CLIP tokens, y, Plucker features."""
    d, rng = J_CFG.dit, np.random.default_rng(1)

    def randn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return (randn(batch, 16, d.text_dim), randn(batch, 16, d.text_dim,
                                                scale=0.1),
            randn(batch, 257, d.clip_feature_dim),
            randn(batch, 20, f, h // 8, w // 8),
            randn(batch, f * (h // 16) * (w // 16), d.plucker_dim,
                  scale=0.1))


@pytest.fixture(scope="module")
def wan21():
    tree = _wake(init_fusion(0, J_CFG, jnp.float32), np.random.default_rng(0))
    model = build(lambda: FusionModel(fusion_config_from(J_CFG)),
                  device="cpu", dtype=torch.float32)
    model.load_state_dict(fusion_state_dict(tree, model), strict=True)
    return {"tree": tree, "model": model, "cond": tiny_conditioning(F, H, W)}


def _rel_max(got, want):
    a, b = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


@pytest.mark.parametrize("model_id", sorted(jtc.TEACACHE_COEFFICIENTS))
def test_drift_and_plan_equal_jax(model_id):
    t_mods = np.random.default_rng(3).standard_normal(
        (50, 1, 6, 32)).astype(np.float32)
    t_mods *= np.linspace(1.0, 1.3, 50, dtype=np.float32)[:, None, None,
                                                          None]
    drift = tc.modulation_drift_schedule(t_mods)
    np.testing.assert_array_equal(drift,
                                  jtc.modulation_drift_schedule(t_mods))
    for thresh in (0.01, 0.05, 0.3, 2.0):
        np.testing.assert_array_equal(
            tc.plan_skips(drift, thresh, model_id),
            jtc.plan_skips(drift, thresh, model_id))
    with pytest.raises(ValueError, match="TeaCache model id"):
        tc.plan_skips(drift, 0.05, "no-such-model")


def test_skip_schedules_equal_jax(wan21):
    ts = JSched().set_timesteps(50).timesteps
    want = jtc.compute_skip_schedule(wan21["tree"]["dit"], J_CFG.dit, ts,
                                     THRESH)
    got = tc.compute_skip_schedule(wan21["model"].dit, ts, THRESH)
    assert got.any() and not got[0] and not got[-1]
    np.testing.assert_array_equal(got, want)
    trees = [init_fusion(s, t22.J_CFG, jnp.float32) for s in (0, 1)]
    n_high = int((ts > 900).sum())
    want = jtc.compute_skip_schedule_dual(
        trees[0]["dit"], trees[1]["dit"], t22.J_CFG.dit, ts, n_high, THRESH)
    got = tc.compute_skip_schedule_dual(
        *(t22._fusion_module(tree).dit for tree in trees), ts, n_high, THRESH)
    assert got.any()
    np.testing.assert_array_equal(got, want)


def test_tea_forward_gating_matches_jax(wan21):
    """skip=False equals joint_forward and returns the stack's output minus
    its input; skip=True with that residual gives the same noise again;
    both against JAX ``joint_forward_tea``."""
    tree, model = wan21["tree"], wan21["model"]
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((2, 16, F, H // 8, W // 8)).astype(np.float32)
    ctx, _, clip, y, pl = tiny_conditioning(F, H, W, batch=2)
    t = np.full((2,), 500.0, np.float32)
    n_tok = F * (H // 16) * (W // 16)
    args = [torch.from_numpy(a) for a in (lat, t, ctx, clip, y)]
    res0 = torch.zeros((2, n_tok, J_CFG.dit.dim))
    with torch.no_grad():
        ref, _ = model.joint_forward(*args, plucker_fea=torch.from_numpy(pl))
        noise_c, res_c = model.joint_forward_tea(
            *args, plucker_fea=torch.from_numpy(pl), skip=False,
            residual=res0)
        noise_s, res_s = model.joint_forward_tea(
            *args, plucker_fea=torch.from_numpy(pl), skip=True,
            residual=res_c)
    assert torch.equal(noise_c, ref)
    assert res_c.abs().max() > 0 and res_s is res_c
    assert _rel_max(noise_s.numpy(), noise_c.numpy()) <= 1e-5
    scan = prepare_scan_params(tree, J_CFG)
    jargs = [jnp.asarray(a) for a in (lat, t, ctx, clip, y)]
    for skip, res, got in ((False, res0, (noise_c, res_c)),
                           (True, res_c, (noise_s, res_s))):
        want = joint_forward_tea(tree, scan, J_CFG, *jargs,
                                 plucker_fea=jnp.asarray(pl),
                                 skip=jnp.asarray(skip),
                                 residual=jnp.asarray(res.numpy()))
        for g, w in zip(got, want):
            assert _rel_max(g.numpy(), w) <= RTOL


def test_tea_segmented_denoise_matches_jax(wan21):
    """TeaCache at THRESH, in segments of 2 with a partial-state file: the
    latents, the prediction and the progress calls against JAX's."""
    cond = wan21["cond"]
    plan = tc.compute_skip_schedule(wan21["model"].dit,
                                    JSched().set_timesteps(STEPS).timesteps,
                                    THRESH)
    assert plan.any()
    kw = dict(num_frames=NF, num_inference_steps=STEPS, seed=7,
              tea_cache_l1_thresh=THRESH, segment_size=2)
    calls = {"jax": [], "torch": []}
    want, wpred = JPipe(cfg=J_CFG, params={"fusion": wan21["tree"]}).denoise(
        *(jnp.asarray(c) for c in cond[:4]), H, W,
        plucker_fea=jnp.asarray(cond[4]), torch_compat_noise=True,
        progress_callback=lambda *a: calls["jax"].append(a), **kw)
    got, gpred = FantasyWorldPipeline(wan21["model"]).denoise(
        *(torch.from_numpy(c) for c in cond[:4]), H, W,
        plucker_fea=torch.from_numpy(cond[4]),
        progress_callback=lambda *a: calls["torch"].append(a), **kw)
    assert calls["torch"] == calls["jax"] == [(2, 4), (3, 4), (4, 4)]
    assert _rel_max(got.numpy(), want) <= RTOL
    for k in wpred:
        assert _rel_max(gpred[k].numpy(), wpred[k]) <= RTOL, k


def test_wan22_tea_segments_match_jax(monkeypatch):
    """The dual-expert TeaCache denoise in segments of 3 over 4 steps with
    the boundary after the second: no segment spans it, and the latents
    and the progress calls equal JAX's."""
    t, rng = t22.J_CFG, np.random.default_rng(0)
    trees = {h: t22._wake(init_fusion(s, t, jnp.float32), rng)
             for h, s in ((True, 0), (False, 1))}
    models = {h: t22._fusion_module(tree) for h, tree in trees.items()}
    rng = np.random.default_rng(4)
    ctx_p, ctx_n = (rng.standard_normal((1, 512, 32)).astype(np.float32)
                    for _ in range(2))
    y = rng.standard_normal((1, 20, 21, t22.H // 8, t22.W // 8)).astype(
        np.float32)
    ts = JSched().set_timesteps(STEPS).timesteps
    boundary = float(ts[2]) + 1.0            # 2 high steps, 2 low ones
    kw = dict(num_frames=81, num_inference_steps=STEPS, seed=3,
              tea_cache_l1_thresh=THRESH, segment_size=3)
    calls = {"jax": [], "torch": []}
    jden = jw22.DualModelDenoiser(cfg=t, params_high=trees[True],
                                  params_low=trees[False],
                                  timestep_boundary=boundary)
    want, _ = jden.denoise(jnp.asarray(ctx_p), jnp.asarray(ctx_n),
                           jnp.asarray(y), t22.H, t22.W,
                           progress_callback=lambda *a: calls["jax"].append(
                               a), **kw)
    jnoise = np.asarray(jax.random.normal(
        jax.random.PRNGKey(3), (1, 16, 21, t22.H // 8, t22.W // 8)))
    monkeypatch.setattr(w22.DualModelDenoiser, "generate_noise",
                        staticmethod(lambda shape, seed: torch.tensor(
                            jnoise).reshape(shape)))
    den = w22.DualModelDenoiser(models[True], models[False], boundary)
    got, _ = den.denoise(torch.from_numpy(ctx_p), torch.from_numpy(ctx_n),
                         torch.from_numpy(y), t22.H, t22.W,
                         progress_callback=lambda *a: calls["torch"].append(
                             a), **kw)
    # segments of 3 cut at the boundary (2), then the last scan step (3)
    assert calls["torch"] == calls["jax"] == [(2, 4), (3, 4), (4, 4)]
    plan = tc.compute_skip_schedule_dual(models[True].dit, models[False].dit,
                                         ts, 2, THRESH)
    assert plan.any()
    assert _rel_max(got.numpy(), want) <= RTOL


def test_segment_ends():
    assert segment_ends(0, 49, 10) == {10, 20, 30, 40, 49}
    assert segment_ends(20, 49, 10) == {30, 40, 49}
    assert segment_ends(0, 5, 2, cuts=(3,)) == {2, 3, 5}
    assert segment_ends(0, 5, 100, cuts=(3, 9)) == {3, 5}
    assert segment_ends(5, 5, 1) == set()


class _Cut(Exception):
    pass


def _run(model, cond, **kw):
    return FantasyWorldPipeline(model).denoise(
        *(torch.from_numpy(c) for c in cond[:4]), H, W, num_frames=NF,
        num_inference_steps=STEPS, seed=7,
        plucker_fea=torch.from_numpy(cond[4]), **kw)


@pytest.mark.parametrize("tea", [False, True])
def test_segmented_resume_equals_uninterrupted(wan21, tmp_path, tea):
    """Segmented equals unsegmented bit for bit; a run cut after its first
    segment leaves the partial state, and the next call resumes from it
    (reporting its start first) to the same result; the file is gone at
    the end."""
    model, cond = wan21["model"], wan21["cond"]
    opt = {"tea_cache_l1_thresh": THRESH} if tea else {}
    whole, wpred = _run(model, cond, **opt)
    seg, spred = _run(model, cond, segment_size=1, **opt)
    assert torch.equal(seg, whole)
    assert all(torch.equal(spred[k], wpred[k]) for k in wpred)
    path = str(tmp_path / "partial.npz")

    def cut(done, total):
        raise _Cut
    with pytest.raises(_Cut):
        _run(model, cond, segment_size=2, gen_ckpt_path=path,
             progress_callback=cut, **opt)
    with np.load(path) as data:
        assert int(data["step"]) == 2 and int(data["n_scan"]) == STEPS - 1
        assert ("residual" in data.files) == tea
    calls = []
    resumed, rpred = _run(model, cond, segment_size=1, gen_ckpt_path=path,
                          progress_callback=lambda *a: calls.append(a),
                          **opt)
    assert calls == [(2, 4), (3, 4), (4, 4)]      # from step 2, not 1
    assert torch.equal(resumed, whole)
    assert all(torch.equal(rpred[k], wpred[k]) for k in wpred)
    assert not (tmp_path / "partial.npz").exists()
    assert not (tmp_path / "partial.npz.tmp").exists()


def test_tea_run_ignores_a_checkpoint_without_residual(wan21, tmp_path):
    model, cond = wan21["model"], wan21["cond"]
    path = str(tmp_path / "partial.npz")

    def cut(done, total):
        raise _Cut
    with pytest.raises(_Cut):
        _run(model, cond, segment_size=2, gen_ckpt_path=path,
             progress_callback=cut)
    calls = []
    got, _ = _run(model, cond, segment_size=1, gen_ckpt_path=path,
                  tea_cache_l1_thresh=THRESH,
                  progress_callback=lambda *a: calls.append(a))
    want, _ = _run(model, cond, tea_cache_l1_thresh=THRESH)
    assert calls == [(1, 4), (2, 4), (3, 4), (4, 4)]   # from step 0
    assert torch.equal(got, want)
    assert not (tmp_path / "partial.npz").exists()
