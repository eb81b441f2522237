"""int8 / fp8 quantization of the port (``core/quant.py``) against the JAX
package's ``core/quant.py``, in f32 on the CPU: the quantized weights and
scales bit for bit, ``qlinear``, the quantized-layer set of a fusion model
and of both Wan2.2 experts, a quantized tree carried across from its scan
stacks, the 3-step quantized denoise, and the port's int8 drift against
its own bf16 on the JAX drift gate's config."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from fantasy_world_tpu.core import quant as jq
from fantasy_world_tpu.models.fusion.model import init_fusion
from fantasy_world_tpu.pipelines.wan_video import FantasyWorldPipeline as JPipe

from fantasy_world_tpu_torch.convert.from_jax import (fusion_config_from,
                                                      fusion_state_dict)
from fantasy_world_tpu_torch.core import quant as tq
from fantasy_world_tpu_torch.core.params import build, linear
from fantasy_world_tpu_torch.models.fusion.model import FusionModel
from fantasy_world_tpu_torch.pipelines.wan_video import FantasyWorldPipeline
from fantasy_world_tpu_torch.pipelines.wan_video_22 import place_expert
from fantasy_world_tpu_torch.training.lora import init_lora
from fantasy_world_tpu_torch.utils.demo import demo_config
from test_torch_sampler import J_CFG as TINY_CFG
from test_torch_slice import _wake
from test_torch_tea_cache import tiny_conditioning
from test_torch_wan22 import J_CFG as WAN22_CFG

torch.set_num_threads(1)

MODES = ("int8", "fp8")
# qlinear: the same f32 operations in the same order on both sides
QLINEAR_RTOL = 1e-5
# 3 quantized steps, f32 on both sides: an activation that lands on a
# rounding tie may quantize one step apart after f32 summation-order
# differences upstream; relative L2 of the latents
DENOISE_RTOL = 1e-2
# the JAX package's int8 drift contract (tests/test_quant_drift.py)
DRIFT_BOUND = 0.04


def _kernel(rng, k, n):
    return {"kernel": rng.standard_normal((k, n)).astype(np.float32),
            "bias": rng.standard_normal((n,)).astype(np.float32)}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy() if t.element_size() == 1 and \
        t.dtype != torch.int8 else t.numpy()


@pytest.mark.parametrize("mode", MODES)
def test_quantized_weights_bit_equal_to_jax(mode):
    p = _kernel(np.random.default_rng(0), 96, 80)
    p["kernel"][:, 3] = 0.0                       # the 1e-12 scale clamp
    want = jq.quantize_linear_params(
        {k: jnp.asarray(v) for k, v in p.items()}, mode)
    q, s = tq.quantize_weight(torch.from_numpy(p["kernel"].T.copy()), mode)
    assert q.dtype == tq.QDTYPE[mode] and s.dtype == torch.float32
    jk = np.asarray(want["kernel_q" if mode == "int8" else "kernel_f8"]).T
    np.testing.assert_array_equal(_bits(q), jk.view(np.uint8)
                                  if mode == "fp8" else jk)
    np.testing.assert_array_equal(s.numpy(), np.asarray(want["kscale"]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(7, 96), (2, 5, 96)])
def test_qlinear_matches_jax(mode, shape):
    rng = np.random.default_rng(1)
    p = _kernel(rng, 96, 80)
    jp = jq.quantize_linear_params({k: jnp.asarray(v) for k, v in p.items()},
                                   mode)
    dense = torch.nn.Linear(96, 80)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(p["kernel"].T.copy()))
        dense.bias.copy_(torch.from_numpy(p["bias"]))
    layer = tq.QuantLinear.from_linear(dense, mode)
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jq.qlinear(jp, jnp.asarray(x)))
    got = linear(torch.from_numpy(x), layer)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= QLINEAR_RTOL, err


def _quantized_pair(jcfg, seed, mode, min_dim):
    """(the JAX tree quantized, the port's model quantized and holding it,
    the JAX tree's scan stacks quantized)."""
    tree = init_fusion(seed, jcfg, jnp.float32)
    jpipe = JPipe(cfg=jcfg, params={"fusion": tree})
    jpipe.quantize(mode, min_dim=min_dim)
    model = build(lambda: FusionModel(fusion_config_from(jcfg)), device="cpu",
                  dtype=torch.float32)
    n = tq.quantize_model(model, mode, min_dim=min_dim)
    return jpipe, model, n


@pytest.mark.parametrize("which", ["wan21", "wan22_high", "wan22_low"])
def test_quantized_set_equals_jax(which):
    """The layers ``quantize_model`` rewrites are the ones JAX
    ``quantize_tree`` quantizes, by name (the JAX tree carried across names
    its quantized leaves) and by count, for a fusion model and for each
    Wan2.2 expert; every state-dict key is written."""
    jcfg = TINY_CFG if which == "wan21" else WAN22_CFG
    jpipe, model, n = _quantized_pair(jcfg, int(which == "wan22_low"),
                                      "int8", 32)
    sd = fusion_state_dict(jpipe.params["fusion"], model)
    from_jax = {k[:-len(".kscale")] for k in sd if k.endswith(".kscale")}
    assert from_jax == set(tq.quantized_names(model))
    assert n == tq.count_quantized(model) == jq.count_quantized(
        jpipe.params["fusion"]) > 0
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # the excluded tags hold on the port's names
    assert not any(tag in name for name in from_jax
                   for tag in tq.DEFAULT_EXCLUDE)
    assert isinstance(model.dit.patch_embedding, torch.nn.Conv3d)


@pytest.mark.parametrize("mode", MODES)
def test_scan_stacked_tree_carries_across(mode):
    """A quantized scan tree (stacked (L, K, N) kernels, (L, N) scales)
    gives the per-layer tree's state dict bit for bit."""
    jpipe, model, _ = _quantized_pair(TINY_CFG, 0, mode, 32)
    per_layer = fusion_state_dict(jpipe.params["fusion"], model)
    stacked = fusion_state_dict(jpipe.params["fusion"], model,
                                scan=jpipe._scan_params)
    assert set(per_layer) == set(stacked)
    assert any(v.dtype == tq.QDTYPE[mode] for v in stacked.values())
    for k, v in per_layer.items():
        assert v.dtype == stacked[k].dtype and torch.equal(
            _as_bits(v), _as_bits(stacked[k])), k


def _as_bits(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@pytest.mark.parametrize("mode", MODES)
def test_quantized_denoise_matches_jax(mode):
    """3 steps with the heads of one quantized tree, JAX against the port,
    the port loading the tree's scan stacks."""
    jcfg = TINY_CFG
    tree = _wake(init_fusion(0, jcfg, jnp.float32), np.random.default_rng(0))
    jpipe = JPipe(cfg=jcfg, params={"fusion": tree})
    jpipe.quantize(mode, min_dim=32)
    model = build(lambda: FusionModel(fusion_config_from(jcfg)), device="cpu",
                  dtype=torch.float32)
    pipe = FantasyWorldPipeline(model)
    assert pipe.quantize(mode, min_dim=32) == jq.count_quantized(
        jpipe.params["fusion"])
    model.load_state_dict(fusion_state_dict(
        jpipe.params["fusion"], model, scan=jpipe._scan_params), strict=True)
    f, h, w = 2, 64, 64
    cond = tiny_conditioning(f, h, w)
    kw = dict(num_frames=4 * (f - 1) + 1, num_inference_steps=3, seed=7)
    want, _ = jpipe.denoise(*(jnp.asarray(c) for c in cond[:4]), h, w,
                            plucker_fea=jnp.asarray(cond[4]),
                            torch_compat_noise=True, **kw)
    got, pred = pipe.denoise(*(torch.from_numpy(c) for c in cond[:4]), h, w,
                             plucker_fea=torch.from_numpy(cond[4]), **kw)
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert err <= DENOISE_RTOL, err
    assert all(torch.isfinite(v).all() for v in pred.values())


def test_int8_drift_within_the_jax_contract():
    """The port's int8 denoise against its own bf16 one, from the same
    weights and noise, on ``tests/test_quant_drift.py``'s 6-step config:
    relative L2 of the final latents within 4%, and not zero."""
    cfg = demo_config(dim=256, layers=2, start_index=1, agg_dim=128)

    def pipe():
        return FantasyWorldPipeline(build(
            lambda: FusionModel(cfg), device="cpu", dtype=torch.bfloat16,
            generator=torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(7)
    f, h2, w2 = 3, 10, 12
    ctx_p = rng.standard_normal((1, 64, 4096))
    ctx_n = rng.standard_normal((1, 64, 4096)) * 0.3
    clip = rng.standard_normal((1, 257, 1280))
    y = rng.standard_normal((1, 20, f, h2, w2))
    pl = rng.standard_normal((1, f * (h2 // 2) * (w2 // 2), 2048)) * 0.5
    cond = [torch.from_numpy(a).to(torch.bfloat16)
            for a in (ctx_p, ctx_n, clip, y)]
    lats = {}
    for mode in (None, "int8"):
        p = pipe()
        if mode:
            assert p.quantize(mode, min_dim=64) > 0
        lats[mode], _ = p.denoise(
            *cond, h2 * 8, w2 * 8, num_frames=4 * (f - 1) + 1,
            num_inference_steps=6, cfg_scale=5.0, seed=42,
            plucker_fea=torch.from_numpy(pl).to(torch.bfloat16))
    a, b = lats[None].float(), lats["int8"].float()
    assert torch.isfinite(b).all()
    drift = float((b - a).norm() / a.norm())
    assert 0.0 < drift <= DRIFT_BOUND, drift


def test_lora_and_quantization_refuse_each_other():
    cfg = fusion_config_from(TINY_CFG)
    model = build(lambda: FusionModel(cfg), device="cpu", dtype=torch.float32)
    tq.quantize_model(model, "int8", min_dim=32)
    with pytest.raises(ValueError, match="QuantLinear"):
        init_lora(model, 4, generator=torch.Generator().manual_seed(0))
    model = build(lambda: FusionModel(cfg), device="cpu", dtype=torch.float32)
    init_lora(model, 4, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="LoRA"):
        tq.quantize_model(model, "int8", min_dim=32)
    with pytest.raises(ValueError, match="quant mode"):
        tq.quantize_model(model, "int4")


@pytest.mark.parametrize("mode", MODES)
def test_place_expert_quantizes_as_quantize_model(mode):
    """``place_expert``, the order in which ``load_wan22`` readies an
    expert, rewrites the layers ``quantize_model`` does to the same bits;
    without ``quant`` it leaves the expert in float."""
    cfg = fusion_config_from(WAN22_CFG)
    want = build(lambda: FusionModel(cfg), device="cpu", dtype=torch.float32,
                 generator=torch.Generator().manual_seed(3))
    got = build(lambda: FusionModel(cfg), device="cpu", dtype=torch.float32)
    got.load_state_dict(want.state_dict())
    plain = build(lambda: FusionModel(cfg), device="cpu", dtype=torch.float32)
    n = tq.quantize_model(want, mode, min_dim=32)
    assert place_expert(got, "cpu", on_host=False, quant=mode,
                        min_dim=32) is got
    assert n > 0 and tq.quantized_names(got) == tq.quantized_names(want)
    sd_got, sd_want = got.state_dict(), want.state_dict()
    assert list(sd_got) == list(sd_want)
    for name, t in sd_want.items():
        assert sd_got[name].dtype == t.dtype, name
        np.testing.assert_array_equal(_bits(sd_got[name]), _bits(t),
                                      err_msg=name)
    assert place_expert(plain, "cpu", on_host=False) is plain
    assert tq.count_quantized(plain) == 0
