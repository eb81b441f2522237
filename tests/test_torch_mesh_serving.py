"""The serving options of the port on a mesh, in f32 on the CPU, against the
JAX package's one-device runs (``tests/test_multichip.py``,
``tests/test_tea_cache.py``): the fusion model quantized to int8 and fp8
and sharded over spawned gloo ranks (``parallel/sharding.py`` PARAM_RULES
with the quantized weights and scales, ``core/quant.py:qlinear``'s
row-parallel path) against JAX ``joint_forward`` on ``quantize_tree``
params, the TeaCache-gated forward's compute and reuse branches against
JAX ``joint_forward_tea``, the windowed denoise with Ulysses against JAX's
windowed denoise, and -- on the port alone -- the TeaCache denoise cut
after a segment and resumed from its partial state on a mesh, against one
process.

The model is ``_demo_config(dim=256, ...)``, not the JAX tests' dim 64:
the port keeps whole heads per model rank, and dim 64 has one head (dim
256 has two of 128, as ``test_torch_multigpu.py`` takes).
"""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from fantasy_world_tpu_torch.chipcheck.inputs import tea_threshold
from __graft_entry__ import _demo_config
from fantasy_world_tpu.core.quant import quantize_tree
from fantasy_world_tpu.models.fusion.model import (init_fusion,
                                                   joint_forward,
                                                   joint_forward_tea,
                                                   split_trainable)
from fantasy_world_tpu.parallel.sharding import spec_for_path as j_spec
from fantasy_world_tpu.pipelines.wan_video import FantasyWorldPipeline as JPipe

import torch_mesh_workers as workers
from fantasy_world_tpu_torch.convert.from_jax import (fusion_config_from,
                                                      fusion_state_dict)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.fusion.model import FusionModel
from fantasy_world_tpu_torch.parallel import distributed, sharding
from fantasy_world_tpu_torch.pipelines.wan_video import FantasyWorldPipeline
from test_torch_slice import _wake

torch.set_num_threads(1)

# f32 on both sides, one device against a mesh: summation order and the
# collectives' order of addition (the JAX multichip tests' bound). The
# int8 path sums its int32 partials exactly and takes the activation scale
# over the whole row, so a mesh is held to the port's one-process int8
# forward within the same bound, as relative L2: the mesh's q/k norms and
# attention sum in another order, and an activation that lands within
# that of a rounding tie quantizes one step apart (7 of 4096 outputs off
# by up to 3.4e-4 here, relative L2 3.3e-5)
TOL = 2e-4
PRED_TOL = 5e-4
# int8 against JAX: the two packages' f32 forwards differ by ~1e-6 in
# summation order, and an activation that lands that near a rounding tie
# quantizes one step apart (this model: 5.8e-3 max abs, 2.6e-3 relative
# L2, in one process as on a mesh); the int8 contract of
# test_torch_quant.py, relative L2
INT8_JAX_RTOL = 1e-2
F, LH, LW = 2, 8, 8
# the TeaCache denoise: 4 steps; the windowed one: 5 latent frames in
# windows of 3 every 2 -- (0, 3) and (2, 5), each split 2 | 1 over 2 seq
# ranks, a ragged split
TEA_STEPS = 4
WF, WINDOW = 5, (3, 2)
MESHES = {(1, 1, 2): (False, ("int8_qs", "int8_sq", "fp8_qs")),
          (2, 2, 2): (False, ("int8_qs", "fp8_qs", "tea", "tea_denoise")),
          (1, 2, 1): (True, ("tea_denoise", "window"))}


def _cond(rng, f):
    c = {"ctx_pos": rng.standard_normal((1, 16, 4096)) * 0.02,
         "ctx_neg": rng.standard_normal((1, 16, 4096)) * 0.02,
         "c_clip": rng.standard_normal((1, 257, 1280)) * 0.1,
         "c_y": rng.standard_normal((1, 20, f, LH, LW)),
         "c_pl": rng.standard_normal((1, f * (LH // 2) * (LW // 2), 2048))
         * 0.1}
    return {k: v.astype(np.float32) for k, v in c.items()}


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The JAX tree (its zero gates woken), the port's config and state
    dict, the inputs, the TeaCache threshold, and every mesh's outputs."""
    tmp = tmp_path_factory.mktemp("mesh_serving")
    cfg = _demo_config(dim=256, layers=3, start_index=1, agg_dim=64,
                       agg_depth=2)
    params = _wake(init_fusion(0, cfg, jnp.float32),
                   np.random.default_rng(0))
    pcfg = fusion_config_from(cfg)
    port = build(lambda: FusionModel(pcfg), device="cpu",
                 dtype=torch.float32)
    sd = fusion_state_dict(params, port)
    port.load_state_dict(sd)
    torch.save(sd, tmp / "sd.pt")
    thresh, plan = tea_threshold(port.dit, TEA_STEPS)
    assert plan.any() and not plan.all()
    rng = np.random.default_rng(1)
    B = 2
    inp = {"lat": rng.standard_normal((B, 16, F, LH, LW)),
           "y": rng.standard_normal((B, 20, F, LH, LW)),
           "ctx": rng.standard_normal((B, 16, 4096)) * 0.02,
           "clip": rng.standard_normal((B, 257, 1280)) * 0.1,
           "pl": rng.standard_normal((B, F * (LH // 2) * (LW // 2), 2048))
           * 0.1,
           "t": np.full((B,), 500.0)}
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    outs = {}
    for shape, (uly, cases) in MESHES.items():
        files = dict(inp, **_cond(np.random.default_rng(3), F),
                     **{f"w_{k}": v for k, v in _cond(
                         np.random.default_rng(3), WF).items()},
                     grid=np.asarray([F, LH // 2, LW // 2]),
                     fhw=np.asarray([F, LH, LW]),
                     w_fhw=np.asarray([WF, LH, LW]),
                     thresh=np.asarray(thresh), window=np.asarray(WINDOW))
        name = "x".join(map(str, shape))
        np.savez(tmp / f"in_{name}.npz", **files)
        distributed.spawn(workers.serving_cases, int(np.prod(shape)), pcfg,
                          shape, uly, cases, str(tmp / "sd.pt"),
                          str(tmp / f"in_{name}.npz"),
                          str(tmp / f"out_{name}.npz"))
        outs[shape] = np.load(tmp / f"out_{name}.npz")
    # 1.5 GB (the DPT heads at their production width): gone once read
    (tmp / "sd.pt").unlink()
    return {"cfg": cfg, "params": params, "port": port, "inputs": inp,
            "thresh": thresh, "plan": plan, "outs": outs}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def test_quantized_weights_shard_as_jax_rules_say():
    """The quantized weight splits like the float one and its kscale
    follows the bias on a column-parallel layer, stays whole on a
    row-parallel one -- JAX's four ``spec_for_path`` asserts on the
    port's names, beside JAX's own."""
    from jax.sharding import PartitionSpec as P
    assert j_spec("dit/blocks/0/self_attn/q/kernel_q") == P(None, "model")
    assert sharding.spec_for_path("dit.blocks.0.self_attn.q.weight") == \
        ("model", None)
    assert j_spec("dit/blocks/0/self_attn/q/kscale") == P("model")
    assert sharding.spec_for_path("dit.blocks.0.self_attn.q.kscale") == \
        ("model",)
    assert j_spec("dit/blocks/0/ffn/fc2/kernel_q") == P("model", None)
    assert sharding.spec_for_path("dit.blocks.0.ffn.2.weight") == \
        (None, "model")
    assert j_spec("dit/blocks/0/ffn/fc2/kscale") == P()
    assert sharding.spec_for_path("dit.blocks.0.ffn.2.kscale") == ()
    assert sharding.spec_for_path("dit.blocks.0.ffn.0.kscale") == ("model",)
    assert sharding.spec_for_path("dit.blocks.0.cross_attn.o.kscale") == ()


def test_sharded_quantized_model_holds_its_parts():
    """``quantize(); shard(mesh)`` on a 1-rank view of a model split in 2:
    the int8 weight and every kscale are split (by shape), which a walk
    over the parameters alone left whole."""
    from fantasy_world_tpu_torch.core.quant import QuantLinear
    cfg = fusion_config_from(_demo_config(dim=256, layers=3, start_index=1,
                                          agg_dim=64, agg_depth=2))
    pipe = FantasyWorldPipeline(build(lambda: FusionModel(cfg),
                                      device="cpu", dtype=torch.float32))
    pipe.quantize("int8", min_dim=16)
    whole = {k: tuple(v.shape) for k, v in pipe.fusion.state_dict().items()}
    mesh = sharding.Mesh((1, 1, 2), 1, (sharding.Axis(None, 1, 0),
                                        sharding.Axis(None, 1, 0),
                                        sharding.Axis(None, 2, 1)))
    pipe.fusion.shard(mesh)
    blk = pipe.fusion.dit.blocks[0]
    assert isinstance(blk.self_attn.q, QuantLinear)
    d, ffn = cfg.dit.dim, cfg.dit.ffn_dim
    assert tuple(blk.self_attn.q.weight.shape) == (d // 2, d)
    assert tuple(blk.self_attn.q.kscale.shape) == (d // 2,)
    assert blk.self_attn.q.out_features == d // 2
    assert tuple(blk.ffn[0].kscale.shape) == (ffn // 2,)
    assert tuple(blk.ffn[2].weight.shape) == (d, ffn // 2)
    assert tuple(blk.ffn[2].kscale.shape) == (d,)
    parts = pipe.fusion.param_parts
    assert "dit.blocks.0.self_attn.q.kscale" in parts
    assert "dit.blocks.0.ffn.2.kscale" not in parts
    got = {k: tuple(v.shape) for k, v in pipe.fusion.state_dict().items()}
    split = {k for k in got if got[k] != whole[k]}
    assert split == set(parts)


def _jax_quantized_noise(model, mode):
    cfg, params = model["cfg"], model["params"]
    lite, scan = split_trainable(params, cfg)
    lite = quantize_tree(lite, mode, min_dim=16)
    scan = quantize_tree(scan, mode, min_dim=16)
    i = {k: jnp.asarray(v) for k, v in model["inputs"].items()}
    noise, _ = joint_forward(lite, scan, cfg, i["lat"], i["t"], i["ctx"],
                             i["clip"], i["y"], plucker_fea=i["pl"])
    return np.asarray(noise)


@pytest.fixture(scope="module")
def jax_quantized(model):
    return {mode: _jax_quantized_noise(model, mode)
            for mode in ("int8", "fp8")}


@pytest.fixture(scope="module")
def port_int8(model):
    """The port's int8 forward in one process, quantized as the mesh's."""
    m = build(lambda: FusionModel(fusion_config_from(model["cfg"])),
              device="cpu", dtype=torch.float32)
    m.load_state_dict(model["port"].state_dict())
    FantasyWorldPipeline(m).quantize("int8", min_dim=16)
    i = {k: torch.from_numpy(v) for k, v in model["inputs"].items()}
    with torch.no_grad():
        noise, _ = m.joint_forward(i["lat"], i["t"], i["ctx"], i["clip"],
                                   i["y"], plucker_fea=i["pl"])
    return noise.numpy()


CASES = [((1, 1, 2), "int8_qs"), ((1, 1, 2), "int8_sq"),
         ((1, 1, 2), "fp8_qs"), ((2, 2, 2), "int8_qs"),
         ((2, 2, 2), "fp8_qs")]


@pytest.mark.parametrize("shape,case", CASES, ids=[
    f"{c}_{'x'.join(map(str, s))}" for s, c in CASES])
def test_quantized_forward_on_mesh_matches_jax(model, jax_quantized,
                                               port_int8, shape, case):
    """``quantize(); shard(mesh)`` (qs, JAX's order) and ``shard(mesh);
    quantize()`` (sq) give the one-device quantized forward: fp8 JAX's
    within TOL; int8 the port's one process within TOL and JAX's within
    its int8 contract. Before the repair a row-parallel int8 layer dropped
    its kscale and a column-parallel one kept its whole width."""
    got = model["outs"][shape]
    mode = case.split("_")[0]
    assert int(got[f"{case}/layers"]) > 0
    noise, want = got[f"{case}/noise"], jax_quantized[mode]
    if mode == "fp8":
        _close(noise, want)
        return
    one = np.linalg.norm(noise - port_int8) / np.linalg.norm(port_int8)
    assert one <= TOL, one
    err = np.linalg.norm(noise - want) / np.linalg.norm(want)
    assert err <= INT8_JAX_RTOL, err


def test_shard_then_quantize_is_quantize_then_shard(model):
    """A row-parallel part quantized alone would take its absmax over half
    the contraction axis; ``quantize_model`` reduces it over the model
    axis, so the two orders give the same bits."""
    got = model["outs"][(1, 1, 2)]
    np.testing.assert_array_equal(got["int8_qs/noise"], got["int8_sq/noise"])


def test_tea_forward_on_mesh_matches_jax(model):
    """The compute branch from a zero residual and the reuse branch with
    the residual it returned, at 2x2x2 (the residual held as each rank's
    rows and tokens), against JAX ``joint_forward_tea`` on one device."""
    cfg, params = model["cfg"], model["params"]
    lite, scan = split_trainable(params, cfg)
    i = {k: jnp.asarray(v) for k, v in model["inputs"].items()}
    n_tok = F * (LH // 2) * (LW // 2)
    res0 = jnp.zeros((2, n_tok, cfg.dit.dim), jnp.float32)
    args = (lite, scan, cfg, i["lat"], i["t"], i["ctx"], i["clip"], i["y"])
    want_c, res_c = joint_forward_tea(*args, plucker_fea=i["pl"],
                                      skip=jnp.asarray(False), residual=res0)
    want_s, _ = joint_forward_tea(*args, plucker_fea=i["pl"],
                                  skip=jnp.asarray(True), residual=res_c)
    got = model["outs"][(2, 2, 2)]
    _close(got["tea/noise_compute"], want_c)
    _close(got["tea/residual"], res_c)
    _close(got["tea/noise_reuse"], want_s)


@pytest.fixture(scope="module")
def one_process_tea(model):
    """The port's uninterrupted TeaCache denoise in one process (held to
    JAX's by ``test_torch_tea_cache.py``)."""
    c = _cond(np.random.default_rng(3), F)
    lat, pred = FantasyWorldPipeline(model["port"]).denoise(
        *(torch.from_numpy(c[k]) for k in ("ctx_pos", "ctx_neg", "c_clip",
                                          "c_y")),
        8 * LH, 8 * LW, num_frames=4 * (F - 1) + 1,
        num_inference_steps=TEA_STEPS, seed=7,
        plucker_fea=torch.from_numpy(c["c_pl"]),
        tea_cache_l1_thresh=model["thresh"])
    return lat.numpy(), {k: v.numpy() for k, v in pred.items()}


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 1)],
                         ids=["2x2x2", "1x2x1_ulysses"])
def test_tea_denoise_resumed_on_mesh_matches_one_process(model,
                                                         one_process_tea,
                                                         shape):
    """4 steps whose plan skips one, cut after the first segment of 2 and
    resumed from the partial state rank 0 wrote (the whole residual,
    gathered; each rank takes its part back), against one process run
    through without a cut."""
    got = model["outs"][shape]
    lat, pred = one_process_tea
    _close(got["tea_denoise/latents"], lat)
    for k, v in pred.items():
        _close(got[f"tea_denoise/pred/{k}"], v, PRED_TOL)


def test_windowed_denoise_on_mesh_matches_jax(model):
    """2 steps over 5 latent frames in windows of 3 every 2, each window's
    CFG pair through the 1x2x1 Ulysses forward (its 3 frames split 2 | 1),
    against JAX's one-device windowed denoise."""
    c = _cond(np.random.default_rng(3), WF)
    want, pred = JPipe(cfg=model["cfg"], params={"fusion": model["params"]}
                       ).denoise(
        *(jnp.asarray(c[k]) for k in ("ctx_pos", "ctx_neg", "c_clip",
                                      "c_y")),
        8 * LH, 8 * LW, num_frames=4 * (WF - 1) + 1, num_inference_steps=2,
        seed=7, plucker_fea=jnp.asarray(c["c_pl"]),
        sliding_window_size=WINDOW[0], sliding_window_stride=WINDOW[1],
        torch_compat_noise=True)
    assert pred is None
    _close(model["outs"][(1, 2, 1)]["window/latents"], want)
