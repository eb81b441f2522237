"""The port's training path against the JAX package's: the LoRA target set,
the adapted forward, two LoRA steps with the trainer's optimizer, one full
fine-tuning step and the merge, all in f32 at the demo config of
``tests/test_lora.py`` with the same weights, factors and batches."""
import argparse
import dataclasses

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax
import jax.numpy as jnp
import optax

from fantasy_world_tpu.cli.train import _optimizer as jax_optimizer
from fantasy_world_tpu.models.fusion.model import (_segments, init_fusion,
                                                   irg_runs, split_trainable)
from fantasy_world_tpu.training import lora as jlora
from fantasy_world_tpu.training.step import flow_match_loss as jax_loss
from fantasy_world_tpu.training.step import make_train_step as jax_train_step
from fantasy_world_tpu.utils.demo import demo_config as jax_demo_config

from fantasy_world_tpu_torch.cli.train import _optimizer, _synthetic_batches
from fantasy_world_tpu_torch.convert.from_jax import (fusion_config_from,
                                                      fusion_state_dict,
                                                      lora_state_dict)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.fusion.model import FusionModel
from fantasy_world_tpu_torch.ops import flash_attention as fa
from fantasy_world_tpu_torch.training.lora import (init_lora, lora_state,
                                                   make_lora_train_step,
                                                   merge_lora_, target_layers)
from fantasy_world_tpu_torch.training.step import (flow_match_loss,
                                                   make_train_step)
from fantasy_world_tpu_torch.utils.demo import demo_config

torch.set_num_threads(1)

RANK = 4
# f32 on both sides: summation order, and the port's unmerged adapter
# against JAX's merged weights, relative to the largest magnitude
RTOL = 1e-4
# Adam turns a gradient into a step of about +-lr whatever its size, so an
# update is compared in units of lr, where the reference gradient is at
# least ADAM_SAFE = 100 x Adam's eps: there m/(sqrt(v)+eps) is within 1% of
# +-1 and moves by far less than UPDATE_TOL for gradients that agree to
# RTOL. Nearer 0 the direction of a gradient of ~eps amplifies f32
# summation-order noise (measured: a 1e-9 gradient moves its update by
# 0.03 lr); there the update is held to Adam's bound of one lr.
UPDATE_TOL = 1e-3
ADAM_SAFE = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _check_update(name, new, want, old, grad, lr, wd):
    """new/want: the two trainers' parameters after a step from ``old``;
    grad: the reference gradient of the step; wd: the weight decay."""
    def amax(t):
        return float(t.amax()) if t.numel() else 0.0
    safe = grad.abs() >= ADAM_SAFE
    assert amax(((new - want).abs() / lr)[safe]) <= UPDATE_TOL, name
    bound = 1.0 + 1e-3 + wd * old.abs()
    assert amax(((new - old).abs() / lr - bound)[~safe]) <= 0, name


def _wake(params, rng):
    """Random values for the zero-initialised gates (bicross, camera
    adapter) so every branch carries gradient."""
    for b in params["bicross"]:
        for k in ("gamma_m1", "gamma_m2"):
            b[k] = rng.standard_normal(b[k].shape).astype(np.float32) * 0.5
    for blk in params["dit"]["blocks"]:
        if "camera" in blk:
            fc2 = blk["camera"]["v_group2"]["fc2"]
            fc2["kernel"] = rng.standard_normal(
                fc2["kernel"].shape).astype(np.float32) * 0.05
    return params


def _unscan(lite, scan, cfg):
    """(params_lite, scan_params) -> the ``init_fusion`` layout, so a
    trainable tree (or its gradient) converts with ``fusion_state_dict``."""
    def unstack(tree, n):
        return [jax.tree_util.tree_map(lambda a: np.asarray(a[i]), tree)
                for i in range(n)]
    si, ae = cfg.start_index, cfg.dit.camera_adapter_end
    blocks, frame, glob, bic = [], [], [], []
    for seg, (lo, hi) in zip(scan["pcb"], _segments(si, min(ae, si))):
        blocks += unstack(seg, hi - lo)
    for seg, (lo, hi, _, _) in zip(scan["irg"], irg_runs(cfg)):
        blocks += unstack(seg["dit"], hi - lo)
        frame += unstack(seg["frame"], hi - lo)
        glob += unstack(seg["agg"], hi - lo)
        bic += unstack(seg["bicross"], hi - lo)
    vggt = dict(lite["vggt"])
    vggt["aggregator"] = dict(vggt["aggregator"], frame_blocks=frame,
                              global_blocks=glob)
    return {"dit": dict(lite["dit"], blocks=blocks), "vggt": vggt,
            "bicross": bic}


def small_heads(cfg):
    """The demo config with DPT heads of 32 features (the demo keeps the
    production 256 / (256, 512, 1024, 1024): 380M parameters, which the
    loss never reaches and which only weight decay moves)."""
    return dataclasses.replace(cfg, vggt=dataclasses.replace(
        cfg.vggt, dpt_features=32, dpt_out_channels=(16, 32, 64, 64)))


def _make_setup():
    cfg = small_heads(jax_demo_config(dim=32, layers=2, start_index=1,
                                      agg_dim=32))
    params = _wake(init_fusion(0, cfg, jnp.float32),
                   np.random.default_rng(0))
    lite, scan = split_trainable(params, cfg)
    batches = _synthetic_batches(argparse.Namespace(seed=0, mesh_data=1),
                                 "cpu")
    tb = [next(batches) for _ in range(2)]
    jb = [{k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
               else jnp.float32(v)) for k, v in b.items()} for b in tb]
    return {"cfg": cfg, "params": params, "lite": lite, "scan": scan,
            "torch_batches": tb, "jax_batches": jb}


@pytest.fixture(scope="module")
def setup():
    return _make_setup()


def _port_model(setup):
    model = build(lambda: FusionModel(fusion_config_from(setup["cfg"])),
                  device="cpu", dtype=torch.float32)
    model.load_state_dict(fusion_state_dict(setup["params"], model),
                          strict=True)
    return model


def _jax_lora(setup, up_std=0.0):
    lora = jlora.init_lora(1, setup["scan"], rank=RANK, dtype=jnp.float32)
    if up_std:
        rng = np.random.default_rng(2)
        lora = {k: {"down": e["down"],
                    "up": jnp.asarray(rng.standard_normal(e["up"].shape)
                                      * up_std, jnp.float32)}
                for k, e in lora.items()}
    return lora


def _port_lora(setup, lora, alpha=1.0):
    model = _port_model(setup)
    init_lora(model, RANK, generator=torch.Generator().manual_seed(0),
              alpha=alpha)
    state = lora_state(model)
    with torch.no_grad():
        for name, t in lora_state_dict(lora, model).items():
            state[name].copy_(t)
    return model


def test_lora_targets_match_jax(setup):
    """12 linears per DiT block, the JAX set; the camera adapter (port:
    cross_attn.processor) and the bicross 'cross_attn' are not targets;
    the base is frozen and the fp32 island stays f32."""
    model = _port_model(setup)
    jax_names = set(lora_state_dict(_jax_lora(setup), model))
    factors = init_lora(model, RANK,
                        generator=torch.Generator().manual_seed(0))
    names = set(lora_state(model))
    assert names == jax_names
    assert len(names) == 2 * 12 * setup["cfg"].dit.num_layers
    assert len(factors) == len(names)
    assert not any("processor" in n or n.startswith(("bicross", "vggt"))
                   for n in names)
    assert {n for n, _ in target_layers(model)} == {
        n.rsplit(".lora.", 1)[0] for n in names}
    assert all(not p.requires_grad for n, p in model.named_parameters()
               if ".lora." not in n)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in factors)
    assert model.vggt.time_embedding[0].weight.dtype == torch.float32
    for name, t in lora_state(model).items():
        if name.endswith(".up"):
            assert not t.any()


def test_lora_forward_matches_jax(setup):
    """Nonzero factors carried across: the port's unmerged adapters equal
    joint_forward on apply_lora's merged weights."""
    from fantasy_world_tpu.models.fusion.model import joint_forward
    alpha = 2.0
    lora = _jax_lora(setup, up_std=0.1)
    model = _port_lora(setup, lora, alpha)
    tb, jb = setup["torch_batches"][0], setup["jax_batches"][0]
    args = ("clean_latents", "timestep", "context", "clip_feature", "y")
    want, _ = joint_forward(setup["lite"],
                            jlora.apply_lora(setup["scan"], lora, alpha),
                            setup["cfg"], *(jb[k] for k in args),
                            plucker_fea=jb["plucker_fea"])
    with torch.no_grad():
        got, _ = model.joint_forward(*(tb[k] for k in args),
                                     plucker_fea=tb["plucker_fea"])
        base, _ = _port_model(setup).joint_forward(
            *(tb[k] for k in args), plucker_fea=tb["plucker_fea"])
    assert _rel(got.numpy(), want) <= RTOL
    assert _rel(base.numpy(), want) > 100 * RTOL     # the adapters act


def _jax_lora_steps(setup, up_std):
    """Two steps of the JAX LoRA trainer with the CLI's optimizer (warm-up
    1: lr 0 then lr) from factors with up ~ N(0, up_std): losses, factor
    gradients and factors after each."""
    opt = jax_optimizer(argparse.Namespace(lr=1e-3, warmup=1,
                                           weight_decay=1e-4))
    lora = _jax_lora(setup, up_std)
    state = opt.init(lora)
    frozen = (setup["lite"], setup["scan"])
    step = jax.jit(jlora.make_lora_train_step(setup["cfg"], opt,
                                              remat=False))

    @jax.jit
    def grads(lo, batch):
        return jax.value_and_grad(lambda l: jax_loss(
            setup["lite"], jlora.apply_lora(setup["scan"], l),
            setup["cfg"], **batch))(lo)

    out = {"lora0": lora, "loss": [], "grads": [], "lora": []}
    for batch in setup["jax_batches"]:
        loss, g = grads(lora, batch)
        lora, state, step_loss = step(lora, state, frozen, batch)
        assert float(step_loss) == pytest.approx(float(loss), rel=1e-6)
        out["loss"].append(float(loss))
        out["grads"].append(g)
        out["lora"].append(lora)
    return out


@pytest.fixture(scope="module")
def jax_lora_run(setup):
    """From JAX's init_lora: up = 0."""
    return _jax_lora_steps(setup, 0.0)


@pytest.fixture(scope="module")
def jax_lora_run_up(setup):
    """From nonzero up factors, so down has a gradient too."""
    return _jax_lora_steps(setup, 0.1)


def _two_lora_steps(setup, ref, remat, zero_up):
    """The port's two LoRA steps from ``ref``'s factors, held to ``ref``:
    losses, both factors' gradients and updates; the base stays frozen.
    With ``zero_up`` down's gradient is exactly 0 in both trainers."""
    model = _port_lora(setup, ref["lora0"])
    trainable = lora_state(model)
    opt, sched = _optimizer(argparse.Namespace(lr=1e-3, warmup=1,
                                               weight_decay=1e-4),
                            list(trainable.values()))
    step = make_lora_train_step(model, opt, sched, remat=remat)
    base = {n: p.clone() for n, p in model.named_parameters()
            if ".lora." not in n}
    fa.reset_launch_counts()
    start = {n: p.detach().clone() for n, p in trainable.items()}
    prev = dict(start)
    for i, batch in enumerate(setup["torch_batches"]):
        loss = float(step(batch))
        assert loss == pytest.approx(ref["loss"][i], rel=RTOL)
        want_g = lora_state_dict(ref["grads"][i], model)
        want_p = lora_state_dict(ref["lora"][i], model)
        for name, p in trainable.items():
            if zero_up and name.endswith(".down"):
                # up = 0 through both steps: down's gradient is exactly 0
                assert not p.grad.any() and not want_g[name].any(), name
            else:
                assert want_g[name].any(), name
                assert _rel(p.grad, want_g[name]) <= RTOL, name
            _check_update(name, p.detach(), want_p[name], prev[name],
                          want_g[name], 1e-3, 1e-4)
            if i == 0:                                # lr 0 on step 0
                assert torch.equal(p.detach(), prev[name]), name
            prev[name] = p.detach().clone()
    for part in (".up",) if zero_up else (".up", ".down"):
        assert any(not torch.equal(p.detach(), start[n])
                   for n, p in trainable.items() if n.endswith(part)), part
    for n, p in model.named_parameters():             # frozen base
        if ".lora." not in n:
            assert torch.equal(p, base[n]), n
    assert not any(fa.LAUNCHES.values())               # plain versions


@pytest.mark.parametrize("remat", [False, True])
def test_lora_two_steps_match_jax(setup, jax_lora_run, remat):
    _two_lora_steps(setup, jax_lora_run, remat, zero_up=True)


@pytest.mark.parametrize("remat", [False, True])
def test_lora_two_steps_nonzero_up_match_jax(setup, jax_lora_run_up, remat):
    """Both factors learn: down's gradient and update are held to JAX's
    as up's are."""
    _two_lora_steps(setup, jax_lora_run_up, remat, zero_up=False)


def test_full_finetune_step_matches_jax(setup):
    """One full fine-tuning step (constant lr, large weight decay): loss,
    every gradient, every updated parameter -- including the geometry
    heads, which the loss does not reach and which only decay."""
    lr, wd = 1e-3, 0.1
    cfg, lite, scan = setup["cfg"], setup["lite"], setup["scan"]
    jb, tb = setup["jax_batches"][0], setup["torch_batches"][0]
    opt = optax.adamw(lr, weight_decay=wd)
    trainable = (lite, scan)
    loss_ref, g = jax.jit(jax.value_and_grad(
        lambda tr: jax_loss(tr[0], tr[1], cfg, **jb)))(trainable)
    new, _, _ = jax.jit(jax_train_step(cfg, opt, remat=False))(
        trainable, opt.init(trainable), jb)

    model = _port_model(setup)
    want_g = fusion_state_dict(_unscan(*g, cfg), model)
    want_p = fusion_state_dict(_unscan(*new, cfg), model)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    params = dict(model.named_parameters())
    opt_t = torch.optim.AdamW(list(params.values()), lr=lr, weight_decay=wd,
                              eps=1e-8)
    loss = float(make_train_step(model, opt_t, remat=True)(tb))
    assert loss == pytest.approx(float(loss_ref), rel=RTOL)
    assert set(params) == set(want_g)
    untouched = 0
    for name, p in params.items():
        if not want_g[name].any():
            untouched += 1
            assert not p.grad.any(), name
            # decay only: p (1 - lr wd), in both trainers
            torch.testing.assert_close(p.detach(), old[name] * (1 - lr * wd),
                                       rtol=1e-6, atol=0)
        else:
            assert _rel(p.grad, want_g[name]) <= RTOL, name
        _check_update(name, p.detach(), want_p[name], old[name],
                      want_g[name], lr, wd)
    assert untouched > 0                # the heads are in the optimizer


def test_merge_matches_jax(setup):
    """merge_lora_ (in place) equals merge_lora_into_scan and leaves plain
    layers behind."""
    lora = _jax_lora(setup, up_std=0.1)
    model = _port_lora(setup, lora, alpha=3.0)
    merge_lora_(model)
    assert not lora_state(model)
    merged = jlora.merge_lora_into_scan(setup["scan"], lora, alpha=3.0)
    want = fusion_state_dict(_unscan(setup["lite"], merged, setup["cfg"]),
                             model)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, t in want.items():
        torch.testing.assert_close(got[name], t, rtol=1e-6, atol=1e-6)
    x = setup["torch_batches"][0]
    with torch.no_grad():
        loss = flow_match_loss(model, **x)
    assert torch.isfinite(loss)


def test_demo_config_matches_jax():
    jcfg = jax_demo_config(dim=64, layers=3, start_index=1, agg_dim=32)
    assert demo_config(dim=64, layers=3, start_index=1, agg_dim=32) == \
        fusion_config_from(jcfg)


def test_train_launch_count_contract(monkeypatch):
    """chip_smoke's expected training launch counts are the kernels one
    LoRA step with per-block recompute takes: recorded by route and head
    dim at the reduced widths it checks on the card (every stats forward,
    dq and dk/dv at D 64, 96 and 128), and (2 x (88, 80, 48)) stats
    forwards plus 216 dq and 216 dk/dv (120 at D 128, 48 at 96, 48 at 64)
    per step at full size, less the last bicross's geometry-side backward
    (its output feeds only the heads): 215 dq and 215 dk/dv, 47 at D 96."""
    from fantasy_world_tpu_torch.chipcheck.common import to_device
    from fantasy_world_tpu_torch.chipcheck.inputs import (small_configs,
                                                          train_batches)
    from fantasy_world_tpu_torch.chipcheck.launches import (
        expected_train_launches)
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    seen = {k: 0 for k in fa.LAUNCHES}
    forward, backward = fa._forward, fa.flash_attention_backward

    def count_forward(q, k, v, scale, stats):
        assert stats                               # the Function's forward
        seen[fa.route(q.shape[2], q.shape[3], k.shape[1]) + "_stats"] += 1
        return forward(q, k, v, scale, stats)

    def count_backward(q, k, v, o, lse2, do, scale):
        d = fa.kernel_dim(q.shape[2], q.shape[3], k.shape[1])
        seen[f"bwd_dq_{d}"] += 1
        seen[f"bwd_dkv_{d}"] += 1
        return backward(q, k, v, o, lse2, do, scale)

    monkeypatch.setattr(fa, "_forward", count_forward)
    monkeypatch.setattr(fa, "flash_attention_backward", count_backward)
    fcfg, _ = small_configs()
    model = build(lambda: FusionModel(fcfg), device="cpu",
                  dtype=torch.float32,
                  generator=torch.Generator().manual_seed(0))
    factors = init_lora(model, 2, generator=torch.Generator().manual_seed(1))
    opt = torch.optim.AdamW(factors, lr=1e-3)
    batch = to_device(train_batches(fcfg.dit, 256, 384, 21,
                                    1, seed=0)[0], "cpu")
    loss = make_lora_train_step(model, opt, remat=True)(batch)
    assert torch.isfinite(loss)
    assert seen == expected_train_launches(fcfg, 1)
    assert all(v for k, v in seen.items() if k not in fa.ROUTES)
    full = expected_train_launches(FusionConfig(), 2)
    assert full == dict({k: 0 for k in fa.LAUNCHES},
                        generic_stats=2 * 2 * 88, onekv_stats=2 * 2 * 80,
                        d64_stats=2 * 2 * 48, bwd_dq_128=240, bwd_dq_96=94,
                        bwd_dq_64=96, bwd_dkv_128=240, bwd_dkv_96=94,
                        bwd_dkv_64=96)
