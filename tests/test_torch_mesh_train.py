"""The port's mesh trainer against the JAX package, on spawned gloo ranks
on the CPU in f32 (one spawn per world size, 2, 4 and 8, running every
case of that size; their results are made once and shared between the
test processes):

  * each differentiable collective's input gradient against the
    one-process gradient of the same function, from random upstream
    gradients (``parallel/distributed.py``);
  * dq, dk, dv of the port's Ulysses and ring attention against
    ``jax.grad`` of the JAX package's on its virtual mesh, on the even,
    ragged-heads, cross, ``tail_pad`` and ``pure_pad`` splits of
    ``test_torch_ring.py`` (the JAX ``tests/test_ulysses.py:155`` and
    ``tests/test_ring.py:80`` checks, on the port's splits);
  * two AdamW steps of the train step with per-block recompute at 1x1x2
    (LoRA and full fine-tuning), 2x1x1 (B = 2, a sigma per sample), 1x2x1
    with the k/v gather and with Ulysses, 1x4x1 with the ring and 2x2x2,
    against JAX's one-device ``jax.value_and_grad`` and the JAX trainer's
    optimizer at ``test_torch_training.py``'s config with 2 heads in every
    attention (so the model splits, and 4 seq ranks take the ring), on 5
    latent frames (ragged over 2 and 4 seq ranks): the loss, every
    trainable tensor's gradient gathered whole, the parameters after each
    step;
  * ``chip_smoke.py``'s expected launches of a small_mesh_train step on
    every rank, against the attention calls the step makes on the CPU;
  * LoRA on split layers: the factor rules against the layers' splits,
    and a seeded init on a split model against the unsplit one.
"""
import argparse
import dataclasses
import fcntl
import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU, 8 virtual devices)
import jax
import jax.numpy as jnp
import optax

from fantasy_world_tpu.cli.train import _optimizer as jax_optimizer
from fantasy_world_tpu.models.fusion.model import init_fusion, split_trainable
from fantasy_world_tpu.parallel.ring import ring_attention as jax_ring
from fantasy_world_tpu.parallel.sharding import make_mesh
from fantasy_world_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from fantasy_world_tpu.training import lora as jlora
from fantasy_world_tpu.training.step import flow_match_loss as jax_loss
from fantasy_world_tpu.utils.demo import demo_config as jax_demo_config

from fantasy_world_tpu_torch.chipcheck.mesh import SMALL_MESH_TRAIN_RUNS
import torch_mesh_workers as workers
from test_torch_ring import CASES as RING_CASES
from test_torch_training import _check_update, _unscan, _wake, small_heads
from fantasy_world_tpu_torch.convert.from_jax import (fusion_config_from,
                                                      fusion_state_dict,
                                                      lora_state_dict)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.fusion.model import FusionModel
from fantasy_world_tpu_torch.parallel import sharding
from fantasy_world_tpu_torch.parallel.distributed import spawn
from fantasy_world_tpu_torch.schedulers.flow_match import FlowMatchScheduler
from fantasy_world_tpu_torch.training.lora import init_lora, lora_state

torch.set_num_threads(1)

ATTN_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4
RANK = 4
LR = 1e-3
# the attention splits (test_torch_ring.py's cases but its plain gather)
ATTN_CASES = ("even", "ragged_heads", "cross", "tail_pad", "pure_pad")
# tag: (mesh, Ulysses, LoRA or full fine-tuning, batch)
TRAIN = {
    "1x1x2_lora": ((1, 1, 2), False, "lora", 1),
    "1x1x2_full": ((1, 1, 2), False, "full", 1),
    "2x1x1_lora": ((2, 1, 1), False, "lora", 2),
    "1x2x1_gather_lora": ((1, 2, 1), False, "lora", 1),
    "1x2x1_ulysses_lora": ((1, 2, 1), True, "lora", 1),
    "1x4x1_ring_lora": ((1, 4, 1), True, "lora", 1),
    "2x2x2_full": ((2, 2, 2), False, "full", 2),
}
WORLDS = (2, 4, 8)
# chip_smoke.py's small_mesh_train launch counts are checked at its model
# on 6 latent frames of 4 x 6 tokens (the CPU's plain versions, counted)
CONTRACT_GEOMETRY = (64, 96, 21)


def _shared(tmp_path_factory, name, make):
    """``make()`` once for every test process of this run (pytest-xdist
    workers share the parent of their temporary roots), saved there."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"mesh_train_{name}.pt"
    with open(root / f"mesh_train_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            torch.save(make(), path)
    return torch.load(path, weights_only=False)


# ---------------------------------------------------------------------------
# the model, its batches and the JAX references
# ---------------------------------------------------------------------------

def mesh_config():
    """test_torch_training.py's config, every attention at 2 heads."""
    cfg = small_heads(jax_demo_config(dim=32, layers=2, start_index=1,
                                      agg_dim=32))
    return dataclasses.replace(
        cfg, dit=dataclasses.replace(cfg.dit, num_heads=2),
        vggt=dataclasses.replace(cfg.vggt, aggregator=dataclasses.replace(
            cfg.vggt.aggregator, num_heads=2)),
        bicross=dataclasses.replace(cfg.bicross, num_heads=2))


def _batches(B, n=2, frames=5, seed=3):
    """``n`` numpy batches of ``B`` samples at 5 x 8 x 8 latents; B > 1
    draws a schedule index (sigma, timestep) per sample."""
    sched = FlowMatchScheduler().set_timesteps(1000)
    rng = np.random.default_rng(seed + B)
    out = []
    for _ in range(n):
        idx = rng.integers(0, len(sched.sigmas), size=B)
        sig = np.asarray([float(sched.sigmas[i]) for i in idx], np.float32)
        b = {"clean_latents": rng.standard_normal((B, 16, frames, 8, 8)),
             "noise": rng.standard_normal((B, 16, frames, 8, 8)),
             "sigma": (np.float32(sig[0]) if B == 1
                       else sig.reshape(B, 1, 1, 1, 1)),
             "timestep": np.asarray([float(sched.timesteps[i]) for i in idx]),
             "context": rng.standard_normal((B, 16, 4096)) * 0.02,
             "clip_feature": rng.standard_normal((B, 257, 1280)) * 0.02,
             "y": rng.standard_normal((B, 20, frames, 8, 8)),
             "plucker_fea": rng.standard_normal(
                 (B, frames * 16, 2048)) * 0.02}
        out.append({k: np.asarray(v, np.float32) for k, v in b.items()})
    return out


def _to_torch(b):
    return {k: (float(v) if v.ndim == 0 else torch.from_numpy(v))
            for k, v in b.items()}


def _opt_args(mode):
    return {"lr": LR, "warmup": 1,
            "weight_decay": 0.1 if mode == "full" else 1e-4}


def _setup():
    """The JAX parameters (zero gates woken), the LoRA factors (up drawn
    nonzero, so both factors learn), the port's model and its state dict,
    and the batches."""
    cfg = mesh_config()
    params = _wake(init_fusion(0, cfg, jnp.float32),
                   np.random.default_rng(0))
    lite, scan = split_trainable(params, cfg)
    lora = jlora.init_lora(1, scan, rank=RANK, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    lora = {k: {"down": e["down"],
                "up": jnp.asarray(rng.standard_normal(e["up"].shape) * 0.1,
                                  jnp.float32)} for k, e in lora.items()}

    def port():
        return build(lambda: FusionModel(fusion_config_from(cfg)),
                     device="cpu", dtype=torch.float32)
    model, lora_model = port(), port()
    init_lora(lora_model, RANK, generator=torch.Generator().manual_seed(0))
    sd = fusion_state_dict(params, model)
    return {"cfg": cfg, "lite": lite, "scan": scan, "lora": lora,
            "model": model, "lora_model": lora_model, "sd": sd,
            "lora_sd": lora_state_dict(lora, lora_model),
            "batches": {B: _batches(B) for B in (1, 2)}}


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _samples(b):
    """A batch's samples, each a batch of one (sigma a scalar)."""
    B = len(b["clean_latents"])
    sigma = np.broadcast_to(b["sigma"].reshape(-1), (B,))
    return [{k: jnp.asarray(sigma[j] if k == "sigma" else v[j:j + 1])
             for k, v in b.items()} for j in range(B)]


def _jax_steps(setup, mode):
    """For each batch size, two steps of the JAX package's objective under
    the JAX trainer's optimizer: the loss and gradient of each
    (``jax.value_and_grad`` on one device; a batch of B equal samples as
    the mean of its samples' -- the objective is their mean -- so one
    compile serves both sizes) and the trainable tensors after it, in the
    port's names. {B: {key: value}}."""
    cfg, lite, scan = setup["cfg"], setup["lite"], setup["scan"]
    opt = jax_optimizer(argparse.Namespace(**_opt_args(mode)))
    if mode == "lora":
        start = setup["lora"]

        def loss_fn(t, b):
            return jax_loss(lite, jlora.apply_lora(scan, t), cfg, **b)

        def names(t):
            return lora_state_dict(t, setup["lora_model"])
    else:
        start = (lite, scan)
        params = dict(setup["model"].named_parameters())

        def loss_fn(t, b):
            return jax_loss(t[0], t[1], cfg, **b)

        def names(t):
            return {n: v for n, v in fusion_state_dict(
                _unscan(*t, cfg), setup["model"]).items() if n in params}
    value_grad = jax.jit(jax.value_and_grad(loss_fn))
    mean = jax.jit(lambda *ts: jax.tree_util.tree_map(
        lambda *x: sum(x) / len(x), *ts))

    @jax.jit
    def update(g, state, t):
        updates, state = opt.update(g, state, t)
        return optax.apply_updates(t, updates), state

    runs = {}
    for B, batches in setup["batches"].items():
        tr, state, out = start, opt.init(start), {}
        for i, b in enumerate(batches):
            loss, g = mean(*(value_grad(tr, one) for one in _samples(b)))
            tr, state = update(g, state, tr)
            out[f"loss{i}"] = float(loss)
            out.update({f"grad{i}/{n}": t for n, t in names(g).items()})
            out.update({f"param{i}/{n}": t for n, t in names(tr).items()})
        runs[B] = out
    return runs


@pytest.fixture(scope="module")
def jax_train(setup, tmp_path_factory):
    return {mode: _shared(tmp_path_factory, f"jax_{mode}",
                          lambda m=mode: _jax_steps(setup, m))
            for mode in ("lora", "full")}


def _attn_inputs(name, world):
    Lq, Lk, H, D, _, sizes = RING_CASES[name]
    rng = np.random.default_rng(40 + ATTN_CASES.index(name))
    q, k, v = (rng.standard_normal((2, L, H, D)).astype(np.float32)
               for L in (Lq, Lk, Lk))
    g = rng.standard_normal((2, Lq, H, D)).astype(np.float32)
    return {"q": q, "k": k, "v": v, "g": g,
            "kv_sizes": None if sizes is None else sizes[world]}


def _jax_attention_grads(world):
    """dq, dk, dv of sum(o * g) through the JAX package's ring and Ulysses
    on its virtual mesh of ``world`` seq devices."""
    mesh = make_mesh(data=1, seq=world)
    out = {}
    for name in ATTN_CASES:
        a = _attn_inputs(name, world)
        g = jnp.asarray(a["g"])
        for kind, fn in (("ring", jax_ring), ("ulysses", jax_ulysses)):
            grads = jax.jit(jax.grad(
                lambda q, k, v: (fn(q, k, v, mesh=mesh) * g).sum(),
                argnums=(0, 1, 2)))(*(jnp.asarray(a[x]) for x in "qkv"))
            for x, t in zip(("dq", "dk", "dv"), grads):
                out[f"{name}_{kind}/{x}"] = np.asarray(t)
    return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _spec(world, setup):
    spec = {"collectives": world in (2, 4)}
    if world in (2, 4):
        spec["attention"] = {
            f"{name}_{kind}": dict(_attn_inputs(name, world), kind=kind)
            for name in ATTN_CASES for kind in ("ring", "ulysses")}
    spec["train"] = {
        tag: {"shape": shape, "ulysses": uly, "mode": mode, "batch": B}
        for tag, (shape, uly, mode, B) in TRAIN.items()
        if int(np.prod(shape)) == world}
    spec["contract"] = {
        "x".join(map(str, shape)): {"shape": shape, "ulysses": uly,
                                    "mode": modes[-1],
                                    "geometry": CONTRACT_GEOMETRY}
        for shape, uly, modes in SMALL_MESH_TRAIN_RUNS
        if int(np.prod(shape)) == world}
    spec["model"] = {
        "cfg": fusion_config_from(setup["cfg"]), "sd": setup["sd"],
        "lora": setup["lora_sd"], "rank": RANK,
        "opt": {mode: _opt_args(mode) for mode in ("lora", "full")},
        "batches": {B: [_to_torch(b) for b in bs]
                    for B, bs in setup["batches"].items()}}
    return spec


def _run_world(world, setup, tmp_path_factory):
    def make():
        tmp = tmp_path_factory.mktemp(f"mesh_train{world}")
        spec = _spec(world, setup)
        torch.save(spec, tmp / "spec.pt")
        spawn(workers.mesh_train_cases, world, str(tmp / "spec.pt"),
              str(tmp / "out.pt"))
        return torch.load(tmp / "out.pt", weights_only=False)
    return _shared(tmp_path_factory, f"world{world}", make)


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = _run_world(world, setup, tmp_path_factory)
        return cache[world]
    return get


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _expected_collective(kind, world):
    inp = workers.collective_inputs(world)
    sizes, starts = inp["sizes"], np.cumsum([0] + inp["sizes"])
    total = {k: sum(inp[k]) for k in ("g", "gs")}
    out = []
    for r in range(world):
        part = slice(starts[r], starts[r + 1])
        if kind == "sum_identity":
            out.append(inp["g"][0])
        elif kind in ("sum_sum", "sum_grad"):
            out.append(total["g"])
        elif kind == "gather_slice":
            out.append(inp["gs"][0][:, part])
        elif kind == "gather_reduce_scatter":
            out.append(total["gs"][:, part])
        elif kind == "all_to_all":
            out.append(np.stack([inp["ga"][j][r] for j in range(world)]))
        elif kind == "local_columns":
            g = np.zeros_like(inp["xc"])
            g[:, 2 * r:2 * r + 2] = inp["gc"][r]
            out.append(g)
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["sum_identity", "sum_sum", "gather_slice",
                                  "gather_reduce_scatter", "all_to_all",
                                  "sum_grad", "local_columns"])
def test_collective_gradients(worlds, world, kind):
    """Each rank's input gradient equals the one-process gradient of the
    same function of all ranks' inputs (a sum over ranks of their losses,
    or, for the backwards that assume ranks going on alike, one loss)."""
    got = worlds(world)[f"coll/{kind}"]
    want = _expected_collective(kind, world)
    assert len(got) == len(want) == world
    for r, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                   err_msg=f"rank {r}")
    if kind == "local_columns":
        # summed over the ranks, the whole upstream gradient
        np.testing.assert_allclose(
            sum(got), np.concatenate(
                workers.collective_inputs(world)["gc"], axis=1), rtol=1e-6)


# ---------------------------------------------------------------------------
# Ulysses and the ring
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_attention(tmp_path_factory):
    return {w: _shared(tmp_path_factory, f"jax_attention{w}",
                       lambda w=w: _jax_attention_grads(w)) for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("name", ATTN_CASES)
def test_attention_gradients_match_jax(worlds, jax_attention, world, kind,
                                       name):
    got = worlds(world)
    for x in ("dq", "dk", "dv"):
        want = jax_attention[world][f"{name}_{kind}/{x}"]
        np.testing.assert_allclose(got[f"attn/{name}_{kind}/{x}"], want,
                                   rtol=ATTN_TOL, atol=ATTN_TOL,
                                   err_msg=f"{name} {kind} {x}")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _rel_l2(got, want):
    got, want = (torch.as_tensor(np.asarray(t), dtype=torch.float64)
                 for t in (got, want))
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("tag", sorted(TRAIN))
def test_mesh_train_step_matches_jax(setup, worlds, jax_train, tag):
    shape, _, mode, B = TRAIN[tag]
    got = worlds(int(np.prod(shape)))
    want = jax_train[mode][B]
    pre = f"train/{tag}/"
    names = sorted(k[len(pre) + len("grad0/"):] for k in got
                   if k.startswith(pre + "grad0/"))
    assert names and names == sorted(
        k[len("grad0/"):] for k in want if k.startswith("grad0/"))
    if mode == "lora":
        # every targeted layer adapts, the row-parallel o and ffn.2 too
        assert {n.rsplit(".lora.", 1)[0].rsplit(".", 1)[-1]
                for n in names} == {"q", "k", "v", "o", "k_img", "v_img",
                                    "0", "2"}
    old = ({n: torch.as_tensor(np.asarray(t))
            for n, t in setup["lora_sd"].items()} if mode == "lora"
           else dict(setup["sd"]))
    wd = _opt_args(mode)["weight_decay"]
    for i in range(2):
        assert got[f"{pre}loss{i}"] == pytest.approx(want[f"loss{i}"],
                                                     rel=LOSS_RTOL)
        for n in names:
            g, w = got[f"{pre}grad{i}/{n}"], want[f"grad{i}/{n}"]
            assert tuple(g.shape) == tuple(np.shape(w)), n
            if not np.asarray(w).any():
                assert not g.any(), n          # unreached by the loss
            else:
                assert _rel_l2(g, w) <= GRAD_RTOL, (i, n, _rel_l2(g, w))
            new = got[f"{pre}param{i}/{n}"]
            if i == 0:                                # lr 0 on step 0
                assert torch.equal(new, old[n]), n
            else:
                _check_update(n, new, torch.as_tensor(np.asarray(
                    want[f"param{i}/{n}"])), old[n],
                    torch.as_tensor(np.asarray(w)), LR, wd)
            old[n] = new


@pytest.mark.parametrize("shape", [
    "x".join(map(str, shape)) for shape, _, _ in
    SMALL_MESH_TRAIN_RUNS])
def test_mesh_train_launch_count_contract(worlds, shape):
    """chip_smoke.py's expected launches of a small_mesh_train step on each
    rank (``mesh_train_launches``) are the kernels the step calls: every
    stats forward (the ring's per hop), dq and dk/dv by head dim."""
    world = int(np.prod([int(x) for x in shape.split("x")]))
    ranks = worlds(world)[f"contract/{shape}"]
    assert len(ranks) == world
    for r, counts in enumerate(ranks):
        assert counts["seen"] == counts["want"], (r, counts)
        assert any(v for k, v in counts["seen"].items()
                   if k.startswith("bwd_"))


def test_ranks_load_no_jax(worlds):
    for world in WORLDS:
        assert list(worlds(world)["foreign"]) == []


# ---------------------------------------------------------------------------
# LoRA on split layers (one process, the meta device)
# ---------------------------------------------------------------------------

def test_lora_factor_rules_follow_their_layers():
    """A column-parallel layer's up splits over its output features, a
    row-parallel layer's down over its input features, the other factor
    stays whole: the rules on a model with adapters attached agree with
    the splits ``init_lora`` gives the factors of a split model."""
    cfg = fusion_config_from(mesh_config())
    mesh = sharding.Mesh((1, 1, 2), 1, (sharding.Axis(None, 1, 0),
                                        sharding.Axis(None, 1, 0),
                                        sharding.Axis(None, 2, 1)))
    whole = build(lambda: FusionModel(cfg), device="cpu",
                  dtype=torch.float32)
    init_lora(whole, RANK, generator=torch.Generator().manual_seed(0))
    shapes = {n: tuple(p.shape) for n, p in whole.named_parameters()
              if ".lora." in n}
    specs = sharding.param_specs(shapes, sharding.sizes_of(mesh))
    split = build(lambda: FusionModel(cfg), device="cpu",
                  dtype=torch.float32, mesh=mesh)
    init_lora(split, RANK, generator=torch.Generator().manual_seed(0))
    layers = {"q", "k", "v", "o", "k_img", "v_img", "0", "2"}
    seen = set()
    for name, shape in shapes.items():
        layer, factor = name.rsplit(".lora.", 1)
        kind = layer.rsplit(".", 1)[-1]
        seen.add(kind)
        row = kind in ("o", "2")
        split_dim = {("up", False): 0, ("down", True): 1}.get((factor, row))
        want = () if split_dim is None else (
            ("model", None) if split_dim == 0 else (None, "model"))
        assert specs[name] == want, name
        part = split.param_parts.get(name)
        assert (None if part is None else part[0]) == split_dim, name
        got = tuple(split.get_parameter(name).shape)
        expect = list(shape)
        if split_dim is not None:
            expect[split_dim] //= 2
        assert got == tuple(expect), name
    assert seen == layers


def test_lora_init_on_a_split_model_draws_the_unsplit_values():
    """Each model rank's factors are its parts of the factors a seeded init
    draws on the unsplit model (down drawn whole, up zero)."""
    cfg = fusion_config_from(mesh_config())
    whole = build(lambda: FusionModel(cfg), device="cpu",
                  dtype=torch.float32)
    init_lora(whole, RANK, generator=torch.Generator().manual_seed(4))
    want = lora_state(whole)
    for index in range(2):
        mesh = sharding.Mesh((1, 1, 2), index, (
            sharding.Axis(None, 1, 0), sharding.Axis(None, 1, 0),
            sharding.Axis(None, 2, index)))
        split = build(lambda: FusionModel(cfg), device="cpu",
                      dtype=torch.float32, mesh=mesh)
        init_lora(split, RANK, generator=torch.Generator().manual_seed(4))
        got = lora_state(split)
        assert set(got) == set(want)
        for name, t in got.items():
            torch.testing.assert_close(
                t, sharding.part_of_whole(want[name], name, split),
                rtol=0, atol=0)
