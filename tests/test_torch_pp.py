"""The port's pipeline-parallel trainer against the JAX package, on spawned
gloo ranks on the CPU in f32 (one spawn per world size, 2 and 4, running
every case of that size; the results and the JAX references are made once
and shared between the test processes):

  * ``parallel/pipeline.py:pipeline_apply`` on the toy stage of JAX
    ``tests/test_pipeline_parallel.py`` at S = 2 and 4 against JAX
    ``pipeline_apply``: the last stage's output and the gradient of every
    stage's blocks;
  * ``pipeline_dit_blocks`` (real DiT blocks, S = 4) against JAX;
  * ``training/pp.py:make_pp_train_step`` on a ('pipe', 'data') 2 x 2 mesh
    against JAX ``make_pp_train_step`` (SGD 1e-2, 4 blocks, B = 4) and
    JAX's sequential gradients, as JAX ``tests/test_pp_train.py`` checks
    it; on a ('pipe', 'model') 2 x 2 mesh against the sequential step;
    lite bit-equal on every stage after two AdamW steps;
  * 'seq' inside a stage: the step on (pipe 2, seq 2), its 3 latent frames
    split 2 | 1, with the self-attention gathered, through Ulysses, and
    through the ring (3 heads, which 2 seq ranks do not divide), each
    against JAX ``make_pp_train_step`` on a ('pipe', 'data', 'seq',
    'model') (2, 1, 2, 1) mesh; lite bit-equal on all four ranks; each
    rank's launches exactly ``chip_smoke.pipe_train_launches``';
  * the i2v-conditioned loss with a sigma per sample; the rejection of a
    heterogeneous stack; the forward hop and its gradient, the mirror hop,
    at world 2 and 4; the launch count of ``chip_smoke.py``'s small_pipe;
  * ``cli.train --pipe_stages``: under torchrun, saved and resumed at S = 2
    and at S = 1 against an unbroken run; ``_pp_batches`` and
    ``_pp_data_batches`` against the JAX trainer's; the mode's exits in
    the JAX trainer's order.

Tolerances: the loss within LOSS_RTOL relative, gradients and parameters
within REL_L2 relative L2 per tensor (f32 on both sides; the pipeline
sums some gradients in another order).
"""
import argparse
import dataclasses
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU, 8 virtual devices)
import jax
import jax.numpy as jnp
import optax
from jax import lax
from jax.sharding import Mesh

from fantasy_world_tpu.cli import train as jtrain
from fantasy_world_tpu.models.wan import dit as jdit
from fantasy_world_tpu.parallel.pipeline import (make_pipe_mesh as jax_mesh,
                                                 pipeline_apply as jax_apply,
                                                 pipeline_dit_blocks as
                                                 jax_dit_blocks)
from fantasy_world_tpu.training import pp as jpp

import torch_mesh_workers as workers
from test_torch_mesh_train import _rel_l2, _shared
from fantasy_world_tpu_torch.cli import train
from fantasy_world_tpu_torch.convert.from_jax import (dit_state_dict,
                                                      encoder_config_from)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.wan.dit import WanDiT, WanDiTConfig
from fantasy_world_tpu_torch.parallel import sharding
from fantasy_world_tpu_torch.parallel.distributed import spawn
from fantasy_world_tpu_torch.parallel.pipeline import single_pipe
from fantasy_world_tpu_torch.training.pp import (HETEROGENEOUS,
                                                 build_stage_dit,
                                                 split_dit_trainable)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
REL_L2 = 1e-4
TOY_L, TOY_M = 8, 2          # the JAX toy test's blocks and microbatches
L, B, FHW = 4, 4, (3, 4, 6)  # the JAX PP-step test's model and batch
SGD_LR, ADAM_LR = 1e-2, 1e-3
SEQ_AXES = ("pipe", "data", "seq", "model")
# chip_smoke.py's small_pipe launches are checked at its model on 6 latent
# frames of 4 x 6 tokens (the CPU's plain versions, counted)
CONTRACT_GEOMETRY = (64, 96, 21)
# tag: ((pipe, data, seq, model), optimizer, steps, the model's heads,
# Ulysses)
STEPS = {"pipe_data": ((2, 2, 1, 1), "sgd", 1, 4, False),
         "pipe_model": ((2, 1, 1, 2), "sgd", 1, 4, False),
         "pipe_data_adamw": ((2, 2, 1, 1), "adamw", 2, 4, False),
         "pipe_seq_gather": ((2, 1, 2, 1), "sgd", 1, 4, False),
         "pipe_seq_ulysses": ((2, 1, 2, 1), "sgd", 1, 4, True),
         "pipe_seq_ring": ((2, 1, 2, 1), "sgd", 1, 3, True)}
# how each seq case's self-attention runs (chip_smoke's MESH_MODES words)
SEQ_MODES = {"pipe_seq_gather": "gather", "pipe_seq_ulysses": "ulysses",
             "pipe_seq_ring": "ring"}
TEXT_LEN = 20                # the batch's context tokens


# ---------------------------------------------------------------------------
# inputs and JAX references
# ---------------------------------------------------------------------------

def _toy_inputs():
    rng = np.random.default_rng(0)
    D = 16
    return {"kernel": (rng.standard_normal((TOY_L, D, D)) * 0.3
                       ).astype(np.float32),
            "bias": (rng.standard_normal((TOY_L, D)) * 0.1
                     ).astype(np.float32),
            "x": rng.standard_normal((4, 6, D)).astype(np.float32),
            "scale": (rng.standard_normal((4, 1, D)) * 0.2
                      ).astype(np.float32),
            "M": TOY_M}


def _jax_toy(stages):
    """JAX ``pipeline_apply`` on the toy stack at ``stages``: the output and
    d sum(out^2) / d(kernel, bias)."""
    a = _toy_inputs()
    params = {"kernel": jnp.asarray(a["kernel"]),
              "bias": jnp.asarray(a["bias"])}
    x, scale = jnp.asarray(a["x"]), jnp.asarray(a["scale"])

    def stage(stage_p, h, sc):
        def body(hc, bp):
            return jnp.tanh(hc @ bp["kernel"] + bp["bias"]) * (1.0 + sc) \
                + hc, None
        return lax.scan(body, h, stage_p)[0]

    mesh = jax_mesh(stages)

    def run(p):
        return jax_apply(stage, p, x, per_mb_args=(scale,), mesh=mesh,
                         microbatches=TOY_M)
    out = jax.jit(run)(params)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jnp.square(run(p)))))(params)
    return {"out": np.asarray(out),
            **{k: np.asarray(v) for k, v in grads.items()}}


def _tiny_jcfg(layers, **kw):
    base = dict(dim=96, in_dim=8, ffn_dim=128, out_dim=8, text_dim=32,
                freq_dim=64, patch_size=(1, 2, 2), num_heads=4,
                num_layers=layers, has_image_input=False)
    base.update(kw)
    return jdit.WanDiTConfig(**base)


def _port_model(jcfg, params):
    """(the port's config, the whole WanDiT state dict of JAX ``params``)."""
    cfg = encoder_config_from(WanDiTConfig, jcfg)
    m = build(lambda: WanDiT(cfg), device="cpu", dtype=torch.float32)
    return cfg, dit_state_dict(params, m)


def _unstack(lite, blocks, layers):
    p = dict(lite)
    p["blocks"] = [jax.tree_util.tree_map(lambda a: a[i], blocks)
                   for i in range(layers)]
    return p


def _jbatch(jcfg, rng):
    F, H, W = FHW
    return dict(
        clean_latents=rng.standard_normal((B, jcfg.in_dim, F, H, W)),
        noise=rng.standard_normal((B, jcfg.in_dim, F, H, W)),
        sigma=np.float32(0.7), timestep=np.full((B,), 500.0, np.float32),
        context=rng.standard_normal((B, 20, jcfg.text_dim)))


def _np32(b):
    return {k: np.asarray(v, np.float32) for k, v in b.items()}


def _to_torch(b):
    return {k: (float(v) if np.ndim(v) == 0 else torch.from_numpy(v))
            for k, v in b.items()}


def _to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _step_setup(heads=4):
    """JAX ``tests/test_pp_train.py``'s model (seed 0, 4 blocks, of
    ``heads`` heads) and batch (seed 0)."""
    jcfg = _tiny_jcfg(L, num_heads=heads)
    params = jdit.init_wan_dit(0, jcfg, jnp.float32)
    return jcfg, params, _np32(_jbatch(jcfg, np.random.default_rng(0)))


def _jax_steps(heads=4, axes=("pipe", "data"), shape=(2, 2)):
    """The JAX step on a ``shape`` mesh of ``axes`` under SGD: its loss and
    updated parameters; JAX's sequential loss and gradients; all in the
    port's names."""
    jcfg, params, batch = _step_setup(heads)
    _, m_sd = _port_model(jcfg, params)
    trainable = jpp.split_dit_trainable(params)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(shape), axes)
    opt = optax.sgd(SGD_LR)
    step = jax.jit(jpp.make_pp_train_step(jcfg, opt, mesh=mesh,
                                          microbatches=2))
    (lite2, blocks2), _, loss_pp = step(trainable, opt.init(trainable),
                                        _to_jax(batch))
    jb = _to_jax(batch)

    def seq_loss(tr):
        p = _unstack(*tr, L)
        noisy = (1 - jb["sigma"]) * jb["clean_latents"] \
            + jb["sigma"] * jb["noise"]
        pred = jdit.wan_dit_forward(p, jcfg, noisy, jb["timestep"],
                                    jb["context"])
        return jnp.mean(jnp.square(pred - (jb["noise"]
                                           - jb["clean_latents"])))

    loss_seq, grads = jax.jit(jax.value_and_grad(seq_loss))(trainable)
    updated_seq = jax.tree_util.tree_map(lambda p, g: p - SGD_LR * g,
                                         trainable, grads)

    def names(tree):
        return {k: np.asarray(v) for k, v in dit_state_dict(
            _unstack(*tree, L), _meta_dit(jcfg)).items()}
    return {"pp_loss": float(loss_pp), "pp_params": names((lite2, blocks2)),
            "seq_loss": float(loss_seq), "seq_grads": names(grads),
            "seq_params": names(updated_seq),
            "sd": {k: v.clone() for k, v in m_sd.items()}}


def _meta_dit(jcfg):
    cfg = encoder_config_from(WanDiTConfig, jcfg)
    return build(lambda: WanDiT(cfg), device="cpu", dtype=torch.float32)


def _dit_blocks_case():
    """JAX ``tests/test_pipeline_parallel.py``'s DiT-blocks check: 8 real
    blocks, S = 4, M = 2, and the JAX output."""
    jcfg = jdit.WanDiTConfig(dim=96, in_dim=8, ffn_dim=128, out_dim=4,
                             text_dim=32, freq_dim=64, patch_size=(1, 2, 2),
                             num_heads=4, num_layers=TOY_L,
                             has_image_input=False)
    params = jdit.init_wan_dit(0, jcfg, jnp.float32)
    rng = np.random.default_rng(1)
    f, h, w = 3, 4, 6
    inp = {"x": rng.standard_normal((4, f * h * w, jcfg.dim)),
           "context": rng.standard_normal((4, 20, jcfg.dim)),
           "t_mod": rng.standard_normal((4, 6, jcfg.dim))}
    inp = _np32(inp)
    from fantasy_world_tpu.core.params import stack_trees
    from fantasy_world_tpu.ops import rope as jrope
    cos, sin = jrope.cos_sin_half_from_angles(
        jrope.build_angles_3d(jcfg.head_dim, f, h, w))
    out = jax.jit(lambda x, c, t: jax_dit_blocks(
        stack_trees(params["blocks"]), jcfg, x, c, t, cos, sin,
        mesh=jax_mesh(4), microbatches=2))(
            *(jnp.asarray(inp[k]) for k in ("x", "context", "t_mod")))
    cfg, sd = _port_model(jcfg, params)
    return {"stages": 4, "M": 2, "grid": (f, h, w), "cfg": cfg, "sd": sd,
            **inp}, np.asarray(out)


def _i2v_case():
    """JAX ``tests/test_pp_train.py``'s i2v check: CLIP tokens and y,
    a sigma per sample; the JAX pipelined loss at S = 2."""
    lat = 8
    jcfg = _tiny_jcfg(L, in_dim=2 * lat, has_image_input=True,
                      require_vae_embedding=True, clip_feature_dim=48)
    params = jdit.init_wan_dit(0, jcfg, jnp.float32)
    rng = np.random.default_rng(3)
    batch = _jbatch(jcfg, rng)
    F, H, W = FHW
    for k in ("clean_latents", "noise"):
        batch[k] = rng.standard_normal((B, lat, F, H, W))
    batch["sigma"] = rng.uniform(0.2, 0.9, (B, 1, 1, 1, 1))
    batch["clip_feature"] = rng.standard_normal((B, 257, 48))
    batch["y"] = rng.standard_normal((B, lat, F, H, W))
    batch = _np32(batch)
    lite, blocks = jpp.split_dit_trainable(params)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pipe",))
    loss = jax.jit(lambda b: jpp.pp_flow_match_loss(
        lite, blocks, jcfg, mesh=mesh, microbatches=2, **b))(_to_jax(batch))
    cfg, sd = _port_model(jcfg, params)
    return {"stages": 2, "M": 2, "cfg": cfg, "sd": sd,
            "batch": _to_torch(batch)}, float(loss)


def _hop_inputs(world):
    rng = np.random.default_rng(11 + world)
    return {"x": rng.standard_normal((world, 3, 5)).astype(np.float32),
            "g": rng.standard_normal((world, 3, 5)).astype(np.float32)}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The JAX references (each made once for every test process)."""
    cache = {}

    def get(name):
        if name not in cache:
            make = {"toy2": lambda: _jax_toy(2), "toy4": lambda: _jax_toy(4),
                    "steps": _jax_steps, "dit_blocks": _dit_blocks_case,
                    "i2v": _i2v_case,
                    # JAX's stage interior stays GSPMD over 'seq'
                    "seq_steps4": lambda: _jax_steps(4, SEQ_AXES,
                                                     (2, 1, 2, 1)),
                    "seq_steps3": lambda: _jax_steps(3, SEQ_AXES,
                                                     (2, 1, 2, 1))}[name]
            cache[name] = _shared(tmp_path_factory, f"pp_{name}", make)
        return cache[name]
    return get


def _spec(world, refs):
    spec = {"toy": dict(_toy_inputs(), stages=world),
            "hop": _hop_inputs(world)}
    if world == 2:
        spec["i2v"] = refs("i2v")[0]
        spec["contract"] = {"geometry": CONTRACT_GEOMETRY}
    if world == 4:
        spec["dit_blocks"] = refs("dit_blocks")[0]
        spec["contract_seq"] = {"geometry": CONTRACT_GEOMETRY, "seq": 2,
                                "ulysses": (False, True)}
        spec["models"] = {}
        for heads, ref in ((4, "steps"), (3, "seq_steps3")):
            jcfg, _, batch = _step_setup(heads)
            spec["models"][heads] = {
                "cfg": encoder_config_from(WanDiTConfig, jcfg),
                "sd": refs(ref)["sd"], "batch": _to_torch(batch)}
        spec["steps"] = {
            tag: {"mesh": mesh, "opt": opt, "steps": n, "M": 2,
                  "lr": SGD_LR if opt == "sgd" else ADAM_LR,
                  "model": heads, "ulysses": uly}
            for tag, (mesh, opt, n, heads, uly) in STEPS.items()}
    return spec


@pytest.fixture(scope="module")
def worlds(refs, tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            def make():
                tmp = tmp_path_factory.mktemp(f"pp{world}")
                torch.save(_spec(world, refs), tmp / "spec.pt")
                spawn(workers.pp_cases, world, str(tmp / "spec.pt"),
                      str(tmp / "out.pt"))
                return torch.load(tmp / "out.pt", weights_only=False)
            cache[world] = _shared(tmp_path_factory, f"pp_world{world}",
                                   make)
        return cache[world]
    return get


def _merged(ranks, key):
    """{name: array} of every rank's ``key/name`` entries (each stage its
    own blocks; lite, on every rank, must agree to the bit)."""
    out = {}
    for r in ranks:
        for k, v in r.items():
            if k.startswith(key + "/"):
                name = k[len(key) + 1:]
                if name in out:
                    np.testing.assert_array_equal(out[name], v, err_msg=name)
                out[name] = v
    return out


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_apply_matches_jax_toy(worlds, refs, stages):
    """The last stage's output and each stage's block gradients equal JAX
    ``pipeline_apply``'s (JAX's test holds them to 1e-5 / 1e-4); the other
    stages return an empty tensor."""
    want = refs(f"toy{stages}")
    ranks = worlds(stages)["toy"]
    np.testing.assert_allclose(ranks[-1]["out"], want["out"], rtol=1e-5,
                               atol=1e-5)
    assert all(r["out"].size == 0 for r in ranks[:-1])
    for key in ("kernel", "bias"):
        got = np.concatenate([r[key] for r in ranks])
        assert [r["blocks"] for r in ranks] == [
            (s * TOY_L // stages, (s + 1) * TOY_L // stages)
            for s in range(stages)]
        assert _rel_l2(got, want[key]) <= REL_L2, key


@pytest.mark.parametrize("world", [2, 4])
def test_forward_hop_gradient(worlds, world):
    """The forward hop gives each rank the previous rank's tensor; its
    gradient, the mirror hop the backward schedule runs, hands each rank
    the next rank's."""
    inp = _hop_inputs(world)
    ranks = worlds(world)["hop"]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["y"], inp["x"][(r - 1) % world])
        np.testing.assert_array_equal(got["dx"], inp["g"][(r + 1) % world])


def test_pipeline_dit_blocks_match_jax(worlds, refs):
    want = refs("dit_blocks")[1]
    np.testing.assert_allclose(worlds(4)["dit_blocks"][-1]["out"], want,
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def test_pp_step_pipe_data_matches_jax(worlds, refs):
    """('pipe', 'data') 2 x 2, SGD 1e-2: the loss of JAX
    ``make_pp_train_step``, JAX's sequential gradients, and the parameters
    JAX's step leaves."""
    want = refs("steps")
    ranks = worlds(4)["pipe_data"]
    for r in ranks:
        assert r["loss0"] == pytest.approx(want["pp_loss"], rel=LOSS_RTOL)
    assert want["pp_loss"] == pytest.approx(want["seq_loss"], rel=LOSS_RTOL)
    grads, params = _merged(ranks, "grad0"), _merged(ranks, "param0")
    assert sorted(grads) == sorted(want["seq_grads"])
    for n, g in grads.items():
        assert _rel_l2(g, want["seq_grads"][n]) <= REL_L2, n
        assert _rel_l2(params[n], want["pp_params"][n]) <= REL_L2, n


def test_pp_step_pipe_model_matches_sequential(worlds, refs):
    """('pipe', 'model') 2 x 2: each stage's blocks split over the model
    group; the sequential step's loss, gradients and parameters."""
    want = refs("steps")
    ranks = worlds(4)["pipe_model"]
    for r in ranks:
        assert r["loss0"] == pytest.approx(want["seq_loss"], rel=LOSS_RTOL)
    grads, params = _merged(ranks, "grad0"), _merged(ranks, "param0")
    assert sorted(grads) == sorted(want["seq_grads"])
    for n, g in grads.items():
        assert _rel_l2(g, want["seq_grads"][n]) <= REL_L2, n
        assert _rel_l2(params[n], want["seq_params"][n]) <= REL_L2, n


def test_lite_stays_bit_equal_on_every_stage(worlds):
    """Two AdamW steps at ('pipe', 'data') 2 x 2: the embeddings and head
    are the same bits on all four ranks after each step (``_merged``
    asserts it), the blocks only on their stage's two ranks."""
    ranks = worlds(4)["pipe_data_adamw"]
    for i in range(2):
        values = _merged(ranks, f"param{i}")
        lite = [n for n in values if not n.startswith("blocks.")]
        assert lite and all(f"param{i}/{n}" in r for n in lite
                            for r in ranks)
        assert len({r[f"loss{i}"] for r in ranks}) == 1
    # AdamW's step 1 moved lite (step 0 runs at the warm-up's lr 0)
    assert any(not np.array_equal(ranks[0][f"param1/{n}"],
                                  ranks[0][f"param0/{n}"]) for n in lite)


@pytest.mark.parametrize("tag", sorted(SEQ_MODES))
def test_pp_step_seq_inside_a_stage_matches_jax(worlds, refs, tag):
    """(pipe 2, seq 2), the 3 latent frames split 2 | 1 over the seq ranks
    of each stage, SGD 1e-2: the loss of JAX ``make_pp_train_step`` on the
    (2, 1, 2, 1) mesh, JAX's sequential gradients and the parameters
    JAX's step leaves; every parameter, lite and the blocks, the same
    bits on the ranks that hold it (``_merged``), lite on all four."""
    want = refs("seq_steps3" if STEPS[tag][3] == 3 else "seq_steps4")
    ranks = worlds(4)[tag]
    assert want["pp_loss"] == pytest.approx(want["seq_loss"], rel=LOSS_RTOL)
    assert len({r["loss0"] for r in ranks}) == 1
    for r in ranks:
        assert r["loss0"] == pytest.approx(want["pp_loss"], rel=LOSS_RTOL)
    grads, params = _merged(ranks, "grad0"), _merged(ranks, "param0")
    assert sorted(grads) == sorted(want["seq_grads"])
    lite = [n for n in grads if not n.startswith("blocks.")]
    assert lite and all(f"param0/{n}" in r for n in lite for r in ranks)
    for n, g in grads.items():
        assert _rel_l2(g, want["seq_grads"][n]) <= REL_L2, n
        assert _rel_l2(params[n], want["pp_params"][n]) <= REL_L2, n


@pytest.mark.parametrize("tag", sorted(SEQ_MODES))
def test_pp_seq_launches_are_exact(worlds, tag):
    """Each rank of the (pipe 2, seq 2) step launches what
    ``chip_smoke.pipe_train_launches`` reckons for its frames (2 | 1 of 3)
    and its stage's 2 blocks, the self-attention as gathered keys, as
    Ulysses's head groups or as the ring's hops (the CPU's plain
    versions, counted); the cross-attention on its queries."""
    import chip_smoke
    mesh, _, _, heads, _ = STEPS[tag]
    cfg = encoder_config_from(WanDiTConfig, _tiny_jcfg(L, num_heads=heads))
    f, h, w = FHW
    sizes = tuple(len(c) * h * w for c in np.array_split(np.arange(f), 2))
    for rank, r in enumerate(worlds(4)[tag]):
        seq_index = np.unravel_index(rank, mesh)[2]
        want = chip_smoke.pipe_train_launches(
            cfg, L // mesh[0], None, TEXT_LEN, mode=SEQ_MODES[tag],
            split=sharding.TokenSplit(None, sizes, int(seq_index)))
        assert r["launches0"] == want, (rank, r["launches0"], want)
        assert any(v for k, v in want.items() if k.startswith("bwd_"))


def test_i2v_loss_matches_jax(worlds, refs):
    want = refs("i2v")[1]
    for r in worlds(2)["i2v"]:
        assert r["loss"] == pytest.approx(want, rel=LOSS_RTOL)


def test_small_pipe_launch_contract(worlds):
    """``chip_smoke.py``'s expected launches of a small_pipe step on each
    stage (``pipe_train_launches``) are the kernels the step calls: every
    block's three attentions on every microbatch, their stats forwards
    twice under recompute, dq and dk/dv once."""
    ranks = worlds(2)["contract"]
    assert len(ranks) == 2
    for r, counts in enumerate(ranks):
        assert counts["seen"] == counts["want"], (r, counts)
        assert any(v for k, v in counts["seen"].items()
                   if k.startswith("bwd_"))


@pytest.mark.parametrize("ulysses", [False, True])
def test_small_pipe_seq_launch_contract(worlds, ulysses):
    """``chip_smoke.py``'s expected launches of a small_pipe_seq step on
    each of its 4 ranks (2 stages x 2 seq ranks, the 6 latent frames 3 |
    3; ``pipe_launches_of``) are the kernels the step calls, the
    self-attention gathered or through Ulysses."""
    ranks = worlds(4)[f"contract_seq_{ulysses}"]
    assert len(ranks) == 4
    for r, counts in enumerate(ranks):
        assert counts["seen"] == counts["want"], (r, counts)
        assert any(v for k, v in counts["seen"].items()
                   if k.startswith("bwd_"))


def test_ranks_load_no_jax(worlds):
    for world in (2, 4):
        assert list(worlds(world)["foreign"]) == []


def test_split_rejects_a_heterogeneous_stack():
    """Camera adapters on the first blocks make the stack heterogeneous:
    JAX's ValueError, in JAX's words; a homogeneous stack splits into lite
    and the stage's blocks."""
    cfg = encoder_config_from(WanDiTConfig, _tiny_jcfg(L))
    with pytest.raises(ValueError, match="homogeneous") as raised:
        split_dit_trainable(build(
            lambda: WanDiT(dataclasses.replace(cfg, camera_adapter_end=2)),
            device="meta", dtype=torch.float32))
    assert str(raised.value) == HETEROGENEOUS
    model = build_stage_dit(cfg, single_pipe(), device="meta",
                            dtype=torch.float32)
    model.blocks["2"].extra_adapter = torch.nn.Linear(3, 3)
    with pytest.raises(ValueError, match="homogeneous"):
        split_dit_trainable(model)
    del model.blocks["2"].extra_adapter
    lite, blocks = split_dit_trainable(model)
    assert len(blocks) == L and "patch_embedding.weight" in lite
    assert not any(n.startswith("blocks.") for n in lite)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _args(ckpt_dir, steps, *extra):
    return ["--synthetic", "--steps", str(steps), "--demo_dim", "64",
            "--demo_layers", "2", "--warmup", "1", "--lr", "1e-3",
            "--save_every", "100", "--log_every", "1",
            "--checkpoint_dir", str(ckpt_dir), "--device", "cpu", *extra]


def _torchrun(nproc, argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), "-m",
         "fantasy_world_tpu_torch.cli.train", *argv], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(proc):
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:]
    return out


def _losses(out):
    found = {}
    for step, loss in re.findall(r"step (\d+)  loss ([-\d.naninf]+)", out):
        assert found.setdefault(int(step), float(loss)) == float(loss)
    return found


def test_pipe_trainer_under_torchrun_saves_and_resumes(tmp_path, capsys):
    """``--pipe_stages 2`` on 2 gloo ranks: 2 steps saved; resumed to 3 at
    S = 2 (torchrun) and at S = 1 (one process); each equal to an unbroken
    run at S = 2, which equals one at S = 1 (the pipeline is a layout of
    the same step); the checkpoint holds the plain DiT's whole tensors."""
    pipe2 = ["--pipe_stages", "2"]
    first = _torchrun(2, _args(tmp_path / "ck", 2) + pipe2)
    straight = _torchrun(2, _args(tmp_path / "straight", 3) + pipe2)
    out = _finish(first)
    assert "train done: 2 step(s) on 2 ranks (pipe 2 x data 1)" in out
    shutil.copytree(tmp_path / "ck", tmp_path / "ck_one")
    resumed = _torchrun(2, _args(tmp_path / "ck", 3) + pipe2)
    train.main(_args(tmp_path / "ck_one", 3) + ["--pipe_stages", "1"])
    one = capsys.readouterr().out
    train.main(_args(tmp_path / "straight_one", 3) + ["--pipe_stages", "1"])
    straight_one = float(re.search(r"final loss ([-\d.]+)",
                                   capsys.readouterr().out).group(1))
    want = _losses(_finish(straight))
    got = _losses(out + _finish(resumed))
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for step in want:
        assert got[step] == pytest.approx(want[step], abs=2e-5), step
    resumed_one = float(re.search(r"final loss ([-\d.]+)", one).group(1))
    assert "train done: 1 step(s)" in one
    assert resumed_one == pytest.approx(want[2], abs=2e-5)
    assert straight_one == pytest.approx(want[2], abs=2e-5)
    state = torch.load(tmp_path / "ck" / "step_00000003" / "state.pt",
                       weights_only=True)
    names = [n for n, _ in build(lambda: WanDiT(train._pipe_config(
        train.parse_args(_args("x", 1)))), device="meta",
        dtype=torch.float32).named_parameters()]
    assert list(state["trainable"]) == names
    assert sorted(state["optimizer"]["state"]) == list(range(len(names)))


def test_pp_batches_match_jax_trainer():
    """``_pp_batches``: the JAX trainer's stream, M x D samples."""
    for D in (1, 2):
        args = argparse.Namespace(seed=5, pipe_microbatches=2, mesh_data=D,
                                  demo_dim=64, demo_layers=2, synthetic=True)
        cfg = train._pipe_config(args)
        mesh = Mesh(np.asarray(jax.devices()[:2 * D]).reshape(2, D),
                    ("pipe", "data"))
        mine = train._pp_batches(cfg, args, "cpu")
        theirs = jtrain._pp_batches(cfg, args, mesh)
        for _ in range(2):
            a, b = next(mine), next(theirs)
            assert set(a) == set(b)
            assert a["clean_latents"].shape[0] == 2 * D
            for key in a:
                np.testing.assert_array_equal(np.asarray(a[key]),
                                              np.asarray(b[key]),
                                              err_msg=key)


def _fake_clips(lib):
    """JAX ``tests/test_pp_train.py``'s fed single-clip batches: the third
    is short (one latent frame), and each carries Plucker features."""
    def stream(pipe, args, start=0, stage_callback=None, with_plucker=True):
        assert with_plucker is False
        i = start
        while True:
            i += 1
            f = 1 if i == 3 else 2
            v = 0.0 if i == 3 else float(i)
            b = {"clean_latents": np.full((1, 4, f, 4, 4), v),
                 "noise": np.zeros((1, 4, f, 4, 4)),
                 "timestep": np.full((1,), 100.0 * i),
                 "context": np.full((1, 8, 16), v),
                 "clip_feature": np.full((1, 257, 12), v),
                 "y": np.zeros((1, 4, f, 4, 4)),
                 "plucker_fea": np.zeros((1, 32, 8))}
            b = {k: np.asarray(x, np.float32) for k, x in b.items()}
            b = ({k: jnp.asarray(x) for k, x in b.items()} if lib == "jax"
                 else {k: torch.from_numpy(x) for k, x in b.items()})
            b["sigma"] = np.float32(0.9 if i == 3 else 0.1 * i)
            yield b
    return stream


def test_pp_data_batches_match_jax_trainer(monkeypatch):
    """``_pp_data_batches`` stacks M x D clips as the JAX trainer does: a
    short clip skipped, the Plucker features dropped (never computed), a
    sigma per sample."""
    for mod, lib in ((train, "torch"), (jtrain, "jax")):
        monkeypatch.setattr(mod, "_data_batches", _fake_clips(lib))
        monkeypatch.setattr(mod, "_clip_dirs",
                            lambda root: ["c1", "c2", "c3", "c4", "c5"])
    args = types.SimpleNamespace(pipe_microbatches=2, mesh_data=2, frames=5,
                                 height=32, width=32, data_root="unused")
    pipe = types.SimpleNamespace(vae_cfg=types.SimpleNamespace(z_dim=4))
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("pipe", "data"))
    mine = next(train._pp_data_batches(pipe, args))
    theirs = next(jtrain._pp_data_batches(pipe, args, mesh))
    assert set(mine) == set(theirs) and "plucker_fea" not in mine
    assert tuple(mine["sigma"].shape) == (4, 1, 1, 1, 1)
    for key in mine:
        np.testing.assert_allclose(mine[key].numpy(), np.asarray(theirs[key]),
                                   rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(mine["sigma"].numpy().ravel(),
                               [0.1, 0.2, 0.4, 0.5], rtol=1e-6)


@pytest.mark.parametrize("extra,world,message", [
    # JAX's order: LoRA, then a seq or model axis, then the process count,
    # then the block count -- each before anything is loaded
    (["--lora_rank", "4", "--mesh_model", "2", "--demo_layers", "3"], "5",
     "does not compose with --lora_rank"),
    (["--mesh_seq", "2", "--demo_layers", "3"], "5",
     r"wires a \('pipe','data'\) mesh"),
    (["--mesh_model", "2"], "1", r"wires a \('pipe','data'\) mesh"),
    (["--demo_layers", "3"], "1", "needs 2 processes"),
    (["--demo_layers", "3", "--mesh_data", "2"], "2", "needs 4 processes"),
    (["--demo_layers", "3"], "2", "3 blocks not divisible by 2 stages"),
])
def test_pipe_mode_exits_in_jax_order(tmp_path, monkeypatch, extra, world,
                                      message):
    monkeypatch.setenv("WORLD_SIZE", world)
    with pytest.raises(SystemExit, match=message):
        train.main(_args(tmp_path / "x", 1) + ["--pipe_stages", "2"]
                   + extra)
    assert not (tmp_path / "x").exists()


def test_pipe_mode_exits_before_reading_checkpoints(tmp_path, monkeypatch):
    """Real-data mode: a block count the stages do not divide (40 over 3)
    exits before the paths are even looked at, the missing paths before
    anything is read, and without a card and without --device cpu it
    exits naming --device cpu."""
    monkeypatch.setenv("WORLD_SIZE", "3")
    real = ["--data_root", str(tmp_path / "none"), "--wan_ckpt_path",
            str(tmp_path / "none"), "--model_ckpt", str(tmp_path / "m.pth"),
            "--steps", "1", "--device", "cpu", "--pipe_stages", "3"]
    with pytest.raises(SystemExit, match="40 blocks not divisible by 3"):
        train.main(real)
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(SystemExit, match="real-data PP mode needs"):
        train.main(["--pipe_stages", "1", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train.main(["--synthetic", "--pipe_stages", "1"])
