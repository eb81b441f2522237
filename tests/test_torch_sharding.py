"""The port's mesh layer against the JAX package's, on the CPU without
process groups: the split of every tensor of the full-width
``FusionConfig()`` model (built on the meta device) against JAX
``param_specs`` / ``stacked_specs`` through ``convert/from_jax.py``'s names,
whole heads per model rank in the de-interleaved RoPE order, a seeded
sharded build against the unsharded one, the rank layout against JAX
``make_mesh``'s device grid, and the bootstrap (single-process no-op, the
backend choice, NCCL's one card per rank)."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU, 8 virtual devices)
import jax
from jax.sharding import PartitionSpec as P

from fantasy_world_tpu.core.params import abstract_init
from fantasy_world_tpu.models.fusion.model import (
    FusionConfig as JFusionConfig, _segments, init_fusion, irg_runs,
    prepare_scan_params)
from fantasy_world_tpu.parallel import sharding as jsh

import chip_smoke
from fantasy_world_tpu_torch.convert import from_jax
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.fusion.model import (FusionConfig,
                                                         FusionModel)
from fantasy_world_tpu_torch.ops.rope import permute_qk_out_channels
from fantasy_world_tpu_torch.parallel import distributed, sharding


class _Names(from_jax._Writer):
    """from_jax's writer over a tree of PartitionSpecs: {port key: the JAX
    spec of the leaf it is written from, in the port's dim order}."""

    def __init__(self):
        super().__init__({})
        self.specs = {}

    def put(self, name, value):
        self.specs[name] = tuple(value)

    def linear(self, name, p):
        self.specs[name + ".weight"] = tuple(reversed(
            tuple(p["kernel"]) + (None,) * (2 - len(tuple(p["kernel"])))))
        if "bias" in p:
            self.put(name + ".bias", p["bias"])


def _port_keys(tree_specs):
    w = _Names()
    from_jax._dit(w, tree_specs["dit"], "dit.")
    from_jax._vggt(w, tree_specs["vggt"], "vggt.")
    for i, b in enumerate(tree_specs["bicross"]):
        from_jax._bicross(w, b, f"bicross.{i}.")
    return w.specs


def _trim(spec):
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@pytest.fixture(scope="module")
def full():
    """The abstract JAX tree and scan stacks of FusionConfig(), and the
    port's model on the meta device."""
    cfg = JFusionConfig()
    with abstract_init():
        params = init_fusion(0, cfg, jax.numpy.bfloat16)
        scan = prepare_scan_params(params, cfg)
    with torch.device("meta"):
        model = FusionModel(FusionConfig())
    return {"cfg": cfg, "params": params, "scan": scan,
            "shapes": {k: tuple(v.shape)
                       for k, v in model.state_dict().items()}}


def _block_tree(params_specs, scan_specs, cfg):
    """The param tree of specs with every block's taken from its scan
    segment (the stacked spec without its layer axis)."""
    strip = lambda t: jax.tree_util.tree_map(       # noqa: E731
        lambda s: P(*tuple(s)[1:]), t, is_leaf=lambda x: isinstance(x, P))
    tree = jax.tree_util.tree_map(lambda s: s, params_specs,
                                  is_leaf=lambda x: isinstance(x, P))
    dit = list(tree["dit"]["blocks"])
    agg = tree["vggt"]["aggregator"]
    frame, glob = list(agg["frame_blocks"]), list(agg["global_blocks"])
    bic = list(tree["bicross"])
    si = cfg.start_index
    for seg, (lo, hi) in zip(scan_specs["pcb"],
                             _segments(si, min(cfg.dit.camera_adapter_end,
                                               si))):
        for i in range(lo, hi):
            dit[i] = strip(seg)
    for seg, (lo, hi, is_irg, _) in zip(scan_specs["irg"], irg_runs(cfg)):
        for i in range(lo, hi):
            dit[si + i] = strip(seg["dit"])
            frame[i] = strip(seg["frame"])
            glob[i] = strip(seg["agg"])
            if is_irg:
                bic[i] = strip(seg["bicross"])
    tree["dit"] = dict(tree["dit"], blocks=dit)
    tree["vggt"] = dict(tree["vggt"], aggregator=dict(
        agg, frame_blocks=frame, global_blocks=glob))
    tree["bicross"] = bic
    return tree


@pytest.mark.parametrize("model_ranks", [2, 3, 8])
def test_full_width_split_matches_jax_specs(full, model_ranks):
    """Every tensor of the 18.5B model: the port's split (its rules on its
    names, replicated where a dimension does not divide) is JAX's
    ``param_specs`` and ``stacked_specs`` on ``make_mesh(model=M)``, the
    (in, out) kernels' specs reversed onto the (out, in) weights."""
    mesh = jsh.make_mesh(model=model_ranks)
    jspecs = jsh.param_specs(full["params"], mesh=mesh)
    sspecs = jsh.stacked_specs(full["scan"], mesh=mesh)
    port = sharding.param_specs(full["shapes"], {"model": model_ranks})
    for tree in (jspecs, _block_tree(jspecs, sspecs, full["cfg"])):
        want = _port_keys(tree)
        assert set(want) == set(port)
        bad = {k: (port[k], want[k]) for k in port
               if _trim(port[k]) != _trim(want[k])}
        assert not bad, list(bad.items())[:5]
    split = sorted(k for k, v in port.items() if v)
    if model_ranks == 3:        # 5120 does not divide by 3, 13824 does
        assert all(".ffn." in k for k in split) and len(split) == 40 * 3
    else:                       # 40 blocks: q k v o k_img v_img, 2 FFN
        assert len([k for k in split if k.endswith(".weight")]) == 40 * 12
        assert len([k for k in split if k.endswith(".bias")]) == 40 * 9


def _fake_mesh(model, index):
    return sharding.Mesh((1, 1, model), index, (
        sharding.Axis(None, 1, 0), sharding.Axis(None, 1, 0),
        sharding.Axis(None, model, index)))


@pytest.mark.parametrize("model_ranks", [2, 8])
def test_full_width_shard_keeps_whole_heads(model_ranks):
    """On the meta device at full width: each rank holds 40/M whole heads
    of 128 (q, k, v, k_img, v_img rows; o columns), 13824/M FFN units, the
    norms whole; and the de-interleaved RoPE order permutes within a head,
    so every rank's columns are the permutation of its own heads."""
    cfg = FusionConfig()
    with torch.device("meta"):
        model = FusionModel(cfg)
    model.shard(_fake_mesh(model_ranks, model_ranks - 1))
    blk = model.dit.blocks[0]
    width = cfg.dit.dim // model_ranks
    assert width % cfg.dit.head_dim == 0
    for lin in (blk.self_attn.q, blk.self_attn.k, blk.cross_attn.v,
                blk.cross_attn.k_img):
        assert tuple(lin.weight.shape) == (width, cfg.dit.dim)
        assert tuple(lin.bias.shape) == (width,)
    assert tuple(blk.self_attn.o.weight.shape) == (cfg.dit.dim, width)
    assert tuple(blk.self_attn.o.bias.shape) == (cfg.dit.dim,)
    assert tuple(blk.ffn[0].weight.shape) == (cfg.dit.ffn_dim // model_ranks,
                                              cfg.dit.dim)
    assert tuple(blk.ffn[2].weight.shape) == (cfg.dit.dim,
                                              cfg.dit.ffn_dim // model_ranks)
    assert tuple(blk.self_attn.norm_q.weight.shape) == (cfg.dit.dim,)
    assert blk.self_attn.tp.size == model_ranks
    assert len(model.param_parts) == 40 * 12 + 40 * 9
    idx = permute_qk_out_channels(np.arange(cfg.dit.dim), cfg.dit.head_dim)
    for r in range(model_ranks):
        cols = idx[r * width:(r + 1) * width]
        assert set(cols.tolist()) == set(range(r * width, (r + 1) * width))
    with pytest.raises(ValueError, match="do not split"):
        with torch.device("meta"):
            FusionModel(cfg).shard(_fake_mesh(3, 0))


@pytest.mark.parametrize("index", [0, 1])
def test_seeded_sharded_build_draws_the_unsharded_values(index):
    """build(mesh=...) with a seed: each part holds what the unsharded
    seeded build holds there, and the replicated tensors are equal."""
    fcfg, _ = chip_smoke.small_configs()
    whole = build(lambda: FusionModel(fcfg), device="cpu",
                  dtype=torch.float32,
                  generator=torch.Generator().manual_seed(4))
    part = build(lambda: FusionModel(fcfg), device="cpu",
                 dtype=torch.float32,
                 generator=torch.Generator().manual_seed(4),
                 mesh=_fake_mesh(2, index))
    sd = sharding.shard_state_dict(whole.state_dict(), _fake_mesh(2, index))
    got = part.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    assert part.dit.blocks[0].self_attn.q.weight.part_of == (0, index, 2)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 4, 2), (8, 1, 1)])
def test_rank_layout_is_the_jax_device_grid(shape):
    grid = np.asarray([d.id for d in jsh.make_mesh(*shape).devices.flat]
                      ).reshape(shape)
    for coords in np.ndindex(*shape):
        assert sharding.rank_of(coords, shape) == grid[coords]


def test_token_splits():
    """Frames split at frame boundaries, the first ranks one more; the
    streams scale by their tokens per frame."""
    axis = sharding.Axis(None, 4, 3)
    mesh = sharding.Mesh((1, 4, 1), 3, (sharding.Axis(None, 1, 0), axis,
                                        sharding.Axis(None, 1, 0)))
    frames = sharding.frame_split(21, mesh)
    assert frames.sizes == (6, 5, 5, 5) and frames.start == 16
    dit = frames.scaled(777)
    assert dit.length == 16317 and dit.local == 5 * 777
    assert frames.scaled(782).length == 16422
    t = torch.arange(2 * 16317).view(2, 16317)
    assert torch.equal(dit.take(t), t[:, 16 * 777:])
    with pytest.raises(ValueError, match="do not split"):
        sharding.frame_split(3, mesh)
    assert sharding.batch_rows(2, mesh) is None


def test_bootstrap_single_process_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize("cpu") is False
    info = distributed.runtime_info()
    assert info["world_size"] == 1 and not info["initialized"]
    assert sharding.make_mesh().trivial


@pytest.mark.parametrize("device,cards,want", [
    ("cuda", 2, "nccl"), ("cpu", 0, "gloo")])
def test_bootstrap_picks_the_backend(monkeypatch, device, cards, want):
    """Under torchrun's variables: NCCL for one rank per card, gloo for
    --device cpu."""
    seen = {}
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    assert distributed.initialize(device) is True
    assert seen["backend"] == want and seen["init_method"] == "env://"


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one"):
        distributed.initialize("cuda")


@pytest.mark.parametrize("key", sorted(chip_smoke.MESH_MODES),
                         ids=lambda k: f"{k[0]}_{'x'.join(map(str, k[1]))}"
                         f"{'_ulysses' * k[2]}")
def test_dispatch_matches_the_chip_check_mode_table(key):
    """chip_smoke.py writes out how each mesh's sequence-parallel
    attentions run (its expected launches follow that table, not the
    dispatch); the dispatch must agree: (DiT self at 1/M of the heads,
    VGGT global, bicross) over this config's latent frames (a window's
    for the windowed denoise's entries)."""
    from fantasy_world_tpu_torch.parallel import ulysses
    name, (d, s, m), uly = key
    cfg = (chip_smoke.small_configs()[0] if name.startswith("small")
           else FusionConfig())
    frames = chip_smoke.mesh_mode_frames(name)
    split = sharding.TokenSplit(
        None, tuple(len(c) for c in np.array_split(np.arange(frames), s)),
        0)
    heads = (cfg.dit.num_heads // m, cfg.vggt.aggregator.block_cfg.num_heads,
             cfg.bicross.num_heads)
    if s == 1:
        got = ("local",) * 3
    else:
        with ulysses.ulysses_context(object() if uly else None):
            got = tuple(ulysses.attention_mode(h, split, split)
                        for h in heads)
    assert got == chip_smoke.MESH_MODES[key]
