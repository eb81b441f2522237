"""The port's Wan2.2 TI2V-5B DiT path against the JAX package, in f32 on
the CPU: the per-token time embedding, the two-row separated timestep
(``SplitTokens``) against the scalar path, the standalone forward with and
without the fused first frame, ``denoise_ti2v`` with the JAX noise handed
across (frame 0 clamped to the clean latent), and a reference-layout state
dict through JAX ``convert_wan_dit`` and the port's loader. Weights: a JAX
``init_wan_dit`` tree carried across by ``convert/from_jax.py``."""
import dataclasses

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax
import jax.numpy as jnp

from fantasy_world_tpu.convert.wan_dit import convert_wan_dit
from fantasy_world_tpu.models.wan import dit as jdit
from fantasy_world_tpu.pipelines.ti2v import denoise_ti2v as j_denoise_ti2v

from fantasy_world_tpu_torch.convert.checkpoint import (_dit_permuted_names,
                                                        _permute,
                                                        dit_state_dict_from,
                                                        load_into)
from fantasy_world_tpu_torch.convert.from_jax import (dit_state_dict,
                                                      encoder_config_from)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.wan.dit import (TI2V_5B, SplitTokens,
                                                    WanDiT, WanDiTConfig)
from fantasy_world_tpu_torch.pipelines.ti2v import denoise_ti2v

torch.set_num_threads(1)

# f32 on both sides: summation order only, relative to the largest
# magnitude of each output (the denoise: 3 CFG-pair steps)
RTOL = 1e-4
DENOISE_RTOL = 1e-3
# the tiny configuration of tests/test_separated_timestep.py
TINY = dict(dim=96, in_dim=8, ffn_dim=128, out_dim=8, text_dim=32,
            freq_dim=64, eps=1e-6, patch_size=(1, 2, 2), num_heads=4,
            num_layers=2, has_image_input=False, require_vae_embedding=False,
            seperated_timestep=True, fuse_vae_embedding_in_latents=True)
J_CFG = jdit.WanDiTConfig(**TINY)
CFG = encoder_config_from(WanDiTConfig, J_CFG)
F_LAT, H_LAT, W_LAT = 3, 4, 6          # latent frames and grid
N0 = (H_LAT // 2) * (W_LAT // 2)       # tokens of latent frame 0


def _rel_max(got, want):
    a, b = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


def _module(sd):
    m = build(lambda: WanDiT(CFG), device="cpu", dtype=torch.float32)
    m.load_state_dict(sd, strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def pair():
    tree = jdit.init_wan_dit(0, J_CFG, jnp.float32)
    m = build(lambda: WanDiT(CFG), device="cpu", dtype=torch.float32)
    return tree, _module(dit_state_dict(tree, m))


def _inputs(seed, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 8, F_LAT, H_LAT, W_LAT)).astype(
        np.float32)
    ctx = rng.standard_normal((batch, 12, 32)).astype(np.float32)
    return x, ctx


def test_ti2v_config_is_the_registry_entry():
    """The port's copy of the JAX registry's TI2V-5B entry."""
    from fantasy_world_tpu.convert.registry import WAN_DIT_CONFIGS
    want = WAN_DIT_CONFIGS["1f5ab7703c6fc803fdded85ff040c316"]
    got = dataclasses.asdict(TI2V_5B)
    assert {k: got[k] for k in want} == dict(want)


def test_per_token_time_embedding_matches_jax(pair):
    """(B, L) timesteps, 0 on frame 0 and t on the rest: t and t_mod of
    every token, and the two rows of ``time_embed_split``."""
    tree, m = pair
    ts = np.where(np.arange(F_LAT * N0) < N0, 0.0, 437.0)[None].astype(
        np.float32)
    jt, jt_mod = jdit.time_embedding(tree, J_CFG, jnp.asarray(ts))
    with torch.no_grad():
        t, t_mod = m.time_embed(torch.from_numpy(ts))
        st, st_mod = m.time_embed_split(torch.tensor([437.0]), N0)
    assert tuple(t_mod.shape) == (1, F_LAT * N0, 6, 96)
    assert _rel_max(t.numpy(), jt) <= RTOL
    assert _rel_max(t_mod.numpy(), jt_mod) <= RTOL
    assert st.n0 == N0 and tuple(st_mod.rows.shape) == (1, 2, 6, 96)
    for row, token in ((0, 0), (1, N0)):
        assert _rel_max(st.rows[:, row].numpy(), jt[:, token]) <= RTOL
        assert _rel_max(st_mod.rows[:, row].numpy(),
                        jt_mod[:, token]) <= RTOL


def test_constant_per_token_equals_scalar_path(pair):
    """Both rows at the same t: the split path through the blocks and the
    head equals the scalar path; and JAX's per-token path with a constant
    timestep equals the port's scalar one."""
    tree, m = pair
    x, ctx = _inputs(1)
    ts = np.array([437.0, 437.0], np.float32)
    with torch.no_grad():
        tok, grid = m.patchify(torch.from_numpy(x))
        c = m.text_embed(torch.from_numpy(ctx))
        from fantasy_world_tpu_torch.ops import rope as rope_ops
        cos, sin = rope_ops.cos_sin_half_from_angles(
            rope_ops.build_angles_3d(CFG.head_dim, *grid))
        t, t_mod = m.time_embed(torch.from_numpy(ts))
        split = (SplitTokens(torch.stack([t, t], 1), N0),
                 SplitTokens(torch.stack([t_mod, t_mod], 1), N0))
        outs = []
        for tt, tm in ((t, t_mod), split):
            h = tok
            for blk in m.blocks:
                h = blk(h, c, tm, cos, sin)
            outs.append(m.head(h, tt).numpy())
        scalar = m(torch.from_numpy(x), torch.from_numpy(ts),
                   torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-6)
    tok_j, t_j, t_mod_j, ctx_j, grid_j, (cos_j, sin_j) = jdit.prepare_inputs(
        tree, J_CFG, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
    tsl = jnp.full((2, F_LAT * N0), 437.0, jnp.float32)
    t_l, t_mod_l = jdit.time_embedding(tree, J_CFG, tsl)
    for bp in tree["blocks"]:
        tok_j = jdit.dit_block_apply(bp, tok_j, ctx_j, t_mod_l, cos_j, sin_j,
                                     J_CFG)
    want = jdit.unpatchify(J_CFG, jdit.head_apply(tree, J_CFG, tok_j, t_l),
                           grid_j)
    assert _rel_max(scalar, want) <= RTOL


@pytest.mark.parametrize("fuse", [False, True])
def test_forward_matches_jax(pair, fuse):
    """``WanDiT.forward`` against ``wan_dit_forward``, with the first frame
    fused (frame-0 tokens at t = 0) and without."""
    tree, m = pair
    x, ctx = _inputs(2)
    ts = np.array([437.0, 911.0], np.float32)
    want = jdit.wan_dit_forward(tree, J_CFG, jnp.asarray(x), jnp.asarray(ts),
                                jnp.asarray(ctx), fuse_first_frame=fuse)
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(ts),
                torch.from_numpy(ctx), fuse_first_frame=fuse)
    assert tuple(got.shape) == (2, 8, F_LAT, H_LAT, W_LAT)
    assert _rel_max(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("fuse", [False, True])
def test_denoise_ti2v_matches_jax(pair, fuse):
    """3 steps at 64x96, 9 frames; the JAX PRNG's noise handed to the
    port; frame 0 held at the clean latent after the loop when fused."""
    tree, m = pair
    rng = np.random.default_rng(3)
    ctx_p, ctx_n = (rng.standard_normal((1, 12, 32)).astype(np.float32)
                    for _ in range(2))
    first = (rng.standard_normal((1, 8, 1, H_LAT, W_LAT)).astype(np.float32)
             if fuse else None)
    kw = dict(num_frames=9, num_inference_steps=3, cfg_scale=5.0, seed=7)
    want = j_denoise_ti2v(
        tree, J_CFG, jnp.asarray(ctx_p), jnp.asarray(ctx_n), 64, 96,
        first_frame_latents=None if first is None else jnp.asarray(first),
        **kw)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(7),
                                         (1, 8, F_LAT, H_LAT, W_LAT),
                                         jnp.float32))
    calls = []
    got = denoise_ti2v(m, torch.from_numpy(ctx_p), torch.from_numpy(ctx_n),
                       64, 96, noise=torch.from_numpy(noise),
                       first_frame_latents=(None if first is None else
                                            torch.from_numpy(first)),
                       progress_callback=lambda *a: calls.append(a), **kw)
    assert calls == [(1, 3), (2, 3), (3, 3)]
    assert _rel_max(got.numpy(), want) <= DENOISE_RTOL
    if fuse:
        np.testing.assert_array_equal(got[:, :, :1].numpy(), first)
    # the seeded draw is the torch generator's, of the same shape
    seeded = denoise_ti2v(m, torch.from_numpy(ctx_p), torch.from_numpy(ctx_n),
                          64, 96, num_frames=8, num_inference_steps=1,
                          seed=7)
    assert tuple(seeded.shape) == (1, 8, F_LAT, H_LAT, W_LAT)


def test_reference_layout_dit_loads(pair):
    """A reference-layout state dict (interleaved q/k columns, random
    values everywhere so the RoPE permutation shows) through JAX
    ``convert_wan_dit`` and through ``dit_state_dict_from`` + ``load_into``:
    the same forward."""
    _, m = pair
    g = torch.Generator().manual_seed(4)
    sd = {k: torch.randn(v.shape, generator=g) * 0.2
          for k, v in m.state_dict().items()}
    for name, hd in _dit_permuted_names(CFG):
        sd[name] = _permute(sd[name], hd, inverse=True)
    tree = convert_wan_dit({k: v.numpy() for k, v in sd.items()}, J_CFG)
    fresh = build(lambda: WanDiT(CFG), device="cpu", dtype=torch.float32)
    load_into(fresh, dit_state_dict_from(sd, CFG), "ti2v dit")
    x, ctx = _inputs(5)
    ts = np.array([437.0, 437.0], np.float32)
    want = jdit.wan_dit_forward(tree, J_CFG, jnp.asarray(x), jnp.asarray(ts),
                                jnp.asarray(ctx), fuse_first_frame=True)
    with torch.no_grad():
        got = fresh(torch.from_numpy(x), torch.from_numpy(ts),
                    torch.from_numpy(ctx), fuse_first_frame=True)
    assert _rel_max(got.numpy(), want) <= RTOL
