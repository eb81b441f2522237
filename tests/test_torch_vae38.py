"""The port's 38-block Wan2.2 VAE against the JAX package, in f32 on the
CPU: a random reference-layout state dict (``Wan2.2_VAE.pth``'s names)
goes through JAX ``convert_wan_vae38`` and straight into the port's
``WanVAE38`` (``load_into``); the pixel (un)shuffle, the parameter-free
shortcuts, the encode and decode, untiled and tiled, and the causal conv
split over time."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from fantasy_world_tpu.convert.wan_vae import convert_wan_vae38
from fantasy_world_tpu.models.wan import vae38 as jv38

from fantasy_world_tpu_torch.convert.checkpoint import _strip, load_into
from fantasy_world_tpu_torch.convert.from_jax import vae38_state_dict
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.wan import vae38 as v38
from fantasy_world_tpu_torch.models.wan.vae import RMSGamma
from fantasy_world_tpu_torch.ops import causal_conv

torch.set_num_threads(1)

# f32 on both sides: summation order only, relative to the largest
# magnitude of each output; the reshapes are exact
RTOL = 1e-4
# the tiny widths of tests/test_vae38.py, at the production z
J_CFG = jv38.VAE38Config(dim=16, dec_dim=16, z_dim=48)
CFG = v38.VAE38Config(dim=16, dec_dim=16, z_dim=48)


def _rel_max(got, want):
    a, b = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


@pytest.fixture(scope="module")
def pair():
    """The reference layout from a seed (RMS scales near 1, so the signal
    survives the depth), its JAX tree and the port's module loaded from
    it."""
    src = build(lambda: v38.WanVAE38(CFG), device="cpu", dtype=torch.float32,
                generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in src.modules():
            if isinstance(m, RMSGamma):
                m.gamma.copy_(1 + 0.1 * torch.randn(m.gamma.shape,
                                                    generator=g))
    sd = {"model." + k: v.clone() for k, v in src.state_dict().items()}
    tree = convert_wan_vae38({k: v.numpy() for k, v in sd.items()}, J_CFG)
    vae = build(lambda: v38.WanVAE38(CFG), device="cpu", dtype=torch.float32)
    load_into(vae, _strip(sd, ("model.",)), "vae38")
    return tree, vae.eval()


def test_state_dict_from_jax_tree(pair):
    tree, vae = pair
    got = vae38_state_dict(tree, vae)
    want = vae.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)


def test_patchify2_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 8, 12)).astype(
        np.float32)
    got = v38.patchify2(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), jv38.patchify2(jnp.asarray(x)))
    np.testing.assert_array_equal(v38.unpatchify2(got).numpy(), x)


@pytest.mark.parametrize("factor_t,factor_s,frames",
                         [(1, 2, 5), (2, 2, 5), (2, 2, 4), (1, 1, 3)])
def test_avg_down3d_matches_jax(factor_t, factor_s, frames):
    """Odd frame counts take the front zero pad."""
    x = np.random.default_rng(1).standard_normal(
        (1, 8, frames, 4, 6)).astype(np.float32)
    out = 16 if factor_t * factor_s * factor_s > 2 else 8
    got = v38.avg_down3d(torch.from_numpy(x), out, factor_t, factor_s)
    want = jv38.avg_down3d(jnp.asarray(x), out, factor_t, factor_s)
    assert _rel_max(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("factor_t,first_chunk",
                         [(2, True), (2, False), (1, True)])
def test_dup_up3d_matches_jax(factor_t, first_chunk):
    x = np.random.default_rng(2).standard_normal((1, 16, 3, 4, 6)).astype(
        np.float32)
    got = v38.dup_up3d(torch.from_numpy(x), 8, factor_t, 2, first_chunk)
    want = jv38.dup_up3d(jnp.asarray(x), 8, factor_t, 2, first_chunk)
    assert got.shape[2] == 3 * factor_t - (factor_t - 1) * first_chunk
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_matches_jax(pair):
    tree, vae = pair
    video = np.random.default_rng(3).uniform(
        -1, 1, (1, 3, 5, 64, 64)).astype(np.float32)
    want = jv38.vae38_encode(tree, J_CFG, jnp.asarray(video))
    with torch.no_grad():
        got = vae.encode(torch.from_numpy(video))
    assert tuple(got.shape) == (1, 48, 2, 4, 4)
    assert _rel_max(got.numpy(), want) <= RTOL


def test_decode_matches_jax(pair):
    tree, vae = pair
    z = np.random.default_rng(4).standard_normal((1, 48, 3, 4, 4)).astype(
        np.float32)
    want = jv38.vae38_decode(tree, J_CFG, jnp.asarray(z), clamp=False)
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z), clamp=False)
    assert tuple(got.shape) == (1, 3, 9, 64, 64)
    assert _rel_max(got.numpy(), want) <= RTOL


def test_tiled_encode_matches_jax(pair):
    """A 2 x 3 grid of 64 x 64 tiles over 96 x 128 pixels."""
    tree, vae = pair
    video = np.random.default_rng(5).uniform(
        -1, 1, (1, 3, 1, 96, 128)).astype(np.float32)
    kw = dict(tile_size=(4, 4), tile_stride=(2, 3))
    want = jv38.vae38_encode_tiled(tree, J_CFG, jnp.asarray(video), **kw)
    with torch.no_grad():
        got = v38.vae38_encode_tiled(vae, torch.from_numpy(video), **kw)
    assert tuple(got.shape) == (1, 48, 1, 6, 8)
    assert _rel_max(got.numpy(), want) <= RTOL


def test_tiled_decode_matches_jax(pair):
    tree, vae = pair
    z = np.random.default_rng(6).standard_normal((1, 48, 2, 6, 8)).astype(
        np.float32)
    kw = dict(tile_size=(4, 4), tile_stride=(2, 3))
    want = jv38.vae38_decode_tiled(tree, J_CFG, jnp.asarray(z), **kw)
    with torch.no_grad():
        got = v38.vae38_decode_tiled(vae, torch.from_numpy(z), **kw)
    assert tuple(got.shape) == (1, 3, 5, 96, 128)
    assert _rel_max(got.numpy(), want) <= RTOL


def test_causal_conv_split_over_time(pair, monkeypatch):
    """With the element limit cut to a few frames, every causal conv of
    the decode runs in pieces of the time axis: the same video."""
    _, vae = pair
    z = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 48, 3, 4, 4)).astype(np.float32))
    calls = []
    conv3d = torch.nn.functional.conv3d

    def counted(x, *a, **k):
        calls.append(tuple(x.shape[2:]))
        return conv3d(x, *a, **k)
    with torch.no_grad():
        whole = vae.decode(z, clamp=False)
        monkeypatch.setattr(causal_conv.F, "conv3d", counted)
        monkeypatch.setattr(causal_conv, "MAX_CONV_ELEMENTS", 16 * 64 * 64 * 4)
        split = vae.decode(z, clamp=False)
    # at the top resolution (32 x 32 after the unshuffle) a frame holds
    # up to 32 x 32 x 32 elements: pieces of 6 frames and their history
    # (the 16-channel convs there stay whole)
    top = [t for t, h, w in calls if w == 32]
    assert 6 + 2 in top
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)
    monkeypatch.setattr(causal_conv, "MAX_CONV_ELEMENTS", 16 * 64 * 64)
    with pytest.raises(ValueError, match="outgrows"):
        with torch.no_grad():
            vae.decode(z, clamp=False)


def test_shortcut_added_in_pieces(pair, monkeypatch):
    """The decoder's dup_up3d shortcut added one input frame at a time
    (the temporal stages trim their first frame): the same video."""
    _, vae = pair
    z = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 48, 3, 4, 4)).astype(np.float32))
    with torch.no_grad():
        whole = vae.decode(z, clamp=False)
        monkeypatch.setattr(v38, "SHORTCUT_PIECE", 1)
        pieces = vae.decode(z, clamp=False)
    np.testing.assert_array_equal(pieces.numpy(), whole.numpy())
