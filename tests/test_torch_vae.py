"""The port's Wan VAE against the JAX package's: the full-sequence encode
and decode, and the tiled decode over an explicit small plan, on the same
``init_wan_vae`` weights (carried across with ``convert/from_jax.py``), in
f32 on the CPU; and the decode's refusal of a partial tile override."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from fantasy_world_tpu.models.wan import vae as jvae

from fantasy_world_tpu_torch.convert.from_jax import (encoder_config_from,
                                                      vae_state_dict)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.wan import vae as tvae
from fantasy_world_tpu_torch.pipelines.wan_video import FantasyWorldPipeline

torch.set_num_threads(1)

# f32 through 20 convolutions: summation order, relative to the largest
# magnitude of the output
RTOL = 1e-4
J_CFG = jvae.VAEConfig(dim=16, z_dim=16)


def _wake(tree, rng):
    """RMS scales near 1 instead of init's N(0, 0.02), so that every
    residual branch weighs in the output."""
    if isinstance(tree, dict):
        return {k: (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
            np.float32) if k == "gamma" else _wake(v, rng)
            for k, v in tree.items()}
    if isinstance(tree, list):
        return [_wake(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module")
def pair():
    params = _wake(jvae.init_wan_vae(5, J_CFG, jnp.float32),
                   np.random.default_rng(0))
    model = build(lambda: tvae.WanVAE(encoder_config_from(tvae.VAEConfig,
                                                          J_CFG)),
                  device="cpu", dtype=torch.float32)
    model.load_state_dict(vae_state_dict(params, model), strict=True)
    return params, model


def _rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = b.detach().numpy().astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


def test_encode_matches_jax(pair):
    params, model = pair
    video = np.random.default_rng(1).uniform(-1, 1, (1, 3, 5, 32, 48)
                                             ).astype(np.float32)
    want = jvae.vae_encode(params, J_CFG, jnp.asarray(video))
    with torch.no_grad():
        got = model.encode(torch.from_numpy(video))
    assert got.shape == (1, 16, 2, 4, 6)
    assert _rel_err(want, got) <= RTOL


def test_decode_matches_jax(pair):
    params, model = pair
    z = np.random.default_rng(2).standard_normal((1, 16, 2, 4, 6)).astype(
        np.float32)
    want = jvae.vae_decode(params, J_CFG, jnp.asarray(z))
    with torch.no_grad():
        got = model.decode(torch.from_numpy(z))
    assert got.shape == (1, 3, 5, 32, 48)
    assert _rel_err(want, got) <= RTOL


def test_tiled_decode_matches_jax(pair):
    params, model = pair
    z = np.random.default_rng(3).standard_normal((1, 16, 2, 12, 16)).astype(
        np.float32)
    tile, stride = (8, 10), (4, 6)
    want = jvae.vae_decode_tiled(params, J_CFG, jnp.asarray(z), tile, stride)
    with torch.no_grad():
        got = tvae.vae_decode_tiled(model, torch.from_numpy(z), tile, stride)
    assert _rel_err(want, got) <= RTOL
    frames = FantasyWorldPipeline(vae=model).decode_video(
        torch.from_numpy(z), tiled=True, tile_size=tile, tile_stride=stride)
    assert frames.shape == (5, 96, 128, 3) and frames.dtype == np.uint8


@pytest.mark.parametrize("override", [{"tile_size": (8, 10)},
                                      {"tile_stride": (4, 6)}])
def test_partial_tile_override_raises(pair, override):
    _, model = pair
    z = torch.zeros((1, 16, 2, 12, 16))
    with pytest.raises(ValueError, match="tile_size and tile_stride"):
        FantasyWorldPipeline(vae=model).decode_video(z, tiled=True,
                                                     **override)
    assert tvae.tile_plan(None, None) == ((30, 52), (15, 26))
