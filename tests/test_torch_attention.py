"""The port's attention (its plain PyTorch version, which a CPU tensor
takes) against the JAX package: the Pallas flash-attention kernels in
interpret mode and the XLA reference path, on the same seeded inputs."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from fantasy_world_tpu.ops import flash_attention as jfa
from fantasy_world_tpu.ops.attention import _xla_attention
from fantasy_world_tpu_torch.ops import flash_attention as fa
from fantasy_world_tpu_torch.ops.attention import dot_product_attention

torch.set_num_threads(1)

# f32 on both sides: the only differences are summation order and exp2
# (port, Pallas) vs exp (XLA) -- a few f32 ulps of outputs of magnitude ~1
ATOL = 1e-5

# (Lq, Lk, H, D, JAX block_k, the port's route). A shrunk block_k makes the
# JAX side sweep several key blocks with a ragged tail; the port's route
# follows _flash_forward's rule with its 2048-key one-block limit.
CASES = [
    (200, 300, 2, 64, 128, "d64"),        # JAX paired kernel, 3 key blocks
    (129, 127, 2, 48, None, "d64"),       # padded head dim, ragged both
    (37, 53, 4, 64, None, "d64"),
    (100, 81, 2, 128, None, "onekv"),     # camera-trunk-like
    (130, 513, 2, 96, 256, "onekv"),      # JAX generic over 3 key blocks
    (50, 300, 3, 64, None, "onekv"),      # odd H: no pairing
    (70, 2100, 1, 128, None, "generic"),  # JAX generic, ragged 2nd block
    (65, 2049, 3, 96, 1024, "generic"),
]


@pytest.mark.parametrize("lq,lk,h,d,block_k,route", CASES)
def test_plain_attention_matches_jax(lq, lk, h, d, block_k, route):
    rng = np.random.default_rng(lq * 7 + lk)
    q, k, v = (rng.standard_normal((1, n, h, d)).astype(np.float32)
               for n in (lq, lk, lk))
    assert fa.route(h, d, lk) == route
    out = dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert out.shape == (1, lq, h, d) and out.dtype == torch.float32

    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        pallas = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), block_k=block_k)
    xla = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         d ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), rtol=0,
                               atol=ATOL)
    assert not any(fa.LAUNCHES.values())


def test_plain_attention_chunks_queries():
    """Chunking over query rows (the production shapes on the card) gives
    the unchunked result, for strided q/k/v views too."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(
        rng.standard_normal((2, 97, 3, 4, 32)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    whole = fa.attention_plain(q, k, v, 0.2)
    chunked = fa.attention_plain(q, k, v, 0.2, chunk_elems=2 * 4 * 97 * 10)
    # the matmul may block a 10-row chunk differently: f32 ulps only
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)


def test_attention_without_a_kernel_raises():
    """Only the CPU takes the plain version; any other device launches a
    kernel or raises -- there is no fallback."""
    q = torch.zeros((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError):
        dot_product_attention(q, q, q)
    with pytest.raises(ValueError):
        fa.launch("d64", torch.zeros((1, 8, 2, 64)), torch.zeros((1, 8, 2, 64)),
                  torch.zeros((1, 8, 2, 64)), 0.125)
