"""The port's attention statistics and gradients (their plain PyTorch
versions, which CPU tensors take) against the JAX package: the Pallas
stats forward and custom-VJP backward in interpret mode, and the XLA
reference path, on the same seeded inputs."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fantasy_world_tpu.ops import flash_attention as jfa
from fantasy_world_tpu.ops.attention import (_xla_attention,
                                             _xla_attention_stats)
from fantasy_world_tpu_torch.ops import flash_attention as fa
from fantasy_world_tpu_torch.ops.attention import (attention_with_stats,
                                                   dot_product_attention)

torch.set_num_threads(1)

# f32 on both sides: summation order and exp2 vs exp -- a few f32 ulps of
# values of magnitude ~1. l is a sum of up to Lk terms >= 1, so it is held
# to the same bound relative to its size.
ATOL = 1e-5
# the JAX package's own bound for its backward against jax.grad of the XLA
# path (tests/test_flash_grad.py)
GRAD_TOL = 2e-3

# (Lq, Lk, H, D, JAX block_k): one key block, several with a ragged tail,
# padded head dims, odd H
STATS_CASES = [
    (200, 300, 2, 64, 128),
    (129, 127, 2, 48, None),
    (100, 81, 2, 128, None),
    (130, 513, 2, 96, 256),
    (70, 2100, 1, 128, None),
]

# tests/test_flash_grad.py's cases: (Lq, Lk, H, D, JAX block_q, block_k)
GRAD_CASES = [
    (256, 256, 2, 128, 128, 128),     # aligned, several key blocks
    (200, 300, 1, 64, 128, 128),      # ragged, padded head dim on the TPU
    (130, 513, 2, 96, 128, 256),      # ragged everything
    (128, 100, 2, 128, 128, 128),     # one key block (onekv)
    (140, 140, 4, 64, 1024, None),    # D 64, even H (the paired route)
]


def _inputs(seed, lq, lk, h, d, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, L, h, d)).astype(np.float32)
            for L in (lq, lk, lk, lq)[:n]]


@pytest.mark.parametrize("lq,lk,h,d,block_k", STATS_CASES)
def test_stats_match_jax(lq, lk, h, d, block_k):
    q, k, v = _inputs(lq + lk, lq, lk, h, d)
    o, m2, l = attention_with_stats(*(torch.from_numpy(a) for a in (q, k, v)))
    assert m2.shape == l.shape == (1, lq, h)
    assert m2.dtype == l.dtype == torch.float32
    with pltpu.force_tpu_interpret_mode():
        pallas = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     block_k=block_k, return_stats=True)
    xla = _xla_attention_stats(*(jnp.asarray(a) for a in (q, k, v)),
                               d ** -0.5)
    for ref in (pallas, xla):
        ro, rm2, rl = (np.asarray(r) for r in ref)
        np.testing.assert_allclose(o.numpy(), ro, rtol=0, atol=ATOL)
        np.testing.assert_allclose(m2.numpy(), rm2, rtol=0, atol=ATOL)
        np.testing.assert_allclose(l.numpy(), rl, rtol=ATOL, atol=0)
    assert not any(fa.LAUNCHES.values())


def _jax_grads(fn, q, k, v, do):
    return jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * do),
                    argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("lq,lk,h,d,bq,bk", GRAD_CASES)
def test_grads_match_jax(lq, lk, h, d, bq, bk):
    q, k, v, do = _inputs(7, lq, lk, h, d, n=4)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = dot_product_attention(tq, tk, tv)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    xla = _jax_grads(lambda q, k, v: _xla_attention(q, k, v, scale),
                     jq, jk, jv, jdo)
    with pltpu.force_tpu_interpret_mode():
        pallas = _jax_grads(lambda q, k, v: jfa.flash_attention(
            q, k, v, scale=scale, block_q=bq, block_k=bk), jq, jk, jv, jdo)
    for ref in (pallas, xla):
        for g, r, name in zip((tq, tk, tv), ref, "qkv"):
            np.testing.assert_allclose(g.grad.numpy(), np.asarray(r),
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=f"d{name}")
    assert not any(fa.LAUNCHES.values())


def test_backward_plain_chunks_and_strided_views():
    """Chunking over query rows (dk/dv summed across chunks) and a fused
    qkv view give the unchunked, contiguous result."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(
        rng.standard_normal((2, 97, 3, 4, 32)).astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((2, 97, 4, 32)).astype(
        np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, m2, l = fa.attention_plain_stats(q, k, v, 0.2)
    lse2 = m2 + torch.log2(l)
    whole = fa.attention_backward_plain(q.contiguous(), k.contiguous(),
                                        v.contiguous(), o, lse2, do, 0.2)
    chunked = fa.attention_backward_plain(q, k, v, o, lse2, do, 0.2,
                                          chunk_elems=2 * 4 * 97 * 10)
    for a, b in zip(chunked, whole):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_plain_function_gradcheck():
    """FlashAttention's plain forward and backward in f64 at a tiny ragged
    shape, against finite differences."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, n, 3, 8), generator=g, dtype=torch.float64,
                           requires_grad=True) for n in (7, 5, 5))
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_attention(q, k, v, scale=0.3), (q, k, v))


def test_dispatch_without_grad_takes_the_forward():
    """No grad (denoise): the plain forward, no autograd node; the same
    values as the Function's forward."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 20, 30, 2, 16))
    plain = dot_product_attention(q, k, v)
    assert plain.grad_fn is None
    with torch.no_grad():
        assert dot_product_attention(q.requires_grad_(), k, v).grad_fn is None
    graded = dot_product_attention(q, k, v)
    assert graded.grad_fn is not None
    torch.testing.assert_close(graded.detach(), plain, rtol=0, atol=0)
