"""The port's ring attention (``parallel/ring.py``) against the JAX
package's on its virtual 8-device CPU mesh, and against the plain call.

Spawned gloo ranks on the CPU, world 2 and 4, in f32: an even split, a
ragged sequence with a head count Ulysses cannot split, cross attention
with Lk != Lq, a split whose short parts need the closed-form zero-pad
correction, a split where a rank holds no key (the gather path), and keys
split without the Ulysses context (the k/v gather). The JAX
``tests/test_ring.py`` cases."""
import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU, 8 virtual devices)
import jax.numpy as jnp

from fantasy_world_tpu.ops.attention import dot_product_attention
from fantasy_world_tpu.parallel.ring import ring_attention
from fantasy_world_tpu.parallel.sharding import make_mesh

import torch_mesh_workers as workers
from fantasy_world_tpu_torch.parallel.distributed import spawn

TOL = 1e-5
# name: (Lq, Lk, H, D, kind, kv split sizes at world 2 / 4 or None)
CASES = {
    "even": (256, 256, 8, 64, "ring", None),
    "ragged_heads": (251, 251, 3, 32, "ring", None),
    "cross": (130, 77, 5, 32, "ring", None),
    "tail_pad": (96, 77, 4, 32, "ring", {2: (60, 17), 4: (30, 30, 16, 1)}),
    "pure_pad": (64, 77, 4, 32, "ring", {2: (77, 0), 4: (40, 37, 0, 0)}),
    "gather": (100, 90, 4, 32, "gather", None),
}


def _inputs(name):
    Lq, Lk, H, D = CASES[name][:4]
    rng = np.random.default_rng(10 + sorted(CASES).index(name))
    return (rng.standard_normal((2, Lq, H, D)).astype(np.float32),
            rng.standard_normal((2, Lk, H, D)).astype(np.float32),
            rng.standard_normal((2, Lk, H, D)).astype(np.float32))


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"ring{world}")
    arrays = {}
    for name, (*_, kind, sizes) in CASES.items():
        for x, a in zip("qkv", _inputs(name)):
            arrays[f"{name}/{x}"] = a
        arrays[f"{name}/kind"] = np.asarray(kind)
        if sizes:
            arrays[f"{name}/kv_sizes"] = np.asarray(sizes[world])
    np.savez(tmp / "cases.npz", **arrays)
    spawn(workers.attention_cases, world, str(tmp / "cases.npz"),
          str(tmp / "out.npz"))
    with np.load(tmp / "out.npz", allow_pickle=True) as out:
        return world, {k: out[k] for k in out.files}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_jax_and_plain(ranks, name):
    world, out = ranks
    q, k, v = (jnp.asarray(a) for a in _inputs(name))
    plain = np.asarray(dot_product_attention(q, k, v, backend="xla"))
    jax_ring = np.asarray(ring_attention(q, k, v, mesh=make_mesh(
        data=1, seq=world), backend="xla"))
    got = out[f"{name}/o"]
    assert got.shape == plain.shape
    np.testing.assert_allclose(got, jax_ring, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, plain, rtol=TOL, atol=TOL)
    if name == "gather":
        assert str(out[f"{name}/mode"]) == "gather"


def test_ranks_load_no_jax(ranks):
    assert list(ranks[1]["foreign"]) == []
