"""The port's Ulysses attention (``parallel/ulysses.py``) against the JAX
package's on its virtual 8-device CPU mesh, and against the plain call.

Ranks are spawned gloo processes on the CPU (one per seq rank, each holding
its token split of q, k and v); the JAX side runs in this process on
``make_mesh(seq=n)``. In f32 at world 2 and 4: an even split, a ragged
sequence, cross attention with Lk != Lq, a head count that does not divide
(the ring takes over), and the context dispatch of ``dot_product_attention``
(the JAX ``tests/test_ulysses.py`` cases)."""
import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU, 8 virtual devices)
import jax.numpy as jnp

from fantasy_world_tpu.ops.attention import dot_product_attention
from fantasy_world_tpu.parallel.sharding import make_mesh
from fantasy_world_tpu.parallel.ulysses import ulysses_attention

import torch_mesh_workers as workers
from fantasy_world_tpu_torch.parallel.distributed import spawn

TOL = 1e-5
# name: (Lq, Lk, H, D, kind)
CASES = {
    "even": (256, 256, 8, 64, "ulysses"),
    "ragged": (251, 251, 8, 32, "ulysses"),
    "cross": (130, 77, 8, 32, "ulysses"),
    "heads_not_dividing": (120, 120, 3, 32, "ulysses"),
    "dispatch": (64, 64, 8, 32, "dispatch"),
}


def _inputs(name):
    Lq, Lk, H, D, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    return (rng.standard_normal((2, Lq, H, D)).astype(np.float32),
            rng.standard_normal((2, Lk, H, D)).astype(np.float32),
            rng.standard_normal((2, Lk, H, D)).astype(np.float32))


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, tmp_path_factory):
    """Every case through ``world`` spawned ranks, in one spawn."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"ulysses{world}")
    arrays = {}
    for name, (*_, kind) in CASES.items():
        for x, a in zip("qkv", _inputs(name)):
            arrays[f"{name}/{x}"] = a
        arrays[f"{name}/kind"] = np.asarray(kind)
    np.savez(tmp / "cases.npz", **arrays)
    spawn(workers.attention_cases, world, str(tmp / "cases.npz"),
          str(tmp / "out.npz"))
    with np.load(tmp / "out.npz", allow_pickle=True) as out:
        return world, {k: out[k] for k in out.files}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ulysses_matches_jax_and_plain(ranks, name):
    world, out = ranks
    q, k, v = (jnp.asarray(a) for a in _inputs(name))
    plain = np.asarray(dot_product_attention(q, k, v, backend="xla"))
    jax_uly = np.asarray(ulysses_attention(q, k, v, mesh=make_mesh(
        data=1, seq=world), backend="xla"))
    got = out[f"{name}/o"]
    assert got.shape == plain.shape
    np.testing.assert_allclose(got, jax_uly, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, plain, rtol=TOL, atol=TOL)
    if name == "dispatch":
        assert str(out[f"{name}/mode"]) == "ulysses"


def test_ranks_load_no_jax(ranks):
    """A spawned rank imports torch and the port, nothing of JAX."""
    assert list(ranks[1]["foreign"]) == []
