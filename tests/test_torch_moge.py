"""The port's MoGe-2 against the JAX package, in f32 on the CPU: the forward
(at the input's own grid, downsampled with antialias, upsampled), the
inference's focal, shift, depth and mask, the scene-scale normalization of
a camera path with it, and the checkpoint loader against ``convert_moge``
on a state dict written in the reference layout."""
import dataclasses

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from fantasy_world_tpu.cli.moge_scale import (
    moge_scale_normalize as j_scale_normalize)
from fantasy_world_tpu.convert.moge import convert_moge
from fantasy_world_tpu.models.moge import infer as jinfer
from fantasy_world_tpu.models.moge import model as jmoge

from fantasy_world_tpu_torch.cli.moge_scale import moge_scale_normalize
from fantasy_world_tpu_torch.convert.from_jax import moge_state_dict
from fantasy_world_tpu_torch.convert.moge import load_moge
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.moge.infer import moge_infer
from fantasy_world_tpu_torch.models.moge.model import (DINOv2Config, MoGe,
                                                       MoGeConfig)

torch.set_num_threads(1)

# f32 on both sides through 4 ViT blocks and the conv stacks: summation
# order, relative L2 over each output
RTOL = 1e-4
J_CFG = jmoge.MoGeConfig(
    encoder=jmoge.DINOv2Config(dim=64, depth=4, num_heads=1, pos_grid=6),
    intermediate_layers=(0, 1, 2, 3), dim_proj_out=32,
    dim_res_blocks=(32, 24, 16, 16, 8), scale_head_dims=(64, 32, 32, 1))
CFG = MoGeConfig(
    encoder=DINOv2Config(dim=64, depth=4, num_heads=1, pos_grid=6),
    intermediate_layers=(0, 1, 2, 3), dim_proj_out=32,
    dim_res_blocks=(32, 24, 16, 16, 8), scale_head_dims=(64, 32, 32, 1))


def _wake(params, rng):
    """Nonzero biases, so that every add is exercised."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                        if k == "bias" else walk(v)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree
    return walk(params)


INFER_IMAGE = np.random.default_rng(2).uniform(0, 1, (48, 64, 3)).astype(
    np.float32)


@pytest.fixture(scope="module")
def moge():
    params = _wake(jmoge.init_moge(0, J_CFG, jnp.float32),
                   np.random.default_rng(0))
    # centre the mask logits on the inference image, so that about half of
    # its pixels are masked out
    p = np.asarray(jmoge.moge_forward(
        params, J_CFG, jnp.asarray(INFER_IMAGE.transpose(2, 0, 1)[None]),
        40)["mask"], np.float64)
    out = params["mask_head"]["output_blocks"][-1]
    out["bias"] = out["bias"] - np.float32(np.median(np.log(p / (1 - p))))
    model = build(lambda: MoGe(CFG), device="cpu", dtype=torch.float32)
    model.load_state_dict(moge_state_dict(params, model), strict=True)
    return params, model


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("hw,num_tokens", [
    ((70, 98), 35),      # the input is base x 14: no resize; output down
    ((120, 160), 24),    # larger than base x 14: antialiased downsample
    ((40, 52), 30),      # smaller: upsampled
])
def test_moge_forward_matches_jax(moge, hw, num_tokens):
    params, model = moge
    img = np.random.default_rng(1).uniform(0, 1, (1, 3) + hw).astype(
        np.float32)
    want = jmoge.moge_forward(params, J_CFG, jnp.asarray(img), num_tokens)
    with torch.no_grad():
        got = model(torch.from_numpy(img), num_tokens)
    assert set(got) == set(want) == {"points", "mask", "normal",
                                     "metric_scale"}
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert _rel(got[k].numpy(), want[k]) <= RTOL, (k, _rel(
            got[k].numpy(), want[k]))


def test_moge_infer_matches_jax(moge):
    """Focal and shift through the same LM solve, depth, points, mask and
    intrinsics."""
    params, model = moge
    image = INFER_IMAGE
    want = jinfer.moge_infer(params, J_CFG, image, num_tokens=40)
    got = moge_infer(model, image, num_tokens=40)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert want["mask"].any() and not want["mask"].all()
    np.testing.assert_allclose(got["intrinsics"], want["intrinsics"],
                               rtol=1e-4)
    m = want["mask"]
    for k in ("depth", "points"):
        assert np.array_equal(np.isinf(got[k]), np.isinf(want[k])), k
        assert _rel(got[k][m], want[k][m]) <= RTOL, k


def test_scale_normalize_with_moge_matches_jax(moge):
    """The camera path scaled by MoGe's depth, as the sampler does it."""
    params, model = moge
    rng = np.random.default_rng(3)
    image = INFER_IMAGE
    S = 5
    extr = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    extr[:, :3, 3] = rng.standard_normal((S, 3)) * 2
    intr = np.tile(np.array([[50, 0, 32], [0, 50, 24], [0, 0, 1]],
                            np.float32), (S, 1, 1))
    want = j_scale_normalize(image, extr, intr, moge_infer=lambda im:
                             jinfer.moge_infer(params, J_CFG, im,
                                               num_tokens=40))
    got = moge_scale_normalize(image, extr, intr, moge_infer=lambda im:
                               moge_infer(model, im, num_tokens=40))
    plain = moge_scale_normalize(image, extr, intr)
    assert not np.allclose(got, plain)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("normal_head", [True, False])
def test_moge_loader_matches_convert_moge(moge, tmp_path, normal_head):
    """A checkpoint in the reference layout ({"model": state dict}, with
    DINOv2's unused mask_token) loads tensor for tensor as JAX's
    ``convert_moge`` reads it; the architecture, the normal head among
    it, is read off the tensors."""
    _, model = moge
    sd = {k: v.clone() for k, v in model.state_dict().items()
          if normal_head or not k.startswith("normal_head.")}
    sd["encoder.backbone.mask_token"] = torch.zeros(1, 64)
    path = tmp_path / "moge.pt"
    torch.save({"model": sd, "model_config": {}}, path)
    got = load_moge(str(path), device="cpu", dtype=torch.float32)
    assert got.cfg == dataclasses.replace(CFG, with_normal_head=normal_head)
    jcfg = dataclasses.replace(J_CFG, with_normal_head=normal_head)
    tree = convert_moge({k: v.numpy() for k, v in sd.items()}, jcfg)
    assert ("normal_head" in tree) == normal_head
    want = moge_state_dict(tree, got)
    state = got.state_dict()
    assert set(state) == set(want)
    bad = [k for k in state if not torch.equal(state[k], want[k])]
    assert not bad, bad[:5]
