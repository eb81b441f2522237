"""The port's conditioning encoders against the JAX package: prompt
cleaning, the bicubic resample matrix, umT5 with a padding mask and the
prompt zeroing, and CLIP with its preprocessing; the same weights (a JAX
``init_*`` tree carried across with ``convert/from_jax.py``) and the same
seeded inputs, in f32 on the CPU."""
import json
import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from fantasy_world_tpu.models.fusion.model import FusionConfig as JFusionCfg
from fantasy_world_tpu.models.wan import clip as jclip
from fantasy_world_tpu.models.wan import t5 as jt5
from fantasy_world_tpu.ops.bicubic import bicubic_matrix as jbicubic
from fantasy_world_tpu.pipelines.wan_video import FantasyWorldPipeline as JPipe

from fantasy_world_tpu_torch.convert.from_jax import (clip_state_dict,
                                                      encoder_config_from,
                                                      t5_state_dict)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.wan.clip import (CLIPVision,
                                                     CLIPVisionConfig,
                                                     preprocess_image)
from fantasy_world_tpu_torch.models.wan.t5 import T5Config, T5Encoder
from fantasy_world_tpu_torch.ops.bicubic import bicubic_matrix
from fantasy_world_tpu_torch.pipelines.wan_video import FantasyWorldPipeline
from fantasy_world_tpu_torch.utils.textclean import clean_prompt, fix_text

torch.set_num_threads(1)

# f32 on both sides; summation order only, relative to the largest
# magnitude of the output
RTOL = 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "textclean_golden.json")
# the umT5 config of tests/test_encoders.py
J_T5_CFG = jt5.T5Config(vocab=100, dim=64, dim_attn=64, dim_ffn=128,
                        num_heads=4, num_layers=2)
J_CLIP_CFG = jclip.CLIPVisionConfig(dim=64, num_heads=4, num_layers=3)


def _rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach().numpy() if torch.is_tensor(b) else b,
                   np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


def test_textclean_golden():
    """Every case of the golden file, and the prompt cleaning that the
    tokenizer path applies."""
    with open(GOLDEN) as fh:
        doc = json.load(fh)
    bad = [c for c in doc["cases"] if fix_text(c["input"]) != c["expected"]]
    assert not bad, bad[:3]
    assert clean_prompt("  a &amp;  scenic\tvalley ") == "a & scenic valley"


@pytest.mark.parametrize("n_in,n_out", [(336, 224), (592, 224), (64, 224),
                                        (96, 224), (300, 150), (7, 3)])
def test_bicubic_matrix_equals_jax(n_in, n_out):
    np.testing.assert_array_equal(bicubic_matrix(n_in, n_out),
                                  jbicubic(n_in, n_out))


@pytest.fixture(scope="module")
def t5_pair():
    params = jt5.init_t5(3, J_T5_CFG, jnp.float32)
    cfg = encoder_config_from(T5Config, J_T5_CFG)
    model = build(lambda: T5Encoder(cfg), device="cpu", dtype=torch.float32)
    model.load_state_dict(t5_state_dict(params, model), strict=True)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, J_T5_CFG.vocab, (2, 23))
    mask = np.ones((2, 23), np.int64)
    mask[1, 11:] = 0
    return params, model, ids, mask


def test_t5_matches_jax(t5_pair):
    params, model, ids, mask = t5_pair
    want = jt5.t5_encode(params, J_T5_CFG, jnp.asarray(ids, jnp.int32),
                         jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert _rel_err(want, got) <= RTOL


def test_encode_prompt_zeroes_past_length(t5_pair):
    params, model, ids, mask = t5_pair
    jpipe = JPipe(cfg=JFusionCfg(), params={"t5": params}, t5_cfg=J_T5_CFG)
    want = jpipe.encode_prompt(ids=ids, mask=mask)
    got = FantasyWorldPipeline(t5=model).encode_prompt(ids=ids, mask=mask)
    assert _rel_err(want, got) <= RTOL
    assert not got[1, 11:].any() and got[1, :11].abs().min() > 0


def test_clip_matches_jax():
    """preprocess_image + the 31-of-32-block tower (here 2 of 3) on a
    64x96 image."""
    params = jclip.init_clip_vision(4, J_CLIP_CFG, jnp.float32)
    cfg = encoder_config_from(CLIPVisionConfig, J_CLIP_CFG)
    model = build(lambda: CLIPVision(cfg), device="cpu", dtype=torch.float32)
    model.load_state_dict(clip_state_dict(params, model), strict=True)
    img = np.random.default_rng(1).uniform(-1, 1, (1, 3, 64, 96)).astype(
        np.float32)
    jin = jclip.preprocess_image(jnp.asarray(img))
    tin = preprocess_image(torch.from_numpy(img))
    assert _rel_err(jin, tin) <= RTOL
    want = jclip.clip_encode_image(params, J_CLIP_CFG, jin)
    with torch.no_grad():
        got = model(tin)
    assert got.shape == (1, 257, 64)
    assert _rel_err(want, got) <= RTOL
