"""The port's weights tooling against the JAX package, on the CPU: the
registry's hashes over the port's full-width modules built on the meta
device, ``detect`` and ``configio`` against JAX's, the FLF2V DiT (514 CLIP
tokens, 769 text keys) against JAX's, DiTs loaded by ``ModelManager``
against JAX's ``ModelManager`` on the same file, the local resolution of
checkpoint directories and the bundle."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from fantasy_world_tpu.convert import manager as jmanager
from fantasy_world_tpu.convert import registry as jregistry
from fantasy_world_tpu.models.fusion.model import FusionConfig as JFusionCfg
from fantasy_world_tpu.models.wan import dit as jdit
from fantasy_world_tpu.utils import configio as jconfigio

from fantasy_world_tpu_torch.convert import bundle, checkpoint as ckpt
from fantasy_world_tpu_torch.convert import registry
from fantasy_world_tpu_torch.convert.downloader import (ModelConfig,
                                                        resolve_ckpt_dir)
from fantasy_world_tpu_torch.convert.from_jax import (
    dit_state_dict, encoder_config_from, fusion_config_from)
from fantasy_world_tpu_torch.convert.manager import (ModelManager,
                                                     _translate_dit_config,
                                                     from_model_configs)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
from fantasy_world_tpu_torch.models.wan import dit as pdit
from fantasy_world_tpu_torch.models.wan.clip import (CLIPVision,
                                                     CLIPVisionConfig)
from fantasy_world_tpu_torch.models.wan.t5 import T5Config, T5Encoder
from fantasy_world_tpu_torch.models.wan.vae import VAEConfig, WanVAE
from fantasy_world_tpu_torch.utils import configio

torch.set_num_threads(1)

# f32 on both sides: summation order only, relative to the largest
# magnitude of the output
RTOL = 1e-4


def _meta(ctor):
    with torch.device("meta"):
        return ctor().state_dict()


# ---------------------------------------------------------------------------
# the registry at full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h", sorted(registry.WAN_DIT_CONFIGS))
def test_full_width_dit_census_is_the_registry_hash(h):
    """Each registry DiT entry, built at full width on the meta device: the
    md5 of the port's state-dict census (the reference file's names and
    shapes, so no persistent buffer and no name of the port's own) is the
    entry's hash, and ``detect`` gives the entry back."""
    cfg = pdit.WanDiTConfig(**_translate_dit_config(
        registry.WAN_DIT_CONFIGS[h]))
    sd = _meta(lambda: pdit.WanDiT(cfg))
    assert registry.hash_state_dict_keys(sd) == h
    name, overrides = registry.detect(sd)
    assert name == "wan_video_dit"
    assert overrides is registry.WAN_DIT_CONFIGS[h]


@pytest.mark.parametrize("which", ["t5", "vae"])
def test_full_width_encoder_census_is_the_registry_hash(which):
    """umT5-XXL and the Wan2.1 VAE at full width (the VAE's file keys are
    the module's without ``model.``, as the port's are)."""
    if which == "t5":
        sd = _meta(lambda: T5Encoder(T5Config()))
        assert registry.hash_state_dict_keys(sd) == registry.WAN_T5_HASH
        assert registry.detect(sd)[0] == "wan_video_text_encoder"
    else:
        sd = _meta(lambda: WanVAE(VAEConfig()))
        assert registry.hash_state_dict_keys(sd) in (
            registry.WAN21_VAE_HASH, registry.WAN21_VAE_HASH_ALT)
        assert registry.detect(sd)[0] == "wan_video_vae"


def test_clip_census_needs_the_text_tower():
    """The CLIP file holds the XLM-RoBERTa text tower (``textual.*``)
    beside ``visual.*``; the port builds only the visual tower, so its
    census cannot give ``WAN_CLIP_HASH``, and ``detect`` refuses it rather
    than guess. The loaders take CLIP by its file name instead, and read
    only ``visual.*``."""
    sd = {"visual." + k: v
          for k, v in _meta(lambda: CLIPVision(CLIPVisionConfig())).items()}
    assert registry.hash_state_dict_keys(sd) != registry.WAN_CLIP_HASH
    with pytest.raises(KeyError, match="unrecognized"):
        registry.detect(sd)


def test_registry_tables_equal_jax():
    assert registry.WAN_DIT_CONFIGS == jregistry.WAN_DIT_CONFIGS
    for name in ("WAN_T5_HASH", "WAN_CLIP_HASH", "WAN21_VAE_HASH",
                 "WAN21_VAE_HASH_ALT"):
        assert getattr(registry, name) == getattr(jregistry, name)


def test_detect_matches_jax():
    """The same dicts through both ``detect``s: every DiT entry, umT5, the
    VAE, a nested dict and an unknown census (numpy stand-ins: only keys
    and shapes count)."""
    dicts = []
    for h, ov in registry.WAN_DIT_CONFIGS.items():
        cfg = pdit.WanDiTConfig(**_translate_dit_config(ov))
        dicts.append(_meta(lambda cfg=cfg: pdit.WanDiT(cfg)))
    dicts.append(_meta(lambda: T5Encoder(T5Config())))
    dicts.append(_meta(lambda: WanVAE(VAEConfig())))
    for sd in dicts:
        fake = {k: np.broadcast_to(np.float16(0), tuple(v.shape))
                for k, v in sd.items()}
        assert registry.detect(sd) == jregistry.detect(fake)
        assert registry.state_dict_census(sd) == \
            jregistry.state_dict_census(fake)
    nested = {"a": {"w": np.zeros((2, 3))}, "b": np.zeros(4), "c": 1.0}
    assert registry.hash_state_dict_keys(nested) == \
        jregistry.hash_state_dict_keys(nested)
    for mod in (registry, jregistry):
        with pytest.raises(KeyError, match="unrecognized"):
            mod.detect({"x": np.zeros((1,))})


# ---------------------------------------------------------------------------
# configio
# ---------------------------------------------------------------------------

def _j_fusion_cfg():
    from fantasy_world_tpu.utils.demo import demo_config
    cfg = demo_config(dim=64, layers=3, start_index=1, agg_dim=64,
                      text_dim=32, plucker_dim=48, clip_feature_dim=64)
    return dataclasses.replace(cfg, cross_attention_list=(0, 1))


def test_configio_round_trips_against_jax():
    """``config_to_dict`` of equal configs is the same dict in both
    packages, and each package's ``config_from_dict`` rebuilds its config
    from the other's dict (nested configs, tuples, Optional)."""
    import json
    from fantasy_world_tpu.models.wan import t5 as jt5, vae as jvae
    jf = _j_fusion_cfg()
    pf = fusion_config_from(jf)
    pairs = [(jf, pf, JFusionCfg, FusionConfig),
             (jt5.T5Config(num_layers=3), T5Config(num_layers=3),
              jt5.T5Config, T5Config),
             (jvae.VAEConfig(dim=16), VAEConfig(dim=16), jvae.VAEConfig,
              VAEConfig)]
    for jc, pc, jcls, pcls in pairs:
        jd = json.loads(json.dumps(jconfigio.config_to_dict(jc)))
        pd = json.loads(json.dumps(configio.config_to_dict(pc)))
        assert pd == jd
        assert configio.config_from_dict(pcls, jd) == pc
        assert jconfigio.config_from_dict(jcls, pd) == jc
    # a partial dict keeps the nested default that differs from its class's
    got = configio.config_from_dict(FusionConfig, {"start_index": 3})
    assert got.dit.camera_adapter_end == FusionConfig().dit.camera_adapter_end
    assert got.start_index == 3


def test_read_configs_reads_the_bundle_schema(tmp_path):
    cfg = fusion_config_from(_j_fusion_cfg())
    path = bundle.save_bundle({"fusion": {"w": torch.ones(2)}},
                              tmp_path / "b", configs={"fusion": cfg})
    assert ckpt.read_configs(path)["fusion"] == cfg
    assert bundle.load_bundle_configs(path)["fusion"] == cfg


# ---------------------------------------------------------------------------
# FLF2V
# ---------------------------------------------------------------------------

FLF2V = dict(dim=64, in_dim=12, ffn_dim=96, out_dim=4, text_dim=32,
             freq_dim=32, num_heads=4, num_layers=2, has_image_input=True,
             has_image_pos_emb=True, clip_feature_dim=48)


def test_flf2v_dit_matches_jax(monkeypatch):
    """The FLF2V DiT (``has_image_pos_emb``) on the start and end images'
    514 CLIP tokens and 512 text tokens: ``img_emb.emb_pos`` (random, so
    it shows) is added before ``norm_in``, and the split stays at 257, so
    the text cross-attention runs over 257 + 512 = 769 keys, as JAX's."""
    jcfg = jdit.WanDiTConfig(**FLF2V)
    tree = jdit.init_wan_dit(0, jcfg, jnp.float32)
    rng = np.random.default_rng(1)
    tree["img_emb"]["emb_pos"] = rng.standard_normal(
        (1, 514, 48)).astype(np.float32)
    cfg = encoder_config_from(pdit.WanDiTConfig, jcfg)
    m = build(lambda: pdit.WanDiT(cfg), device="cpu", dtype=torch.float32)
    m.load_state_dict(dit_state_dict(tree, m), strict=True)
    assert tuple(m.img_emb.emb_pos.shape) == (1, 514, 48)
    x = rng.standard_normal((2, 4, 2, 4, 4)).astype(np.float32)
    y = rng.standard_normal((2, 8, 2, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 512, 32)).astype(np.float32)
    clip = rng.standard_normal((2, 514, 48)).astype(np.float32)
    ts = np.array([311.0, 733.0], np.float32)
    want = np.asarray(jdit.wan_dit_forward(
        tree, jcfg, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
        clip_feature=jnp.asarray(clip), y=jnp.asarray(y)))
    keys = []
    real = pdit.dot_product_attention

    def spy(q, k, v, **kw):
        keys.append(k.shape[1])
        return real(q, k, v, **kw)
    monkeypatch.setattr(pdit, "dot_product_attention", spy)
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(ts),
                torch.from_numpy(ctx), clip_feature=torch.from_numpy(clip),
                y=torch.from_numpy(y)).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= RTOL, err
    # per block: self over 2 x 2 x 2 tokens, text over 769 keys, image
    # over 257
    assert keys == [8, 769, 257] * FLF2V["num_layers"]


# ---------------------------------------------------------------------------
# ModelManager
# ---------------------------------------------------------------------------

TINY_DITS = {
    "i2v": dict(dim=64, in_dim=12, ffn_dim=96, out_dim=4, text_dim=32,
                freq_dim=32, num_heads=4, num_layers=2, has_image_input=True,
                clip_feature_dim=48, patch_size=(1, 2, 2)),
    "ti2v": dict(dim=96, in_dim=8, ffn_dim=128, out_dim=8, text_dim=32,
                 freq_dim=64, num_heads=4, num_layers=2,
                 has_image_input=False, require_vae_embedding=False,
                 seperated_timestep=True, fuse_vae_embedding_in_latents=True,
                 patch_size=(1, 2, 2)),
}


@pytest.mark.parametrize("kind", sorted(TINY_DITS))
def test_model_manager_dit_matches_jax(kind, tmp_path, monkeypatch):
    """A tiny DiT written in the reference layout (interleaved q/k
    columns, random values everywhere) and registered under its census
    hash in both registries: the port's ``ModelManager`` (from the file,
    from a directory of shards and from the dict in memory) and JAX's
    ``ModelManager`` (from the file) give the same config and forward."""
    ov = TINY_DITS[kind]
    cfg = pdit.WanDiTConfig(**ov)
    g = torch.Generator().manual_seed(3)
    sd = {k: torch.randn(v.shape, generator=g) * 0.2
          for k, v in _meta(lambda: pdit.WanDiT(cfg)).items()}
    ref_sd = ckpt.dit_reference_state_dict(sd, cfg)
    h = registry.hash_state_dict_keys(ref_sd)
    monkeypatch.setitem(registry.WAN_DIT_CONFIGS, h, ov)
    monkeypatch.setitem(jregistry.WAN_DIT_CONFIGS, h, ov)
    path = str(tmp_path / "dit.safetensors")
    ckpt.write_safetensors(path, ref_sd)
    shards = tmp_path / "shards"
    shards.mkdir()
    names = sorted(ref_sd)
    for i, part in enumerate((names[::2], names[1::2])):
        ckpt.write_safetensors(str(shards / f"s{i}.safetensors"),
                               {k: ref_sd[k] for k in part})

    mm = ModelManager("cpu", torch.float32)
    assert mm.load_models([path, str(shards), ref_sd]) == ["wan_video_dit"] * 3
    (pcfg, m), *rest = mm.fetch_model("wan_video_dit", index=3)
    for _, other in rest:
        for k, v in m.state_dict().items():
            assert torch.equal(other.state_dict()[k], v), k
    assert torch.equal(mm.fetch_params("wan_video_dit")[
        "blocks.0.self_attn.q.weight"], sd["blocks.0.self_attn.q.weight"])
    jm = jmanager.ModelManager()
    assert jm.load_model(path) == "wan_video_dit"
    jcfg, tree = jm.fetch_model("wan_video_dit")
    assert dataclasses.asdict(pcfg) == {
        k: (tuple(v) if isinstance(v, list) else v)
        for k, v in dataclasses.asdict(jcfg).items()}

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, ov["in_dim"] if kind == "ti2v" else 4, 3,
                             4, 6)).astype(np.float32)
    ctx = rng.standard_normal((2, 12, 32)).astype(np.float32)
    ts = np.array([437.0, 911.0], np.float32)
    kw_np = {}
    if kind == "i2v":
        kw_np = dict(clip_feature=rng.standard_normal((2, 257, 48)).astype(
            np.float32), y=rng.standard_normal((2, 8, 3, 4, 6)).astype(
            np.float32))
    else:
        kw_np = dict(fuse_first_frame=True)
    want = np.asarray(jdit.wan_dit_forward(
        tree, jcfg, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw_np.items()}))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(ts),
                torch.from_numpy(ctx),
                **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                   for k, v in kw_np.items()}).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= RTOL, err


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_model_manager_defaults_to_the_card(tmp_path):
    """Without a device the manager (and ``from_model_configs`` without a
    manager) loads on the card, so with no card it raises; the CPU is
    asked for by name, as the tests do."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelManager()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_model_configs([])
    cfg = pdit.WanDiTConfig(**TINY_DITS["i2v"])
    sd = ckpt.dit_reference_state_dict(
        {k: torch.zeros(v.shape) for k, v in
         _meta(lambda: pdit.WanDiT(cfg)).items()}, cfg)
    path = str(tmp_path / "dit.safetensors")
    ckpt.write_safetensors(path, sd)
    h = registry.hash_state_dict_keys(sd)
    registry.WAN_DIT_CONFIGS[h] = TINY_DITS["i2v"]
    try:
        mm = from_model_configs([ModelConfig(path=path)],
                                ModelManager("cpu", torch.float32))
    finally:
        del registry.WAN_DIT_CONFIGS[h]
    _, m = mm.fetch_model("wan_video_dit")
    assert next(m.parameters()).device.type == "cpu"
    assert next(m.parameters()).dtype == torch.float32


def test_model_manager_fetch_errors():
    mm = ModelManager("cpu", torch.float32)
    with pytest.raises(KeyError, match="not loaded"):
        mm.fetch_model("wan_video_dit")
    with pytest.raises(KeyError, match="unrecognized"):
        mm.load_model({"x": torch.zeros(1)})


# ---------------------------------------------------------------------------
# local resolution, bundles
# ---------------------------------------------------------------------------

def test_resolve_ckpt_dir_is_local(tmp_path):
    """The directory itself when it holds the layout or a bundle, else the
    preset's directory beside it, else FileNotFoundError naming the preset
    and the directory; nothing is fetched."""
    have = tmp_path / "have"
    have.mkdir()
    (have / "diffusion_pytorch_model-00001-of-00001.safetensors").write_bytes(
        b"")
    assert resolve_ckpt_dir(str(have)) == str(have)
    preset = tmp_path / "Wan2.1-I2V-14B-480P"
    preset.mkdir()
    (preset / "models_t5_umt5-xxl-enc-bf16.pth").write_bytes(b"")
    assert resolve_ckpt_dir(str(tmp_path / "elsewhere")) == str(preset)
    with pytest.raises(FileNotFoundError) as exc:
        resolve_ckpt_dir(str(tmp_path / "none"),
                         "Wan2.2-Fun-A14B-Control-Camera")
    msg = str(exc.value)
    assert "Wan2.2-Fun-A14B-Control-Camera" in msg
    assert str(tmp_path / "none") in msg
    assert "nothing is downloaded" in msg


def test_model_config_globs_local_files(tmp_path):
    d = tmp_path / "Org" / "Model" / "sub"
    d.mkdir(parents=True)
    for n in ("a.safetensors", "b.safetensors"):
        (d / n).write_bytes(b"")
    mc = ModelConfig(model_id="Org/Model",
                     origin_file_pattern="sub/*.safetensors",
                     local_model_path=str(tmp_path))
    mc.download_if_necessary()
    assert mc.path == [str(d / "a.safetensors"), str(d / "b.safetensors")]
    folder = ModelConfig(model_id="Org/Model", origin_file_pattern="sub/",
                         local_model_path=str(tmp_path))
    folder.download_if_necessary()
    assert folder.path == os.path.join(str(tmp_path), "Org/Model", "sub/")
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        ModelConfig(model_id="Org/None", origin_file_pattern="x.pth",
                    local_model_path=str(tmp_path)).download_if_necessary()


def test_bundle_round_trip(tmp_path):
    """Components round-trip bit for bit in their dtypes (a cast when
    asked); a missing component raises; the manifest marks a bundle."""
    comps = {"fusion": {"w": torch.randn(3, 4).bfloat16(),
                        "n": torch.arange(5)},
             "vae": {"b": torch.randn(7)}}
    path = bundle.save_bundle(comps, tmp_path / "b")
    assert bundle.is_bundle(path) and not bundle.is_bundle(str(tmp_path))
    back = bundle.load_bundle(path)
    assert sorted(back) == ["fusion", "vae"]
    for name, sd in comps.items():
        for k, v in sd.items():
            assert back[name][k].dtype == v.dtype
            assert torch.equal(back[name][k], v)
    assert sorted(bundle.load_bundle(path, ["vae"])) == ["vae"]
    with pytest.raises(KeyError, match="lacks"):
        bundle.load_bundle(path, ["fusion", "clip"])
    cast = bundle.save_bundle(comps, tmp_path / "c", dtype=torch.float32)
    got = bundle.load_bundle(cast)["fusion"]
    assert got["w"].dtype == torch.float32 and got["n"].dtype == torch.int64
