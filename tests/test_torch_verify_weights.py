"""The port's ``cli.convert`` and ``cli.verify_weights`` end to end with
``--device cpu`` (f32, the kernels' plain versions), on reduced reference
layouts written from a seed (``chip_smoke.py:write_reference_layout`` and
``write_wan22_layout``): the raw layout, a converted bundle, and
``--config_from``, for Wan2.1 and Wan2.2; the report's schema, which is
JAX ``cli/verify_weights.py``'s; a checkpoint missing a fusion tensor
exits 1 with the census failed; ``--file`` detection. Denoise latents of
the raw layout and of its bundle are equal (sha256 of the bytes)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from fantasy_world_tpu_torch.cli import convert as cconv
from fantasy_world_tpu_torch.cli import verify_weights as vw
from fantasy_world_tpu_torch.convert import bundle, checkpoint as ckpt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the denoise geometry: 8x12 latents, 2 latent frames
SMALL = ["--device", "cpu", "--height", "64", "--width", "96",
         "--frames", "5"]
WAN21_PHASES = ["load", "census:fusion", "finite", "bundle", "denoise",
                "heads"]


@pytest.fixture(scope="module")
def wan21(tmp_path_factory):
    root = tmp_path_factory.mktemp("wan21")
    wan, model = cs.write_reference_layout(str(root))
    out = cconv.main(["--variant", "wan21", "--wan_ckpt_path", wan,
                      "--model_ckpt", model, "--out",
                      str(root / "wan21.bundle"), "--dtype", "float32"])
    return {"root": root, "wan": wan, "model": model, "bundle": out}


@pytest.fixture(scope="module")
def wan22(tmp_path_factory):
    root = tmp_path_factory.mktemp("wan22")
    wan, high, low = cs.write_wan22_layout(str(root))
    out = cconv.main(["--variant", "wan22", "--wan_ckpt_path", wan,
                      "--model_ckpt_high", high, "--model_ckpt_low", low,
                      "--out", str(root / "wan22.bundle"),
                      "--dtype", "float32"])
    return {"root": root, "wan": wan, "high": high, "low": low,
            "bundle": out}


def _report(path):
    with open(path) as fh:
        return json.load(fh)


def _check_schema(rep, names):
    """JAX's report: variant, argv, config, ok, and per phase name, ok,
    wall_s, detail."""
    assert set(rep) >= {"variant", "phases", "argv", "config", "ok"}
    assert [p["name"] for p in rep["phases"]] == names
    for p in rep["phases"]:
        assert set(p) == {"name", "ok", "wall_s", "detail"}
        assert isinstance(p["wall_s"], float) and p["wall_s"] >= 0
    d = {p["name"]: p["detail"] for p in rep["phases"]}
    for name in names:
        if name.startswith("census:"):
            assert d[name]["n_missing"] == 0 and d[name]["n_unexpected"] == 0
            assert d[name]["n_shape_mismatch"] == 0 and d[name]["keys"] > 0
    assert d["finite"]["nonfinite"] == {}
    assert d["finite"]["scanned"] == d["finite"]["tensors"] > 0
    den = d["denoise"]
    assert den["latent_finite"] is True and den["steps"] == 2
    assert den["latent_shape"] == [1, 16, 2, 8, 12]
    heads = d["heads"]["heads"]
    assert heads["depth"]["positive"] is True
    assert heads["depth_conf"]["ge_one"] is True
    assert heads["world_points_conf"]["ge_one"] is True
    assert heads["pose_enc"]["finite"] is True
    return d


def test_convert_wan21_bundle_loads_like_the_layout(wan21):
    """The bundle's components and configs, and the pipeline it loads
    equal, tensor for tensor, the one the raw layout loads."""
    b = wan21["bundle"]
    assert bundle.is_bundle(b)
    assert bundle.bundle_components(b) == ["clip", "fusion", "pose", "t5",
                                           "vae"]
    raw_cfgs = ckpt.read_configs(wan21["wan"])
    got = bundle.load_bundle_configs(b)
    for k in ("fusion", "t5", "clip", "vae"):
        assert got[k] == raw_cfgs[k], k
    a = ckpt.load_pipeline(wan21["wan"], wan21["model"], device="cpu",
                           dtype=torch.float32)
    c = ckpt.load_pipeline(b, None, device="cpu", dtype=torch.float32)
    for name in ("fusion", "pose_encoder", "t5", "clip", "vae"):
        sa = getattr(a, name).state_dict()
        sc = getattr(c, name).state_dict()
        assert sa.keys() == sc.keys()
        for k in sa:
            assert torch.equal(sa[k], sc[k]), (name, k)
    assert ckpt.missing_files(b, None) == []


def test_verify_raw_layout_all_ok(wan21):
    """The raw layout with a bundle saved, reloaded and bit-compared; run
    in a fresh interpreter that imports no JAX."""
    rep_path = str(wan21["root"] / "report_raw.json")
    code = ("import sys\n"
            "from fantasy_world_tpu_torch.cli.verify_weights import main\n"
            "main(sys.argv[1:])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'fantasy_world_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code, "--variant", "wan21",
         "--wan_ckpt_path", wan21["wan"], "--model_ckpt", wan21["model"],
         "--out_bundle", str(wan21["root"] / "verified.bundle"),
         "--report", rep_path, *SMALL],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ALL OK" in res.stdout
    rep = _report(rep_path)
    assert rep["ok"] is True and rep["variant"] == "wan21"
    d = _check_schema(rep, WAN21_PHASES)
    assert d["bundle"]["bit_exact_reload"] is True
    assert bundle.is_bundle(d["bundle"]["path"])


def test_verify_bundle_and_config_from_all_ok(wan21):
    """The converted bundle, alone and with --config_from: every phase ok,
    the same latents as the raw layout's."""
    raw = vw.main(["--variant", "wan21", "--wan_ckpt_path", wan21["wan"],
                   "--model_ckpt", wan21["model"], "--report",
                   str(wan21["root"] / "r0.json"), *SMALL])
    names = [n for n in WAN21_PHASES if n != "bundle"]
    digests = {_check_schema(raw, names)["denoise"]["latent_sha256"]}
    for extra in ([], ["--config_from", wan21["bundle"]]):
        rep = vw.main(["--variant", "wan21", "--wan_ckpt_path",
                       wan21["bundle"], "--report",
                       str(wan21["root"] / "r1.json"), *SMALL, *extra])
        assert rep["ok"] is True
        digests.add(_check_schema(rep, names)["denoise"]["latent_sha256"])
    assert len(digests) == 1


def test_verify_catches_missing_fusion_tensor(wan21, tmp_path):
    """A fusion checkpoint missing one tensor: exit 1, the report written,
    the census the first phase to fail, naming the tensor."""
    sd = torch.load(wan21["model"], weights_only=True)
    gone = "IRGBlock.0.x_agg.norm1.weight"
    del sd[gone]
    bad = str(tmp_path / "model_bad.pth")
    torch.save(sd, bad)
    rep_path = str(tmp_path / "report_bad.json")
    with pytest.raises(SystemExit) as exc:
        vw.main(["--variant", "wan21", "--wan_ckpt_path", wan21["wan"],
                 "--model_ckpt", bad, "--report", rep_path, *SMALL])
    assert exc.value.code == 1
    rep = _report(rep_path)
    assert rep["ok"] is False
    failed = [p for p in rep["phases"] if not p["ok"]]
    assert failed[0]["name"] == "census:fusion"
    census = failed[0]["detail"]
    assert census["n_missing"] == 1
    assert census["missing"] == ["vggt.aggregator.global_blocks.0.norm1."
                                 "weight"]


def test_verify_wan22_raw_and_bundle(wan22):
    """Wan2.2: both experts' census (the Reward-LoRAs merged), finite,
    the dual-expert denoise and heads, on the raw layout and on its
    bundle (LoRAs merged at convert time): the same latents."""
    names = ["load", "census:fusion_high", "census:fusion_low", "finite",
             "denoise", "heads"]
    digests = set()
    for argv in (["--wan_ckpt_path", wan22["wan"], "--model_ckpt_high",
                  wan22["high"], "--model_ckpt_low", wan22["low"]],
                 ["--wan_ckpt_path", wan22["bundle"]]):
        rep = vw.main(["--variant", "wan22", *argv, "--report",
                       str(wan22["root"] / "r.json"), *SMALL])
        assert rep["ok"] is True
        d = _check_schema(rep, names)
        digests.add(d["denoise"]["latent_sha256"])
        assert "fusion_high" in d["load"]["components"]
    assert len(digests) == 1
    assert bundle.bundle_components(wan22["bundle"]) == [
        "fusion_high", "fusion_low", "t5", "vae"]


def test_verify_usage_errors(wan21, monkeypatch):
    with pytest.raises(SystemExit, match="--model_ckpt is required"):
        vw.main(["--wan_ckpt_path", wan21["wan"], *SMALL])
    with pytest.raises(SystemExit, match="not a bundle"):
        vw.main(["--wan_ckpt_path", wan21["wan"], "--model_ckpt",
                 wan21["model"], "--config_from", wan21["wan"], *SMALL])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        vw.main(["--wan_ckpt_path", wan21["bundle"]])


def test_convert_file_detects_by_hash(wan21, tmp_path):
    """``--file`` on the layout's base DiT shard, registered under its
    census: a bundle with the ``dit`` component (q/k permuted for the
    port) and its config; an unknown file is refused."""
    from fantasy_world_tpu_torch.convert import registry
    from fantasy_world_tpu_torch.convert.manager import ModelManager
    fcfg = ckpt.read_configs(wan21["wan"])["fusion"]
    shard = ckpt.dit_shards(wan21["wan"])[0]
    sd = ckpt.read_safetensors(shard)
    ov = {k: getattr(fcfg.dit, k) for k in (
        "dim", "in_dim", "ffn_dim", "out_dim", "text_dim", "num_heads",
        "num_layers", "has_image_input", "clip_feature_dim")}
    h = registry.hash_state_dict_keys(sd)
    registry.WAN_DIT_CONFIGS[h] = ov
    try:
        out = cconv.main(["--file", shard, "--out", str(tmp_path / "dit"),
                          "--dtype", "float32"])
        assert bundle.bundle_components(out) == ["dit"]
        cfg = bundle.load_bundle_configs(out)["dit"]
        assert cfg.dim == fcfg.dit.dim and cfg.has_image_input
        got = bundle.load_bundle(out)["dit"]
        mm = ModelManager("cpu", torch.float32)
        mm.load_model(shard)
        want = mm.fetch_params("wan_video_dit")
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    finally:
        del registry.WAN_DIT_CONFIGS[h]
    with pytest.raises(KeyError, match="unrecognized"):
        cconv.main(["--file", wan21["model"], "--out", str(tmp_path / "x")])
