"""The port's denoise slice as a whole against the JAX pipeline: the same
weights (a JAX ``init_fusion`` tree carried across with ``from_jax``), the
same conditioning and the same torch-seeded noise, 3 steps with the
geometry heads on the last."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from __graft_entry__ import _demo_config
from fantasy_world_tpu.hostops.camera import (cameras_json_to_camera_list,
                                              plucker_from_pose_encoding)
from fantasy_world_tpu.hostops.geometry import extri_intri_to_pose_encoding
from fantasy_world_tpu.models.fusion.model import init_fusion
from fantasy_world_tpu.pipelines.wan_video import FantasyWorldPipeline as JPipe

from fantasy_world_tpu_torch.chipcheck.inputs import (check_outputs,
                                                      conditioning,
                                                      small_configs)
from fantasy_world_tpu_torch.chipcheck.launches import expected_launches
from fantasy_world_tpu_torch.convert.from_jax import (fusion_config_from,
                                                      fusion_state_dict)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.hostops.camera import (load_camera_json,
                                                    plucker_from_cameras)
from fantasy_world_tpu_torch.models.fusion.model import FusionModel
from fantasy_world_tpu_torch.ops import flash_attention as fa
from fantasy_world_tpu_torch.pipelines.wan_video import FantasyWorldPipeline

torch.set_num_threads(1)

# f32 on both sides through 3 DiT blocks, 2 VGGT block pairs, the heads
# and 3 Euler steps: summation-order differences, relative to the largest
# magnitude of each output
RTOL = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERAS = os.path.join(REPO, "examples", "cameras", "camera_data.json")


def _wake(params, rng):
    """Random values for the zero-initialised gates so they contribute."""
    for b in params["bicross"]:
        for k in ("gamma_m1", "gamma_m2"):
            b[k] = rng.standard_normal(b[k].shape).astype(np.float32) * 0.5
    for blk in params["dit"]["blocks"]:
        if "camera" in blk:
            fc2 = blk["camera"]["v_group2"]["fc2"]
            fc2["kernel"] = rng.standard_normal(
                fc2["kernel"].shape).astype(np.float32) * 0.05
    ch = params["vggt"]["camera_head"]["camera_time_upsample"]
    ch["kernel"] = rng.standard_normal(ch["kernel"].shape).astype(
        np.float32) * 0.05
    return params


@pytest.fixture(scope="module")
def pipes():
    cfg = _demo_config(dim=64, layers=3, start_index=1, agg_dim=64)
    params = _wake(init_fusion(0, cfg, jnp.float32),
                   np.random.default_rng(0))
    model = build(lambda: FusionModel(fusion_config_from(cfg)), device="cpu",
                  dtype=torch.float32)
    sd = fusion_state_dict(params, model)
    result = model.load_state_dict(sd, strict=True)
    return {"jax": JPipe(cfg=cfg, params={"fusion": params}),
            "torch": FantasyWorldPipeline(model), "sd": sd,
            "model": model, "load": result}


def _conditioning(f, h, w):
    rng = np.random.default_rng(1)
    return (rng.standard_normal((1, 16, 4096)).astype(np.float32),
            rng.standard_normal((1, 16, 4096)).astype(np.float32) * 0.1,
            rng.standard_normal((1, 257, 1280)).astype(np.float32),
            rng.standard_normal((1, 20, f, h // 8, w // 8)).astype(np.float32),
            rng.standard_normal((1, f * (h // 16) * (w // 16), 2048)
                                ).astype(np.float32) * 0.1)


def test_denoise_matches_jax(pipes):
    f, h, w = 2, 64, 64
    nf = 4 * (f - 1) + 1
    cond = _conditioning(f, h, w)
    jl, jpred = pipes["jax"].denoise(
        *(jnp.asarray(c) for c in cond[:4]), h, w, num_frames=nf,
        num_inference_steps=3, seed=7, plucker_fea=jnp.asarray(cond[4]),
        torch_compat_noise=True)
    fa.reset_launch_counts()
    tl, tpred = pipes["torch"].denoise(
        *(torch.from_numpy(c) for c in cond[:4]), h, w, num_frames=nf,
        num_inference_steps=3, seed=7, plucker_fea=torch.from_numpy(cond[4]))
    # the CPU path runs the plain versions only
    assert not any(fa.LAUNCHES.values())
    assert set(tpred) == set(jpred) == {"pose_enc", "depth", "depth_conf",
                                        "world_points", "world_points_conf"}
    for name, a, b in [("latents", jl, tl)] + [
            (k, jpred[k], tpred[k]) for k in sorted(jpred)]:
        a, b = np.asarray(a, np.float64), b.numpy().astype(np.float64)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)
        assert err <= RTOL, (name, err)


def test_from_jax_loads_strictly(pipes):
    """Every key of the port is written and nothing else; the fp32 island
    stays f32."""
    result = pipes["load"]
    assert not result.missing_keys and not result.unexpected_keys
    assert set(pipes["sd"]) == set(pipes["model"].state_dict())
    m = build(lambda: FusionModel(pipes["model"].cfg), device="meta",
              dtype=torch.bfloat16)
    assert m.vggt.time_embedding[0].weight.dtype == torch.float32
    assert m.vggt.time_projection[1].weight.dtype == torch.float32
    assert m.dit.blocks[0].self_attn.q.weight.dtype == torch.bfloat16


def test_port_never_imports_jax(tmp_path):
    """The port and chip_smoke.py import nothing of JAX or of the JAX
    package (checked in a fresh interpreter: this one has JAX loaded),
    with the samplers, the loaders, MoGe, the Wan2.2 pipeline, the
    quantization, TeaCache, the server, both inference CLIs, the serve
    CLI, the data readers, build_train_batch, the trainer,
    make_camera_json, the 38-block VAE, the conditioning units, the TI2V
    denoise, the temporal tiler, the convert and verify_weights CLIs with
    the registry, ModelManager, bundles and local resolution, the track
    head, the DDIM and continuous-ODE schedules, and the fusion, bicross,
    aggregator and DiT modules of the single-card options, and the mesh
    layer (``parallel.distributed``, ``sharding``, ``ulysses``, ``ring``,
    ``pipeline``), ``training.pp``, the RE10K pose processor and
    ``hostops.geometry_train`` among the modules, the card check's
    option set-up (``chipcheck``) and the CLIs' argument
    checks run (their mesh checks too, the serve CLI's among them); and a
    rank it spawns (two gloo processes, the collectives of the mesh
    serving path, with the serve CLI, the samplers and the Wan2.2 pipeline
    loaded) loads neither."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fantasy_world_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('sampler', 'convert.checkpoint', 'cli.infer_wan21',"
        " 'cli.infer_wan22', 'models.moge.model', 'models.moge.infer',"
        " 'convert.moge', 'convert.lora', 'pipelines.wan_video_22',"
        " 'core.quant', 'pipelines.tea_cache', 'serving.server',"
        " 'cli.serve', 'data.video', 'data.re10k', 'hostops.rotation',"
        " 'training.data', 'cli.train', 'cli.make_camera_json',"
        " 'models.wan.vae38', 'pipelines.units', 'pipelines.ti2v',"
        " 'pipelines.temporal_tiler', 'cli.convert', 'cli.verify_weights',"
        " 'models.vggt.track', 'convert.registry', 'convert.manager',"
        " 'convert.bundle', 'convert.downloader', 'utils.configio',"
        " 'schedulers.ddim', 'schedulers.continuous_ode',"
        " 'models.fusion.bicross', 'models.fusion.model',"
        " 'models.vggt.aggregator', 'models.wan.dit',"
        " 'parallel.distributed', 'parallel.sharding', 'parallel.ulysses',"
        " 'parallel.ring', 'hostops.geometry_train', 'training.pp',"
        " 'parallel.pipeline'):\n"
        "    assert 'fantasy_world_tpu_torch.' + m in sys.modules, m\n"
        "from fantasy_world_tpu_torch.cli import infer_wan21, infer_wan22\n"
        "for main, extra in ((infer_wan21.main, ['--model_ckpt', 'n.pth']),"
        " (infer_wan22.main, ['--model_ckpt_high', 'h.pth',"
        " '--model_ckpt_low', 'l.pth'])):\n"
        "    try:\n"
        "        main(['--wan_ckpt_path', 'nowhere', '--image_path', 'x',"
        " '--camera_json_path', 'y', '--prompt', 'p', '--output_dir', 'o',"
        " '--device', 'cpu'] + extra)\n"
        "    except SystemExit as e:\n"
        "        assert 'checkpoint files missing' in str(e), e\n"
        "    try:\n"
        "        main(['--wan_ckpt_path', 'nowhere', '--image_path', 'x',"
        " '--camera_json_path', 'y', '--prompt', 'p', '--output_dir', 'o',"
        " '--device', 'cpu', '--mesh_model', '2'] + extra)\n"
        "    except SystemExit as e:\n"
        "        assert 'needs 2 processes' in str(e), e\n"
        "from fantasy_world_tpu_torch.cli import serve\n"
        "try:\n"
        "    serve.main(['--ckpt_dir', 'nowhere', '--model_ckpt', 'n.pth',"
        " '--device', 'cpu', '--mesh_model', '2'])\n"
        "except SystemExit as e:\n"
        "    assert 'needs 2 processes' in str(e), e\n"
        "import chip_smoke\n"
        "from fantasy_world_tpu_torch.chipcheck import inputs, small\n"
        "inputs.small_configs()\n"
        "inputs.small_clip_configs()\n"
        "inputs.small_wan22_configs()\n"
        "inputs.small_ti2v_configs()\n"
        "small.small_options_setup()\n"
        "inputs.pose_encodings(64, 96, 9)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'fantasy_world_tpu' or m.startswith('fantasy_world_tpu.')]"
        "\n"
        "assert not bad, bad\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_mesh_workers\n"
        "from fantasy_world_tpu_torch.parallel.distributed import spawn\n"
        "spawn(torch_mesh_workers.report_modules, 2, sys.argv[1])\n"
        "assert open(sys.argv[1]).read() == '', open(sys.argv[1]).read()\n"
        "print('clean', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "rank_modules.txt")], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


def test_plucker_matches_jax_hostops():
    """The port's host camera path equals the JAX package's (the sampler's
    prepare_camera with using_scale=False) on the example camera path."""
    import json
    H, W, n = 48, 80, 9
    with open(CAMERAS) as fh:
        jcams = cameras_json_to_camera_list(json.load(fh), image_size=(H, W))
    jcams = jcams[:n]
    intr = np.stack([[[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1]]
                     for c in jcams]).astype(np.float32)
    extr = np.stack([c.w2c_mat for c in jcams]).astype(np.float32)
    ref = plucker_from_pose_encoding(
        extri_intri_to_pose_encoding(extr[:, :3, :], intr, (H, W)), (H, W))
    got = plucker_from_cameras(load_camera_json(CAMERAS, (H, W), n), (H, W))
    assert got.shape == ref.shape == (1, n, H, W, 6)
    np.testing.assert_array_equal(got, ref)


def test_launch_count_contract(monkeypatch):
    """chip_smoke's expected launch counts are the routes the denoise takes:
    recorded at the reduced widths it checks on the card (every route), and
    (88, 80, 48) per step plus 16 trunk launches at full size."""
    import fantasy_world_tpu_torch.ops.attention as att
    seen = {k: 0 for k in fa.LAUNCHES}

    def record(q, k, v, *, scale=None):
        seen[fa.route(q.shape[2], q.shape[3], k.shape[1])] += 1
        return fa.attention_plain(q, k, v, scale or q.shape[-1] ** -0.5)

    monkeypatch.setattr(att, "flash_attention", record)
    fcfg, pcfg = small_configs()
    from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
    g = torch.Generator().manual_seed(0)
    pipe = FantasyWorldPipeline(
        build(lambda: FusionModel(fcfg), device="cpu", dtype=torch.float32,
              generator=g),
        build(lambda: CameraPoseEncoder(pcfg), device="cpu",
              dtype=torch.float32, generator=g))
    h, w, nf = 256, 384, 21
    cond = conditioning(fcfg.dit, h, w, nf, g, 16)
    lat, pred = pipe.denoise(*cond[:4], h, w, num_frames=nf,
                             num_inference_steps=1, seed=0,
                             plucker_fea=pipe.encode_plucker(cond[4]))
    check_outputs(fcfg, lat, pred, h, w, nf)
    assert seen == expected_launches(fcfg, 1)
    assert all(seen[r] for r in fa.ROUTES)
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    assert expected_launches(FusionConfig(), 3) == dict(
        {k: 0 for k in fa.LAUNCHES}, generic=3 * 88, onekv=3 * 80 + 16,
        d64=3 * 48)
