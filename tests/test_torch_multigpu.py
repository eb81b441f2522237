"""The port's multi-GPU denoise against the JAX package's one-device run,
in f32 on the CPU: the fusion model sharded over data x seq x model meshes
of spawned gloo ranks (``parallel/sharding.py``, ``FantasyWorldPipeline.
shard``) against JAX ``joint_forward`` and ``denoise`` on the same weights
(a JAX ``init_fusion`` tree carried across with ``from_jax``), and the
inference CLI under torchrun against its one-process run (the JAX
``tests/test_multichip.py`` and ``tests/test_ulysses.py`` equality checks).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from __graft_entry__ import _demo_config
from fantasy_world_tpu.models.fusion.model import (init_fusion,
                                                   joint_forward,
                                                   split_trainable)
from fantasy_world_tpu.pipelines.wan_video import FantasyWorldPipeline as JPipe

import torch_mesh_workers as workers
from fantasy_world_tpu_torch.convert.from_jax import (fusion_config_from,
                                                      fusion_state_dict)
from fantasy_world_tpu_torch.core.params import build
from fantasy_world_tpu_torch.models.fusion.model import FusionModel
from fantasy_world_tpu_torch.parallel import distributed
from test_torch_sampler import (FRAMES, H, W, _cli_argv,
                                _write_reference_layout, make_env)
from test_torch_slice import _wake

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 through 3 DiT blocks, 2 VGGT block pairs and the heads, one device
# against a mesh: summation order and the collectives' order of addition
TOL = 2e-4
PRED_TOL = 5e-4
# DiT 2 heads of 128 (so that they split over 2 model ranks: the port keeps
# whole heads per rank), VGGT 4 x 16, bicross 4 x 24
F, LH, LW = 2, 8, 8


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The JAX tree (its zero gates woken), the port's config and its state
    dict on disk, and the inputs on disk."""
    tmp = tmp_path_factory.mktemp("multigpu")
    cfg = _demo_config(dim=256, layers=3, start_index=1, agg_dim=64)
    params = _wake(init_fusion(0, cfg, jnp.float32),
                   np.random.default_rng(0))
    pcfg = fusion_config_from(cfg)
    port = build(lambda: FusionModel(pcfg), device="cpu",
                 dtype=torch.float32)
    torch.save(fusion_state_dict(params, port), tmp / "sd.pt")
    rng = np.random.default_rng(1)
    B = 2
    inp = {"lat": rng.standard_normal((B, 16, F, LH, LW)),
           "y": rng.standard_normal((B, 20, F, LH, LW)),
           "ctx": rng.standard_normal((B, 16, 4096)) * 0.02,
           "clip": rng.standard_normal((B, 257, 1280)) * 0.1,
           "pl": rng.standard_normal((B, F * (LH // 2) * (LW // 2), 2048))
           * 0.1,
           "t": np.full((B,), 500.0)}
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    np.savez(tmp / "inputs.npz", **inp)
    return {"tmp": tmp, "cfg": cfg, "params": params, "pcfg": pcfg,
            "inputs": inp}


@pytest.fixture(scope="module")
def jax_forward(model):
    """JAX's one-device ``joint_forward``, eager (a cold jit of the
    forward with the heads costs ~3x longer on this CPU)."""
    lite, scan = split_trainable(model["params"], model["cfg"])
    i = {k: jnp.asarray(v) for k, v in model["inputs"].items()}
    noise, pred = joint_forward(
        lite, scan, model["cfg"], i["lat"], i["t"], i["ctx"], i["clip"],
        i["y"], plucker_fea=i["pl"], return_prediction=True)
    return np.asarray(noise), {k: np.asarray(v) for k, v in pred.items()}


MESHES = [((2, 1, 1), False), ((1, 2, 1), True), ((1, 1, 2), False),
          ((2, 2, 2), False),
          # the DiT's one head per model rank does not split over 2 seq
          # ranks: its self-attention takes the ring, bicross and VGGT
          # global Ulysses
          ((1, 2, 2), True)]


@pytest.mark.parametrize("shape,uly", MESHES,
                         ids=[f"{'x'.join(map(str, s))}{'_ulysses' * u}"
                              for s, u in MESHES])
def test_joint_forward_on_mesh_matches_jax(model, jax_forward, shape, uly):
    out = model["tmp"] / f"fwd_{'x'.join(map(str, shape))}_{uly}.npz"
    distributed.spawn(workers.fusion_case, int(np.prod(shape)),
                      model["pcfg"], shape, uly,
                      str(model["tmp"] / "sd.pt"),
                      str(model["tmp"] / "inputs.npz"), str(out))
    got = np.load(out)
    noise, pred = jax_forward
    assert np.isfinite(got["noise"]).all()
    np.testing.assert_allclose(got["noise"], noise, rtol=TOL, atol=TOL)
    assert {k[5:] for k in got.files if k.startswith("pred/")} == set(pred)
    for k, v in pred.items():
        np.testing.assert_allclose(got[f"pred/{k}"], v, rtol=TOL, atol=TOL)


def test_denoise_on_mesh_matches_jax(model):
    """3 steps with the heads on the last, the CFG pair split over 'data',
    the frames over 'seq', the DiT over 'model' (the JAX pipeline's
    ``denoise`` on one device, with the noise the port draws)."""
    rng = np.random.default_rng(3)
    h, w = 8 * LH, 8 * LW
    cond = {"ctx_pos": rng.standard_normal((1, 16, 4096)) * 0.02,
            "ctx_neg": rng.standard_normal((1, 16, 4096)) * 0.02,
            "clip": rng.standard_normal((1, 257, 1280)) * 0.1,
            "y": rng.standard_normal((1, 20, F, LH, LW)),
            "pl": rng.standard_normal((1, F * (LH // 2) * (LW // 2), 2048))
            * 0.1}
    cond = {k: v.astype(np.float32) for k, v in cond.items()}
    tmp = model["tmp"]
    np.savez(tmp / "cond.npz", fhw=np.asarray([F, LH, LW]), **cond)
    distributed.spawn(workers.fusion_case, 8, model["pcfg"], (2, 2, 2),
                      False, str(tmp / "sd.pt"), str(tmp / "cond.npz"),
                      str(tmp / "denoise.npz"), 3)
    got = np.load(tmp / "denoise.npz")
    jl, jpred = JPipe(cfg=model["cfg"], params={"fusion": model["params"]}
                      ).denoise(
        *(jnp.asarray(cond[k]) for k in ("ctx_pos", "ctx_neg", "clip", "y")),
        h, w, num_frames=4 * (F - 1) + 1, num_inference_steps=3, seed=7,
        plucker_fea=jnp.asarray(cond["pl"]), torch_compat_noise=True)
    np.testing.assert_allclose(got["latents"], np.asarray(jl), rtol=TOL,
                               atol=TOL)
    for k, v in jpred.items():
        np.testing.assert_allclose(got[f"pred/{k}"], np.asarray(v),
                                   rtol=PRED_TOL, atol=PRED_TOL)


# ---------------------------------------------------------------------------
# the CLI under torchrun
# ---------------------------------------------------------------------------

def _ply(path):
    data = path.read_bytes()
    head, body = data.split(b"end_header\n", 1)
    return head, np.frombuffer(body, dtype=[("xyz", "<f4", 3),
                                            ("rgb", "u1", 3)])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny reference layout of ``tests/test_torch_sampler.py``."""
    root = tmp_path_factory.mktemp("cli_mesh")
    env = make_env(root)
    wan, ckpt = _write_reference_layout(root, env["modules"],
                                        np.random.default_rng(7))
    return root, env, {"wan": wan, "model": ckpt}


def test_release_shared_between_jobs(tmp_path):
    """``distributed.release_shared`` between two jobs of one process
    group: every rank meets it, and collectives over groups made after it
    still sum and take the maximum (on the CPU no staging buffer exists;
    on a shared card it frees them, as chip_smoke's jobs do)."""
    out = tmp_path / "release.pt"
    distributed.spawn(workers.release_case, 2, str(out))
    got = torch.load(out)
    assert torch.equal(got["sum"], torch.full((3,), 3.0))
    assert torch.equal(got["max"], torch.full((3,), 1.0))


def test_sampler_batch_on_mesh_matches_one_process(tiny):
    """``generate_videos`` of two clips on a (1, 2, 1) Ulysses mesh: rank 0
    conditions and broadcasts, every rank denoises, rank 0 decodes; the
    clips equal the one-process call's."""
    from fantasy_world_tpu_torch.hostops.camera import load_camera_json
    from fantasy_world_tpu_torch.sampler import FantasyWorldSampler
    root, env, layout = tiny
    kw = {"height": H, "width": W, "num_frames": FRAMES, "sample_steps": 2,
          "seeds": [3, 4]}
    out = root / "sampler.npz"
    distributed.spawn(workers.sampler_case, 2, (1, 2, 1), layout["wan"],
                      layout["model"], env["tok"], env["image_path"],
                      env["cams"], kw, str(out))
    got = np.load(out)
    sampler = FantasyWorldSampler.from_checkpoint(
        layout["wan"], layout["model"], device="cpu", dtype=torch.float32,
        tokenizer_path=env["tok"])
    cams = load_camera_json(env["cams"], (H, W), FRAMES)
    want = sampler.generate_videos(
        ["a river", "a valley"], image_paths=[env["image_path"]] * 2,
        camera_params=[cams] * 2, **kw)
    for i, (video, pred) in enumerate(want):
        assert np.abs(got[f"{i}/video"].astype(int)
                      - video.astype(int)).max() <= 1
        for k, v in pred.items():
            np.testing.assert_allclose(got[f"{i}/{k}"], v, rtol=PRED_TOL,
                                       atol=PRED_TOL)


def test_cli_mesh_under_torchrun_matches_one_process(tiny):
    """``torchrun --nproc_per_node 2 -m ...cli.infer_wan21 --device cpu
    --mesh_seq 2 --ulysses true`` on the tiny reference layout writes what
    the one-process run writes, and only rank 0 writes."""
    root, env, layout = tiny
    assert (FRAMES - 1) // 4 + 1 >= 2        # a latent frame per seq rank
    env_vars = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env_vars["OMP_NUM_THREADS"] = "1"
    outs = {}
    for name, launch, extra in (
            ("one", [sys.executable, "-m"], ()),
            ("mesh", [sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc_per_node", "2", "-m"],
             ("--mesh_seq", "2", "--ulysses", "true"))):
        out = root / name
        res = subprocess.run(
            [*launch, "fantasy_world_tpu_torch.cli.infer_wan21",
             *_cli_argv(env, layout, out, "--device", "cpu", *extra)],
            cwd=REPO, env=env_vars, capture_output=True, text=True,
            timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        assert res.stdout.count("outputs written") == 1, res.stdout
        outs[name] = out
    assert "2 ranks (1x2x1 mesh)" in res.stdout
    assert sorted(os.listdir(outs["one"])) == sorted(os.listdir(outs["mesh"]))
    video = [n for n in os.listdir(outs["one"]) if n.startswith("video")][0]
    if video.endswith(".npy"):
        a, b = (np.load(outs[k] / video).astype(int) for k in outs)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1
    ply = "recon_confthresh0.0.ply"
    (ha, a), (hb, b) = (_ply(outs[k] / ply) for k in outs)
    assert ha == hb
    np.testing.assert_allclose(b["xyz"], a["xyz"], rtol=PRED_TOL,
                               atol=PRED_TOL)
    assert np.abs(a["rgb"].astype(int) - b["rgb"].astype(int)).max() <= 1


def test_cli_mesh_with_serving_options_matches_one_process(tiny):
    """``--quant int8 --tea_cache_l1_thresh`` with ``--segment_size`` and
    ``--gen_ckpt_path`` on a 1x1x2 mesh under torchrun (the options a mesh
    refused before) write what the same options write in one process
    (THRESH makes a plan that skips at these random weights,
    ``test_torch_tea_cache.py``); rank 0 prints the progress, writes the
    partial state after each segment and removes it at the end."""
    from test_torch_tea_cache import THRESH
    root, env, layout = tiny
    env_vars = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env_vars["OMP_NUM_THREADS"] = "1"
    outs = {}
    for name, launch, extra in (
            ("one", [sys.executable, "-m"], ()),
            ("mesh", [sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc_per_node", "2", "-m"],
             ("--mesh_model", "2"))):
        out = root / f"options_{name}"
        res = subprocess.run(
            [*launch, "fantasy_world_tpu_torch.cli.infer_wan21",
             *_cli_argv(env, layout, out, "--device", "cpu", "--quant",
                        "int8", "--tea_cache_l1_thresh", str(THRESH),
                        "--sample_steps", "4", "--segment_size", "1",
                        "--gen_ckpt_path", str(root / f"{name}.npz"),
                        *extra)],
            cwd=REPO, env=env_vars, capture_output=True, text=True,
            timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        assert res.stdout.count("outputs written") == 1, res.stdout
        assert res.stdout.count("[denoise] step 4/4") == 1
        assert not (root / f"{name}.npz").exists()
        outs[name] = out
    assert "2 ranks (1x1x2 mesh)" in res.stdout
    assert sorted(os.listdir(outs["one"])) == sorted(os.listdir(outs["mesh"]))
    video = [n for n in os.listdir(outs["one"]) if n.startswith("video")][0]
    if video.endswith(".npy"):
        a, b = (np.load(outs[k] / video).astype(int) for k in outs)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1
    (ha, a), (hb, b) = (_ply(outs[k] / "recon_confthresh0.0.ply")
                        for k in outs)
    assert ha == hb
    np.testing.assert_allclose(b["xyz"], a["xyz"], rtol=PRED_TOL,
                               atol=PRED_TOL)
