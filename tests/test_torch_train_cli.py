"""The port's training CLI on the CPU: a synthetic run, save and resume, the
LoRA mode, the mesh trainer under torchrun (saved and resumed on the mesh
and in one process), the batch streams shared with the JAX trainer, and
that the trainer imports nothing of JAX. The real-data mode:
tests/test_torch_train_data.py; the pipeline trainer (``--pipe_stages``):
tests/test_torch_pp.py."""
import argparse
import contextlib
import logging
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

from fantasy_world_tpu_torch.cli import train
from fantasy_world_tpu_torch.cli.train import _synthetic_batches, main

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(ckpt_dir, steps, *extra):
    return ["--synthetic", "--steps", str(steps),
            "--mesh_data", "1", "--mesh_seq", "1", "--mesh_model", "1",
            "--demo_dim", "64", "--demo_layers", "2",
            "--demo_start_index", "1", "--warmup", "1", "--lr", "1e-4",
            "--save_every", "100", "--log_every", "1",
            "--checkpoint_dir", str(ckpt_dir), "--device", "cpu", *extra]


def _final_loss(out):
    return float(re.search(r"final loss ([-\d.naninf]+)", out).group(1))


@pytest.fixture
def small_heads(monkeypatch):
    """Full fine-tuning saves AdamW moments of every parameter; the demo's
    DPT heads (380M parameters) are cut to 32 features for it."""
    import fantasy_world_tpu_torch.utils.demo as demo
    from test_torch_training import small_heads as cut
    full = demo.demo_config
    monkeypatch.setattr(demo, "demo_config", lambda **kw: cut(full(**kw)))


def test_train_cli_synthetic_and_resume(tmp_path, capsys, small_heads):
    ckpt = tmp_path / "ckpt"
    main(_args(ckpt, 2))
    out = capsys.readouterr().out
    assert "train done: 2 step(s)" in out
    assert (ckpt / "step_00000002" / "state.pt").exists()

    # resume picks up at step 2 and runs exactly one more step ...
    main(_args(ckpt, 3))
    out = capsys.readouterr().out
    assert "train done: 1 step(s)" in out
    assert (ckpt / "step_00000003").exists()
    resumed = _final_loss(out)

    # ... which is the third step of an uninterrupted run: weights,
    # AdamW moments and the warm-up schedule all came back
    main(_args(tmp_path / "straight", 3))
    assert _final_loss(capsys.readouterr().out) == resumed

    # an already-done checkpoint short-circuits
    main(_args(ckpt, 3))
    assert "already at step 3" in capsys.readouterr().out


def test_train_cli_lora_mode(tmp_path, capsys):
    ckpt = tmp_path / "lora"
    main(_args(ckpt, 2, "--lora_rank", "2", "--lr", "1e-3"))
    out = capsys.readouterr().out
    assert "train done: 2 step(s)" in out
    state = torch.load(ckpt / "step_00000002" / "state.pt",
                       weights_only=True)
    names = set(state["trainable"])
    assert names and all(".lora." in n for n in names)
    assert len(names) == 2 * 12 * 2                 # 12 linears, 2 blocks
    # resume in LoRA mode restores the factors and runs one more step
    main(_args(ckpt, 3, "--lora_rank", "2", "--lr", "1e-3"))
    assert "train done: 1 step(s)" in capsys.readouterr().out
    assert any(t.any() for n, t in state["trainable"].items()
               if n.endswith(".up"))


def test_mesh_flags_need_their_processes(tmp_path):
    """Without torchrun a mesh exits naming the process count."""
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        main(_args(tmp_path / "x", 1) + ["--mesh_model", "2"])


# the mesh trainer's runs: a demo of 2 DiT heads (dim 256), so the model
# splits over 2 ranks; LoRA rank 4
MESH_ARGS = ["--demo_dim", "256", "--lora_rank", "4", "--lr", "1e-3"]


@contextlib.contextmanager
def _train_log():
    """The ``train`` logger's messages while the block runs."""
    from fantasy_world_tpu_torch.utils.observability import get_logger
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())
    log, keep = get_logger("train"), Keep()
    log.addHandler(keep)
    try:
        yield lines
    finally:
        log.removeHandler(keep)


def _losses(out):
    """{step: loss} of a run's log lines (every rank's, which agree)."""
    found = {}
    for step, loss in re.findall(r"step (\d+)  loss ([-\d.naninf]+)", out):
        assert found.setdefault(int(step), float(loss)) == float(loss)
    return found


def _torchrun(ckpt_dir, steps, *mesh):
    argv = _args(ckpt_dir, steps) + MESH_ARGS + list(mesh)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "fantasy_world_tpu_torch.cli.train",
         *argv], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _finish(proc):
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:]
    return out


def test_mesh_trainer_under_torchrun(tmp_path):
    """``--mesh_model 2`` and ``--mesh_data 2`` (LoRA) under torchrun on
    gloo: 2 steps saved, resumed to 3 on the mesh, against the one-process
    losses of the same batches (at --mesh_data 2 a batch of 2); the 1x1x2
    checkpoint also resumes in one process."""
    runs = {"model": ("--mesh_model", "2"), "data": ("--mesh_data", "2")}
    first = {k: _torchrun(tmp_path / k, 2, *m) for k, m in runs.items()}
    out = {k: _finish(p) for k, p in first.items()}
    for k in runs:
        assert "train done: 2 step(s) on 2 ranks" in out[k], out[k][-2000:]
        assert (tmp_path / k / "step_00000002" / "state.pt").exists()
    shutil.copytree(tmp_path / "model", tmp_path / "model_one")
    second = {k: _torchrun(tmp_path / k, 3, *m) for k, m in runs.items()}
    for k, p in second.items():
        out[k] = out.get(k, "") + _finish(p)
    # the 1x1x2 checkpoint resumed in one process
    with _train_log() as lines:
        main(_args(tmp_path / "model_one", 3) + MESH_ARGS)
    resumed_one = _losses("\n".join(lines))
    # the one-process runs of the same batches: B = 1 and B = 2
    with _train_log() as lines:
        main(_args(tmp_path / "straight", 3) + MESH_ARGS)
    want = {"model": _losses("\n".join(lines))}
    with _train_log() as lines:
        args = train.parse_args(_args(tmp_path / "straight_b2", 3)
                                + MESH_ARGS + ["--mesh_data", "2"])
        train._run(args, torch.device("cpu"), None,
                   logging.getLogger("train"))
    want["data"] = _losses("\n".join(lines))
    for k in runs:
        got = _losses(out[k])
        assert sorted(got) == [0, 1, 2], got
        for step, loss in got.items():
            # the mesh sums in another order: within the log's rounding
            assert loss == pytest.approx(want[k][step], abs=2e-5), (k, step)
        assert "resumed from" in out[k]
    assert sorted(resumed_one) == [2]
    assert resumed_one[2] == pytest.approx(want["model"][2], abs=2e-5)


def test_train_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path,
                                                         monkeypatch):
    """Without a CUDA device and without --device cpu the trainer exits
    and names --device cpu; it never picks the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _args(tmp_path / "x", 1) if a not in ("--device",
                                                             "cpu")]
    with pytest.raises(SystemExit, match="--device cpu"):
        main(argv)
    assert not (tmp_path / "x").exists()


def _stub_stream(frames_of, lib):
    """A ``_data_batches`` stand-in for either trainer: item i a one-clip
    batch with ``frames_of(i)`` latent frames, its values drawn from i."""
    def batch(i):
        rng = np.random.default_rng(100 + i)
        f = frames_of(i)
        b = {"clean_latents": rng.standard_normal((1, 16, f, 8, 12)),
             "noise": rng.standard_normal((1, 16, f, 8, 12)),
             "timestep": np.full((1,), 10.0 * i),
             "context": rng.standard_normal((1, 4, 8)),
             "clip_feature": rng.standard_normal((1, 2, 8)),
             "y": rng.standard_normal((1, 20, f, 8, 12)),
             "plucker_fea": rng.standard_normal((1, f * 24, 8))}
        b = {k: np.asarray(v, np.float32) for k, v in b.items()}
        if lib == "torch":
            b = {k: torch.from_numpy(v) for k, v in b.items()}
        b["sigma"] = 0.01 * (i + 1)
        return b

    def stream(pipe, args, start=0, stage_callback=None, with_plucker=True):
        i = start
        while True:
            yield batch(i)
            i += 1
    return stream


def test_stacked_data_batches_match_jax_trainer(tmp_path, monkeypatch):
    """``--data_root`` with ``--mesh_data 2``: B clips a step with a sigma
    each, off-shape clips skipped, as the JAX trainer stacks them (both
    modules' single-clip streams replaced by one stub); resumable from the
    position a checkpoint keeps; a cycle without a matching clip exits."""
    import types

    from fantasy_world_tpu.cli import train as jtrain
    from fantasy_world_tpu.parallel.sharding import make_mesh
    for i in range(4):
        (tmp_path / f"clip{i}").mkdir()
    args = argparse.Namespace(data_root=str(tmp_path), frames=9, height=64,
                              width=96)
    pipe = types.SimpleNamespace(vae_cfg=types.SimpleNamespace(z_dim=16))

    def off_every_third(i):
        return 2 if i % 3 == 1 else 3

    monkeypatch.setattr(train, "_data_batches",
                        _stub_stream(off_every_third, "torch"))
    monkeypatch.setattr(jtrain, "_data_batches",
                        _stub_stream(off_every_third, "jax"))
    mine = train._stacked_data_batches(pipe, args, 2)
    theirs = jtrain._stacked_data_batches(pipe, args, make_mesh(data=2), 2,
                                          with_plucker=True)
    got = [next(mine) for _ in range(3)]
    assert mine.skipped == 3 and mine.position == 9   # items 1, 4 and 7
    for a in got:
        b = next(theirs)
        assert set(a) == set(b)
        assert tuple(a["sigma"].shape) == (2, 1, 1, 1, 1)
        for key in a:
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]),
                                          err_msg=key)
    # resumed from the position after the first batch
    again = train._stacked_data_batches(pipe, args, 2, start=3)
    for want in got[1:]:
        b = next(again)
        for key in want:
            assert torch.equal(b[key], want[key]), key
    # no clip matches: both exit after a whole cycle
    for mod, lib in ((train, "torch"), (jtrain, "jax")):
        monkeypatch.setattr(mod, "_data_batches",
                            _stub_stream(lambda i: 2, lib))
    with pytest.raises(SystemExit, match="latent shape"):
        next(train._stacked_data_batches(pipe, args, 2))
    with pytest.raises(SystemExit, match="latent shape"):
        next(jtrain._stacked_data_batches(pipe, args, make_mesh(data=2), 2,
                                          with_plucker=True))


def test_synthetic_batches_match_jax_trainer():
    """Both trainers draw the same batches from the same seed."""
    from fantasy_world_tpu.cli.train import _synthetic_batches as jax_batches
    from fantasy_world_tpu.parallel.sharding import make_mesh
    args = argparse.Namespace(seed=3, mesh_data=1)
    mine = _synthetic_batches(args, "cpu")
    theirs = jax_batches(None, args, make_mesh(data=1, seq=1, model=1))
    for _ in range(2):
        a, b = next(mine), next(theirs)
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]), err_msg=key)


def test_trainer_never_imports_jax():
    """The trainer, the training modules and the mesh modules they run on
    import nothing of JAX or of the JAX package (a fresh interpreter: this
    one has JAX loaded)."""
    code = (
        "import sys\n"
        "import fantasy_world_tpu_torch.cli.train as t\n"
        "import fantasy_world_tpu_torch.training.step\n"
        "import fantasy_world_tpu_torch.training.lora\n"
        "import fantasy_world_tpu_torch.utils.observability\n"
        "import fantasy_world_tpu_torch.cli.infer_wan21\n"
        "import fantasy_world_tpu_torch.training.pp\n"
        "from fantasy_world_tpu_torch.parallel import (distributed, pipeline,\n"
        "    ring, sharding, ulysses)\n"
        "t._check_args(t.parse_args(['--synthetic']))\n"
        "t._stacked_data_batches\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'fantasy_world_tpu' or m.startswith('fantasy_world_tpu.')]"
        "\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout
