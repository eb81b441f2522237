"""The port's training CLI on the CPU: a synthetic run, save and resume, the
LoRA mode, the modes that later slices bring, the batch stream shared with
the JAX trainer, and that the trainer imports nothing of JAX."""
import argparse
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

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


@pytest.mark.parametrize("extra,slice_name", [
    (["--pipe_stages", "2"], "multi-GPU"),
    (["--mesh_data", "2"], "multi-GPU"),
    (["--data_root", "/nonexistent"], "encoder"),
])
def test_unported_modes_exit(tmp_path, extra, slice_name):
    with pytest.raises(SystemExit, match=slice_name):
        main(_args(tmp_path / "x", 1) + extra)


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
    """The trainer and the training modules import nothing of JAX or of
    the JAX package (a fresh interpreter: this one has JAX loaded)."""
    code = (
        "import sys\n"
        "import fantasy_world_tpu_torch.cli.train as t\n"
        "import fantasy_world_tpu_torch.training.step\n"
        "import fantasy_world_tpu_torch.training.lora\n"
        "import fantasy_world_tpu_torch.utils.observability\n"
        "t.parse_args(['--synthetic'])\n"
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
