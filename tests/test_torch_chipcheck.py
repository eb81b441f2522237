"""The card check's layout on the CPU: ``fantasy_world_tpu_torch/chipcheck``
imports no torch, JAX or JAX package at module level; its registry names
every phase exactly once, in an order whose needs are met; and its one
relative-L2 helper gives the numbers of the four it replaced."""
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from fantasy_world_tpu_torch import chipcheck
from fantasy_world_tpu_torch.chipcheck import registry
from fantasy_world_tpu_torch.chipcheck.common import SOFTMAX_CANCELLED, rel_l2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(m.name for m in pkgutil.iter_modules(chipcheck.__path__))


def test_modules_are_the_split():
    assert MODULES == sorted(["common", "inputs", "launches", "jobs",
                              "profile", "kernels", "small", "pipe",
                              "serving", "mesh", "full", "registry"])


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_no_torch_jax_or_jax_package(name):
    """Each module alone, in a fresh interpreter, loads no torch, no jax and
    nothing of ``fantasy_world_tpu``: a host without a card imports it."""
    code = (f"import sys, fantasy_world_tpu_torch.chipcheck.{name}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'fantasy_world_tpu')]\n"
            "assert not bad, bad\nprint('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


def test_registry_names_every_phase_once():
    """Every ``phase_*`` function of the subpackage is one registry entry,
    and no entry's function is anything else."""
    found = []
    for name in MODULES:
        module = importlib.import_module(f"{chipcheck.__name__}.{name}")
        found += [fn for fname, fn in vars(module).items()
                  if fname.startswith("phase_") and inspect.isfunction(fn)
                  and fn.__module__ == module.__name__]
    named = [p.fn for p in registry.PHASES]
    assert len(named) == len(set(named))
    assert set(named) == set(found)
    assert len({p.name for p in registry.PHASES}) == len(registry.PHASES)
    assert all(p.fn.__name__ == f"phase_{p.name}"
               for p in registry.PHASES)


def test_registry_order_meets_every_need():
    """Each phase takes only keys that the run seeds, a fallback makes, or a
    phase before it gives; each ``then`` phase comes after its phase; and
    ``chip_smoke.py`` runs the registry (no phase of its own)."""
    given = set(registry.SEEDED) | set(registry.FALLBACKS)
    for i, phase in enumerate(registry.PHASES):
        assert set(phase.needs) <= given, phase.name
        given |= {k for k in phase.gives if k}
        for follower in phase.then:
            assert [p.name for p in registry.PHASES].index(follower) > i
    assert registry.plan() == list(registry.PHASES)
    assert not [n for n in vars(chip_smoke) if n.startswith("phase_")]
    assert "registry.run(" in inspect.getsource(chip_smoke.main)


@pytest.mark.parametrize("names,want", [
    (["build"], ["build"]),
    (["build", "train_kernels"], ["build", "train_kernels"]),
    (["full_serve"], ["full_slice", "full_clip", "full_serve"]),
    (["small_meshes"], ["meshes_start", "small_slice", "small_meshes"]),
    (["full_mesh"], ["meshes_start", "full_mesh"]),
    (["full_mesh_serving"], ["full_mesh_serving"]),
    (["small_clip"], ["small_clip", "small_clip_check"]),
    (["small_ti2v_check"], ["small_ti2v", "small_ti2v_check"]),
    (["full_ti2v", "kernels"], ["kernels", "full_slice", "full_clip",
                                "full_serve", "full_ti2v"]),
])
def test_plan_takes_the_providers_in_registry_order(names, want):
    assert [p.name for p in registry.plan(names)] == want


def test_plan_refuses_an_unknown_phase():
    with pytest.raises(KeyError):
        registry.plan(["build", "no_such_phase"])


# the four helpers the one replaced, as they were written


def old_chip_smoke_rel_l2(got, want):
    g = torch.cat([t.flatten().double() for t in got])
    w = torch.cat([t.flatten().double() for t in want])
    return ((g - w).norm() / w.norm().clamp_min(1e-30)).item()


def old_pipe_grad_rel_l2(grads, ref, device, joint=False):
    def rel(names):
        want = [ref[n].to(device).float() for n in names]
        num = sum((grads[n].to(device).float() - w).norm() ** 2
                  for n, w in zip(names, want))
        den = sum(w.norm() ** 2 for w in want)
        return (num.sqrt() / den.sqrt().clamp_min(1e-30)).item()
    errs, alone = {}, {}
    for n in grads:
        if joint and SOFTMAX_CANCELLED.match(n):
            alone[n] = rel([n])
            errs[n + "+weight"] = rel([n, n[:-len("bias")] + "weight"])
        else:
            errs[n] = rel([n])
    return errs, alone


def old_mesh_check_rel_l2(got, ref):
    return {k: ((got[k] - r).norm() / r.norm().clamp_min(1e-12)).item()
            for k, r in ref.items()}


def old_mesh_check_grad_rel(got, names, theirs, joint):
    return old_pipe_grad_rel_l2({n: got[n] for n in names}, theirs, "cpu",
                                joint)[0]


def _grads(seed, noise):
    """A seeded gradient dict with a cross-attention key bias beside its
    weight, and a second one ``noise`` away from it."""
    rng = np.random.default_rng(seed)
    names = ["blocks.0.cross_attn.k.weight", "blocks.0.cross_attn.k.bias",
             "blocks.0.cross_attn.k_img.weight",
             "blocks.0.cross_attn.k_img.bias", "blocks.0.ffn.0.weight",
             "head.bias"]
    shapes = [(16, 16), (16,), (16, 8), (16,), (32, 16), (4,)]
    ref = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for n, s in zip(names, shapes)}
    # the cancelled biases: tiny exact values, noise of the weights' size
    for n in names:
        if SOFTMAX_CANCELLED.match(n):
            ref[n] *= 1e-3
    got = {n: t + noise * torch.from_numpy(
        rng.standard_normal(t.shape).astype(np.float32))
        for n, t in ref.items()}
    return got, ref


def test_rel_l2_equals_the_chip_smoke_list_helper():
    """``_rel_l2`` of the reduced runs: lists of tensors as one vector."""
    got, ref = _grads(1, 1e-2)
    names = sorted(ref)
    want = old_chip_smoke_rel_l2([got[n] for n in names],
                                 [ref[n] for n in names])
    assert rel_l2([got[n] for n in names],
                  [ref[n] for n in names]) == pytest.approx(want, rel=1e-12)


def test_rel_l2_equals_pipe_grad_rel_l2_with_the_joint_rule():
    """``pipe_grad_rel_l2`` under ``joint``: each cancelled key bias with
    its weight as "{bias}+weight", every other tensor alone; the biases'
    own errors, which the caller prints, are ``rel_l2`` of them alone."""
    got, ref = _grads(2, 1e-2)
    want, want_alone = old_pipe_grad_rel_l2(got, ref, "cpu", joint=True)
    errs = rel_l2(got, ref, joint=True)
    assert set(errs) == set(want)
    assert "blocks.0.cross_attn.k.bias+weight" in errs
    for n, v in want.items():
        assert errs[n] == pytest.approx(v, rel=1e-5), n
    alone = rel_l2({n: g for n, g in got.items()
                    if SOFTMAX_CANCELLED.match(n)}, ref)
    assert set(alone) == set(want_alone)
    for n, v in want_alone.items():
        assert alone[n] == pytest.approx(v, rel=1e-5), n
    # the bias alone is far beyond its joint error: the rule matters here
    assert alone["blocks.0.cross_attn.k.bias"] > 10 * errs[
        "blocks.0.cross_attn.k.bias+weight"]
    plain, _ = old_pipe_grad_rel_l2(got, ref, "cpu")
    assert rel_l2(got, ref) == pytest.approx(plain, rel=1e-5)


def test_rel_l2_equals_the_mesh_check_dict_helper():
    """``tools/torch_mesh_check.py``'s ``rel_l2``: per key of the
    reference."""
    got, ref = _grads(3, 3e-2)
    got["extra"] = torch.ones(3)
    want = old_mesh_check_rel_l2(got, ref)
    errs = rel_l2({k: got[k] for k in ref}, ref)
    assert set(errs) == set(want)
    for k, v in want.items():
        assert errs[k] == pytest.approx(v, rel=1e-5), k


def test_rel_l2_equals_the_mesh_check_gradient_helper():
    """``tools/torch_mesh_check.py``'s ``_grad_rel_l2``: a rank's names
    against a reference holding more, joint or not."""
    got, ref = _grads(4, 1e-2)
    names = [n for n in got if n.startswith("blocks.")]
    for joint in (False, True):
        want = old_mesh_check_grad_rel(got, names, ref, joint)
        errs = rel_l2({n: got[n] for n in names}, ref, joint)
        assert set(errs) == set(want)
        for n, v in want.items():
            assert errs[n] == pytest.approx(v, rel=1e-5), (joint, n)


def test_softmax_cancelled_names_the_key_biases_only():
    assert SOFTMAX_CANCELLED.match("blocks.3.cross_attn.k.bias")
    assert SOFTMAX_CANCELLED.match("blocks.3.cross_attn.k_img.bias")
    assert not SOFTMAX_CANCELLED.match("blocks.3.cross_attn.q.bias")
    assert not SOFTMAX_CANCELLED.match("blocks.3.cross_attn.k.weight")
