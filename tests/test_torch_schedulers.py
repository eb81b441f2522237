"""The port's DDIM and continuous-ODE schedules against the JAX package's:
the ladders, and every tensor method on the same seeded numpy inputs, in
f32 on the CPU."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from fantasy_world_tpu.schedulers import ContinuousODEScheduler as JODE
from fantasy_world_tpu.schedulers import EnhancedDDIMScheduler as JDDIM
from fantasy_world_tpu.schedulers.ddim import (
    rescale_zero_terminal_snr as j_rescale)

from fantasy_world_tpu_torch.schedulers import (ContinuousODEScheduler,
                                                EnhancedDDIMScheduler,
                                                FlowMatchScheduler)
from fantasy_world_tpu_torch.schedulers.ddim import rescale_zero_terminal_snr

# f32 on both sides from the same host scalars: a few ulps, relative to the
# largest magnitude
RTOL = 1e-6


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(a, b, what):
    a = np.asarray(a, np.float64)
    b = (b.numpy() if isinstance(b, torch.Tensor) else
         np.asarray(b)).astype(np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)
    assert err <= RTOL, (what, err)


def _tensor_methods(j, t, n):
    """Each step, the jump to the end, add_noise, training_target and
    training_weight at every index of an n-step ladder."""
    sample, out, noise = _x(2, 3, 5), _x(2, 3, 5, seed=1), _x(2, 3, 5, seed=2)
    for i in range(n):
        for final in (False, True):
            _close(j.step(jnp.asarray(out), i, jnp.asarray(sample),
                          to_final=final),
                   t.step(torch.from_numpy(out), i, torch.from_numpy(sample),
                          to_final=final), ("step", i, final))
        _close(j.add_noise(jnp.asarray(sample), jnp.asarray(noise), i),
               t.add_noise(torch.from_numpy(sample), torch.from_numpy(noise),
                           i), ("add_noise", i))
        _close(j.training_target(jnp.asarray(sample), jnp.asarray(noise), i),
               t.training_target(torch.from_numpy(sample),
                                 torch.from_numpy(noise), i),
               ("training_target", i))
        assert j.training_weight(i) == t.training_weight(i)


@pytest.mark.parametrize("schedule", ["scaled_linear", "linear"])
@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("rescale", [False, True])
def test_ddim_matches_jax(schedule, prediction, rescale):
    kw = dict(beta_schedule=schedule, prediction_type=prediction,
              rescale_zero_terminal_snr_flag=rescale)
    j, t = JDDIM(**kw), EnhancedDDIMScheduler(**kw)
    np.testing.assert_array_equal(j.alphas_cumprod, t.alphas_cumprod)
    assert t.alphas_cumprod.dtype == (np.float64 if rescale else np.float32)
    for n, strength in ((7, 1.0), (1, 1.0), (5, 0.37), (2000, 1.0)):
        j.set_timesteps(n, denoising_strength=strength)
        t.set_timesteps(n, denoising_strength=strength)
        np.testing.assert_array_equal(j.timesteps, t.timesteps)
    j.set_timesteps(6, denoising_strength=0.8)
    t.set_timesteps(6, denoising_strength=0.8)
    _tensor_methods(j, t, 6)
    sample, stab = _x(4, 3, seed=3), _x(4, 3, seed=4)
    for i in range(6):
        _close(j.return_to_timestep(i, jnp.asarray(sample), jnp.asarray(stab)),
               t.return_to_timestep(i, torch.from_numpy(sample),
                                    torch.from_numpy(stab)),
               ("return_to_timestep", i))
    if rescale:
        # the rescaled schedule ends at alpha_bar = 0: both packages refuse
        # a step from t = 999 the same way (epsilon divides by it)
        j.set_timesteps(3)
        t.set_timesteps(3)
        if prediction == "epsilon":
            with pytest.raises(ZeroDivisionError):
                j.step(jnp.ones(2), 0, jnp.ones(2))
            with pytest.raises(ZeroDivisionError):
                t.step(torch.ones(2), 0, torch.ones(2))
        else:
            _tensor_methods(j, t, 3)


def test_ddim_rescale_and_errors():
    ac = JDDIM().alphas_cumprod
    np.testing.assert_array_equal(j_rescale(ac), rescale_zero_terminal_snr(ac))
    r = rescale_zero_terminal_snr(ac)
    assert r[-1] == 0.0 and abs(r[0] - ac[0]) < 1e-12
    with pytest.raises(NotImplementedError):
        EnhancedDDIMScheduler(beta_schedule="cosine")
    with pytest.raises(NotImplementedError):
        EnhancedDDIMScheduler(prediction_type="sample").step(
            torch.ones(1), 0, torch.ones(1))


@pytest.mark.parametrize("strength", [1.0, 0.6])
def test_continuous_ode_matches_jax(strength):
    j, t = JODE(), ContinuousODEScheduler()
    np.testing.assert_array_equal(j.sigmas, t.sigmas)
    np.testing.assert_array_equal(j.timesteps, t.timesteps)
    j.set_timesteps(9, denoising_strength=strength)
    t.set_timesteps(9, denoising_strength=strength)
    np.testing.assert_array_equal(j.sigmas, t.sigmas)
    np.testing.assert_array_equal(j.timesteps, t.timesteps)
    assert t.sigmas.dtype == t.timesteps.dtype == np.float32
    _tensor_methods(j, t, 9)


def test_schedulers_keep_device_and_dtype():
    """The tensor methods return on their input's device in its dtype;
    the package exports all three schedules."""
    x = torch.ones(3, dtype=torch.bfloat16)
    for s in (EnhancedDDIMScheduler(), ContinuousODEScheduler()):
        for out in (s.step(x, 0, x), s.add_noise(x, x, 0),
                    s.training_target(x, x, 0)):
            assert out.dtype == torch.bfloat16 and out.device == x.device
    assert FlowMatchScheduler().set_timesteps(3).sigmas.shape == (3,)
