"""Karras-style continuous-ODE schedule (``schedulers/continuous_ode.py``).

A rho-spaced sigma ramp between ``sigma_max`` and ``sigma_min``, computed
once on the host in float64 numpy, and an EDM-style preconditioned Euler
step over variance-preserving-scaled samples. ``step``, ``add_noise`` and
``training_target`` take torch tensors and return tensors on the device,
and in the dtype, of their inputs; the schedule's scalars are host floats.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class ContinuousODEScheduler:
    sigma_max: float = 700.0
    sigma_min: float = 0.002
    rho: float = 7.0

    sigmas: np.ndarray = dataclasses.field(default=None, repr=False)
    timesteps: np.ndarray = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.set_timesteps(100)

    def set_timesteps(self, num_inference_steps: int = 100,
                      denoising_strength: float = 1.0,
                      **_) -> "ContinuousODEScheduler":
        """sigma_i = (max^(1/rho) + ramp_i (min^(1/rho) - max^(1/rho)))^rho
        over ramp = linspace(1 - strength, 1, n) in f64, stored f32;
        timestep = log(sigma) / 4."""
        ramp = np.linspace(1 - denoising_strength, 1, num_inference_steps,
                           dtype=np.float64)
        min_inv_rho = self.sigma_min ** (1 / self.rho)
        max_inv_rho = self.sigma_max ** (1 / self.rho)
        self.sigmas = ((max_inv_rho + ramp * (min_inv_rho - max_inv_rho))
                       ** self.rho).astype(np.float32)
        self.timesteps = (np.log(self.sigmas.astype(np.float64))
                          * 0.25).astype(np.float32)
        return self

    def _sigma(self, step_index: int) -> float:
        return float(self.sigmas[step_index])

    def step(self, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor, to_final: bool = False) -> torch.Tensor:
        """The denoised estimate on the last step (or ``to_final``), else
        the Euler step to the next sigma, rescaled back."""
        sigma = self._sigma(step_index)
        vp = float(np.sqrt(sigma * sigma + 1))
        sample = sample * vp
        estimated = (-sigma / vp) * model_output + sample / (sigma * sigma + 1)
        if to_final or step_index + 1 >= len(self.sigmas):
            return estimated
        sigma_n = self._sigma(step_index + 1)
        derivative = (sample - estimated) / sigma
        prev = sample + derivative * (sigma_n - sigma)
        return prev / float(np.sqrt(sigma_n * sigma_n + 1))

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  step_index: int) -> torch.Tensor:
        sigma = self._sigma(step_index)
        return (original + noise * sigma) / float(np.sqrt(sigma * sigma + 1))

    def training_target(self, sample: torch.Tensor, noise: torch.Tensor,
                        step_index: int) -> torch.Tensor:
        sigma = self._sigma(step_index)
        vp = float(np.sqrt(sigma * sigma + 1))
        return (-vp / sigma + 1 / (vp * sigma)) * sample + noise / vp

    def training_weight(self, step_index: int) -> float:
        sigma = self._sigma(step_index)
        return float(np.sqrt(1 + sigma * sigma)) / sigma
