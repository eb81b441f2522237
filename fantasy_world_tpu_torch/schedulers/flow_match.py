"""Rectified-flow (flow-matching) schedule (``schedulers/flow_match.py``).

Sigmas are computed once on the host in float64 numpy: linspace(sigma_max',
sigma_min, n[+1])[:n], shifted sigma -> shift*sigma / (1 + (shift-1)*sigma);
timestep = sigma * 1000. ``step`` is the Euler update x + v * (sigma_next
- sigma) by step index (the pipelines run their own on ``sigma_pairs``);
``add_noise``, ``training_target`` and ``training_weight`` are the
training side.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class FlowMatchScheduler:
    num_train_timesteps: int = 1000
    shift: float = 5.0
    sigma_max: float = 1.0
    sigma_min: float = 0.0
    inverse_timesteps: bool = False
    extra_one_step: bool = True
    reverse_sigmas: bool = False

    sigmas: np.ndarray = dataclasses.field(default=None, repr=False)
    timesteps: np.ndarray = dataclasses.field(default=None, repr=False)

    def set_timesteps(self, num_inference_steps: int,
                      denoising_strength: float = 1.0,
                      shift: float | None = None) -> "FlowMatchScheduler":
        if shift is not None:
            self.shift = shift
        start = (self.sigma_min
                 + (self.sigma_max - self.sigma_min) * denoising_strength)
        n = num_inference_steps
        if self.extra_one_step:
            sig = np.linspace(start, self.sigma_min, n + 1,
                              dtype=np.float64)[:-1]
        else:
            sig = np.linspace(start, self.sigma_min, n, dtype=np.float64)
        if self.inverse_timesteps:
            sig = sig[::-1].copy()
        sig = self.shift * sig / (1 + (self.shift - 1) * sig)
        if self.reverse_sigmas:
            sig = 1 - sig
        self.sigmas = sig.astype(np.float32)
        self.timesteps = (sig * self.num_train_timesteps).astype(np.float32)
        return self

    def _final_sigma(self) -> float:
        return 1.0 if (self.inverse_timesteps or self.reverse_sigmas) else 0.0

    def step(self, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor, to_final: bool = False) -> torch.Tensor:
        """The Euler update from step ``step_index`` to the next sigma (the
        final one after the last step, or under ``to_final``)."""
        sigma = self.sigmas[step_index]
        if to_final or step_index + 1 >= len(self.sigmas):
            sigma_next = self._final_sigma()
        else:
            sigma_next = self.sigmas[step_index + 1]
        return sample + model_output * (float(sigma_next) - float(sigma))

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  step_index: int) -> torch.Tensor:
        """(1 - sigma) original + sigma noise at step ``step_index``."""
        sigma = float(self.sigmas[step_index])
        return (1 - sigma) * original + sigma * noise

    def training_target(self, sample: torch.Tensor, noise: torch.Tensor,
                        step_index=None) -> torch.Tensor:
        """The velocity the model learns: noise - sample."""
        return noise - sample

    def training_weight(self, num_inference_steps: int) -> np.ndarray:
        """A Gaussian weight per timestep, centred on num_inference_steps /
        2, its minimum subtracted, scaled to sum to num_inference_steps."""
        x = self.timesteps.astype(np.float64)
        n = num_inference_steps
        y = np.exp(-2 * ((x - n / 2) / n) ** 2)
        ys = y - y.min()
        return (ys * (n / ys.sum())).astype(np.float32)

    def sigma_pairs(self) -> np.ndarray:
        """(n, 2) array of (sigma, sigma_next)."""
        nxt = np.concatenate([self.sigmas[1:], [self._final_sigma()]]
                             ).astype(np.float32)
        return np.stack([self.sigmas, nxt], axis=1)
