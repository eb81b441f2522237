"""Rectified-flow (flow-matching) schedule (``schedulers/flow_match.py``).

Sigmas are computed once on the host in float64 numpy: linspace(sigma_max',
sigma_min, n[+1])[:n], shifted sigma -> shift*sigma / (1 + (shift-1)*sigma);
timestep = sigma * 1000. The Euler update lives in the pipeline.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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

    def sigma_pairs(self) -> np.ndarray:
        """(n, 2) array of (sigma, sigma_next)."""
        nxt_final = 1.0 if (self.inverse_timesteps
                            or self.reverse_sigmas) else 0.0
        nxt = np.concatenate([self.sigmas[1:], [nxt_final]]).astype(
            np.float32)
        return np.stack([self.sigmas, nxt], axis=1)
