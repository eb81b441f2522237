"""Enhanced DDIM schedule (``schedulers/ddim.py``).

Scaled-linear or linear betas, an optional zero-terminal-SNR rescale, and
epsilon / v-prediction updates. ``alphas_cumprod`` is float32 as in the
reference; the rescale and every step weight are host float64. ``step``
takes the step index into the precomputed timestep ladder (aligned to
999..0), and the tensor methods return tensors on the device, and in the
dtype, of their inputs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift and scale sqrt(alpha_bar) so that the last step has zero SNR
    and the first keeps its value (float64)."""
    ab_sqrt = np.sqrt(alphas_cumprod.astype(np.float64))
    ab0, abT = ab_sqrt[0], ab_sqrt[-1]
    ab_sqrt = (ab_sqrt - abT) * (ab0 / (ab0 - abT))
    return np.square(ab_sqrt)


@dataclasses.dataclass
class EnhancedDDIMScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    rescale_zero_terminal_snr_flag: bool = False

    alphas_cumprod: np.ndarray = dataclasses.field(default=None, repr=False)
    timesteps: np.ndarray = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        n = self.num_train_timesteps
        # float32 as in the reference: the published weights were trained
        # against the f32-rounded schedule, so f64 would break parity
        if self.beta_schedule == "scaled_linear":
            betas = np.square(np.linspace(math.sqrt(self.beta_start),
                                          math.sqrt(self.beta_end), n,
                                          dtype=np.float32))
        elif self.beta_schedule == "linear":
            betas = np.linspace(self.beta_start, self.beta_end, n,
                                dtype=np.float32)
        else:
            raise NotImplementedError(self.beta_schedule)
        self.alphas_cumprod = np.cumprod((1.0 - betas).astype(np.float32))
        if self.rescale_zero_terminal_snr_flag:
            self.alphas_cumprod = rescale_zero_terminal_snr(
                self.alphas_cumprod)
        self.set_timesteps(10)

    def set_timesteps(self, num_inference_steps: int,
                      denoising_strength: float = 1.0,
                      **_) -> "EnhancedDDIMScheduler":
        """n evenly spaced training timesteps from round(1000 * strength)
        - 1 down to 0, each rounded to an integer (Python's round)."""
        max_t = max(round(self.num_train_timesteps * denoising_strength) - 1,
                    0)
        n = min(num_inference_steps, max_t + 1)
        if n == 1:
            self.timesteps = np.array([max_t], np.float32)
        else:
            step_len = max_t / (n - 1)
            self.timesteps = np.array(
                [round(max_t - i * step_len) for i in range(n)], np.float32)
        return self

    def _alpha(self, step_index: int) -> float:
        return float(self.alphas_cumprod[int(self.timesteps[step_index])])

    def _denoise(self, model_output, sample, a_t: float, a_prev: float):
        if self.prediction_type == "epsilon":
            w_e = math.sqrt(1 - a_prev) - math.sqrt(a_prev * (1 - a_t) / a_t)
            w_x = math.sqrt(a_prev / a_t)
        elif self.prediction_type == "v_prediction":
            w_e = (-math.sqrt(a_prev * (1 - a_t))
                   + math.sqrt(a_t * (1 - a_prev)))
            w_x = (math.sqrt(a_t * a_prev)
                   + math.sqrt((1 - a_t) * (1 - a_prev)))
        else:
            raise NotImplementedError(self.prediction_type)
        return sample * w_x + model_output * w_e

    def step(self, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor, to_final: bool = False) -> torch.Tensor:
        """The DDIM update to the next ladder timestep; to alpha_bar = 1
        on the last step (or ``to_final``)."""
        a_t = self._alpha(step_index)
        if to_final or step_index + 1 >= len(self.timesteps):
            a_prev = 1.0
        else:
            a_prev = self._alpha(step_index + 1)
        return self._denoise(model_output, sample, a_t, a_prev)

    def return_to_timestep(self, step_index: int, sample: torch.Tensor,
                           sample_stablized: torch.Tensor) -> torch.Tensor:
        a_t = self._alpha(step_index)
        return (sample - math.sqrt(a_t) * sample_stablized) / math.sqrt(
            1 - a_t)

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  step_index: int) -> torch.Tensor:
        a_t = self._alpha(step_index)
        return math.sqrt(a_t) * original + math.sqrt(1 - a_t) * noise

    def training_target(self, sample: torch.Tensor, noise: torch.Tensor,
                        step_index: int) -> torch.Tensor:
        if self.prediction_type == "epsilon":
            return noise
        a_t = self._alpha(step_index)
        return math.sqrt(a_t) * noise - math.sqrt(1 - a_t) * sample

    def training_weight(self, step_index: int) -> float:
        return 1.0
