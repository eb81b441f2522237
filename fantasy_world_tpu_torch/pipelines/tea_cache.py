"""TeaCache: drift-gated skipping of the DiT block stack
(``pipelines/tea_cache.py``).

The modulation ``t_mod = time_projection(time_embedding(t))`` depends on
the timestep schedule and the frozen time-MLP weights only, not on the
latents. So the whole skip plan is made before the denoise: one batched
forward of the time MLP over every timestep, then the reference's
accumulate-and-reset recurrence replayed on the host. A skipped step
replaces the PCB + IRG stack by ``x + residual``, the stack's output minus
its input on the last computed step (``FusionModel.joint_forward_tea``).

The rescaling polynomials are the reference's published per-model
constants, kept as they are.
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..models.wan.dit import time_mlp

# the model id whose polynomial the pipelines and CLIs default to
DEFAULT_MODEL_ID = "Wan2.1-I2V-14B-480P"
# np.poly1d coefficient vectors, highest degree first
TEACACHE_COEFFICIENTS = {
    "Wan2.1-T2V-1.3B": [-5.21862437e+04, 9.23041404e+03, -5.28275948e+02,
                        1.36987616e+01, -4.99875664e-02],
    "Wan2.1-T2V-14B": [-3.03318725e+05, 4.90537029e+04, -2.65530556e+03,
                       5.87365115e+01, -3.15583525e-01],
    "Wan2.1-I2V-14B-480P": [2.57151496e+05, -3.54229917e+04, 1.40286849e+03,
                            -1.35890334e+01, 1.32517977e-01],
    "Wan2.1-I2V-14B-720P": [8.10705460e+03, 2.13393892e+03, -3.72934672e+02,
                            1.66203073e+01, -4.17769401e-02],
}


def modulation_drift_schedule(t_mods: np.ndarray) -> np.ndarray:
    """(n_steps, ...) stacked modulations -> (n_steps,) relative-L1 drift
    between consecutive steps; drift[0] = 0 (step 0 always computes)."""
    t_mods = np.asarray(t_mods, np.float32)
    n = t_mods.shape[0]
    drift = np.zeros((n,), np.float64)
    flat = t_mods.reshape(n, -1)
    for i in range(1, n):
        prev = flat[i - 1]
        drift[i] = (np.abs(flat[i] - prev).mean()
                    / max(np.abs(prev).mean(), 1e-12))
    return drift


def plan_skips(drift: np.ndarray, rel_l1_thresh: float,
               model_id: str = DEFAULT_MODEL_ID,
               coefficients=None) -> np.ndarray:
    """The reference's accumulate-and-reset recurrence over ``drift``:
    (n_steps,) bool, True = skip the stack. The first and the last step
    always compute."""
    if coefficients is None:
        if model_id not in TEACACHE_COEFFICIENTS:
            raise ValueError(
                f"{model_id} is not a supported TeaCache model id; choose "
                f"one of {sorted(TEACACHE_COEFFICIENTS)}")
        coefficients = TEACACHE_COEFFICIENTS[model_id]
    poly = np.poly1d(coefficients)
    n = len(drift)
    skip = np.zeros((n,), bool)
    acc = 0.0
    for i in range(n):
        if i == 0 or i == n - 1:
            acc = 0.0
            continue
        acc += float(poly(drift[i]))
        if acc < rel_l1_thresh:
            skip[i] = True
        else:
            acc = 0.0
    return skip


@torch.no_grad()
def time_modulations(dit, timesteps, device=None) -> np.ndarray:
    """(n_steps, 6, dim) f32 modulations of ``dit`` (a ``WanDiT``) at
    ``timesteps``, in one batched forward of its time MLP. ``device``
    (default: where the MLP is) runs it elsewhere -- the card, for an
    expert waiting in host memory -- on a copy of its two time modules."""
    home = dit.time_projection[1].weight.device
    device = home if device is None else torch.device(device)
    embedding, projection = dit.time_embedding, dit.time_projection
    if device != home:
        embedding, projection = (copy.deepcopy(m).to(device)
                                 for m in (embedding, projection))
    ts = torch.as_tensor(np.asarray(timesteps, np.float32), device=device)
    _, t_mods = time_mlp(embedding, projection, dit.cfg.freq_dim, ts)
    return t_mods.float().cpu().numpy()


def compute_skip_schedule(dit, timesteps, rel_l1_thresh: float,
                          model_id: str = DEFAULT_MODEL_ID,
                          coefficients=None, device=None) -> np.ndarray:
    """timesteps -> per-step skip booleans for ``dit``'s modulations."""
    drift = modulation_drift_schedule(time_modulations(dit, timesteps,
                                                       device))
    return plan_skips(drift, rel_l1_thresh, model_id, coefficients)


def compute_skip_schedule_dual(dit_high, dit_low, timesteps, n_high: int,
                               rel_l1_thresh: float,
                               model_id: str = DEFAULT_MODEL_ID,
                               coefficients=None,
                               device: Optional[torch.device] = None
                               ) -> np.ndarray:
    """The Wan2.2 dual-expert plan: steps < n_high take the high expert's
    modulations, the rest the low one's, and the drift at the boundary
    compares across the two, as the reference's one TeaCache instance
    does across the expert switch."""
    t_mods = np.concatenate(
        [time_modulations(dit_high, timesteps, device)[:n_high],
         time_modulations(dit_low, timesteps, device)[n_high:]], axis=0)
    return plan_skips(modulation_drift_schedule(t_mods), rel_l1_thresh,
                      model_id, coefficients)
