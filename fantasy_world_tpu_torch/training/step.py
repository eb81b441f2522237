"""Flow-matching training step for the fusion model
(``training/step.py``): the rectified-flow objective (target = noise -
sample) at one sampled timestep, differentiated through the fusion forward
-- on the card through the flash-attention backward kernels -- with
per-block recompute on by default.

PyTorch is stateful where the JAX step is pure: ``make_train_step`` returns
``step(batch) -> loss`` that updates the model's parameters and the
optimizer in place. After a step each trainable parameter's ``.grad``
holds its gradient.

On a ('data', 'seq', 'model') mesh (``mesh=``, the model split by
``FusionModel.shard``) every rank takes the whole batch and runs its rows,
frames and columns of the forward; the loss, on the whole gathered
prediction, is the same on every rank. After the backward
``parallel.sharding.reduce_gradients`` makes each rank's ``.grad`` the
one-process gradient of the part it holds, and AdamW steps each rank's
parts: its moments follow their parameter's split, as the JAX package's
``shard_opt_state`` places them. GSPMD gives the JAX step the same
function on any mesh.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn as nn

from ..schedulers.flow_match import FlowMatchScheduler


def flow_match_loss(model: nn.Module, clean_latents: torch.Tensor,
                    noise: torch.Tensor, sigma, timestep: torch.Tensor,
                    context: torch.Tensor, clip_feature=None, y=None,
                    plucker_fea=None, remat: bool = False, mesh=None,
                    ulysses: bool = False) -> torch.Tensor:
    """Rectified-flow MSE in f32: noisy = (1 - sigma) clean + sigma noise
    (f32, then the model's dtype), target noise - clean. ``sigma`` is a
    scalar or a per-sample (B, 1, 1, 1, 1) tensor. ``mesh`` / ``ulysses``
    go to ``joint_forward``: the same loss on every rank."""
    dtype = model.dit.patch_embedding.weight.dtype

    def cast(t):
        return None if t is None else t.to(dtype)

    clean, noise = clean_latents.float(), noise.float()
    if isinstance(sigma, torch.Tensor):
        sigma = sigma.float()
    noisy = (1 - sigma) * clean + sigma * noise
    pred, _ = model.joint_forward(cast(noisy), timestep.float(),
                                  cast(context), cast(clip_feature), cast(y),
                                  plucker_fea=cast(plucker_fea), remat=remat,
                                  mesh=mesh, ulysses=ulysses)
    return torch.mean(torch.square(pred.float() - (noise - clean)))


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    lr_schedule=None, *, remat: bool = True, mesh=None,
                    ulysses: bool = False
                    ) -> Callable[[Dict], torch.Tensor]:
    """Returns ``step(batch) -> loss`` (detached): loss and backward, one
    optimizer update of the parameters ``optimizer`` holds, one step of
    ``lr_schedule``. ``batch`` holds ``flow_match_loss``'s keyword
    arguments. ``mesh`` / ``ulysses``: the step on a mesh (the module
    docstring), every rank calling it with the same whole batch.

    A parameter the loss does not reach (the geometry heads, under the
    denoise loss) gets a zero gradient rather than none, so AdamW still
    applies its weight decay to it, as optax's adamw does to every leaf."""
    from ..parallel import sharding
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    named = {n: p for n, p in model.named_parameters() if id(p) in held}
    if len(named) != len(held):
        raise ValueError("the optimizer holds parameters that are not the "
                         "model's")
    params = list(named.values())
    mesh = mesh or sharding.single()

    def train_step(batch: Dict) -> torch.Tensor:
        for p in params:
            p.grad = None
        loss = flow_match_loss(model, remat=remat, mesh=mesh,
                               ulysses=ulysses, **batch)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        sharding.reduce_gradients(named, mesh,
                                  batch["clean_latents"].shape[0])
        optimizer.step()
        if lr_schedule is not None:
            lr_schedule.step()
        return loss.detach()

    return train_step


def sample_training_inputs(generator: torch.Generator,
                           sched: FlowMatchScheduler, shape
                           ) -> Tuple[torch.Tensor, float, float]:
    """Draw (noise, sigma, timestep) for one step: a uniform index into the
    schedule and f32 Gaussian noise of ``shape`` on the generator's
    device."""
    idx = int(torch.randint(0, len(sched.sigmas), (), generator=generator,
                            device=generator.device))
    noise = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
    return noise, float(sched.sigmas[idx]), float(sched.timesteps[idx])
