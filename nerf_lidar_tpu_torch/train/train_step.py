"""One optimisation step (port of `nerf_lidar_tpu/train/train_step.py` for
a static scene).

Adam with the reference's betas and eps, its learning rate set on the host
each step from `lr_schedule` at the optimizer's update count (0 for the
first update, as optax's `scale_by_schedule` counts); the optional global
norm and value clips; the NaN scrub of every gradient. Pose and track
refinement (the posenet / tracknet parameter groups) belong to the dynamic
objects slice and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs import Config
from ..ops import mathx
from . import losses as losses_lib


def lr_schedule(config: Config):
    """Log-lerp decay with reverse-cosine warmup: step -> learning rate."""
    def fn(step: int) -> float:
        return mathx.learning_rate_decay(
            step, config.lr_init, config.lr_final, config.max_steps,
            config.lr_delay_steps, config.lr_delay_mult)
    return fn


def check_ported(config: Config, has_tracks: bool = False) -> None:
    if config.pose_refine:
        raise NotImplementedError("pose_refine (the posenet parameter group) "
                                  "is not ported")
    if config.track_refine and has_tracks:
        raise NotImplementedError("track_refine with tracks (the tracknet "
                                  "parameter group) is not ported")
    losses_lib.check_ported(config)


def make_optimizer(model: torch.nn.Module, config: Config
                   ) -> torch.optim.Adam:
    """Adam over every model parameter; `train_step` sets the rate."""
    return torch.optim.Adam(model.parameters(), lr=config.lr_init,
                            betas=(config.adam_beta1, config.adam_beta2),
                            eps=config.adam_eps)


def _clip_and_scrub(params, config: Config) -> None:
    """nan_to_num every gradient (NaN -> 0, +-inf -> +-float max), then the
    optax chain's clips: by global norm, then by value."""
    grads = [p.grad for p in params if p.grad is not None]
    for g in grads:
        torch.nan_to_num_(g)
    if config.grad_max_norm > 0:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < config.grad_max_norm, 1.0,
                            config.grad_max_norm / norm)
        for g in grads:
            g.mul_(scale)
    if config.grad_max_val > 0:
        for g in grads:
            g.clamp_(-config.grad_max_val, config.grad_max_val)


def train_step(model, optimizer: torch.optim.Optimizer, config: Config,
               batch: Dict[str, torch.Tensor], step: int,
               num_patch_rays: int = 0,
               generator: Optional[torch.Generator] = None,
               use_kernels: bool = True) -> Dict[str, torch.Tensor]:
    """Update `model` in place on one batch.

    step: the number of updates made so far (the JAX `state.step`).
    generator: the step's randomness (on the batch's device), or None for
      the deterministic JAX `key=None` step.
    use_kernels: False runs the plain torch versions of every kernel.
    Returns the stats (detached scalar tensors): every loss term, `loss`,
    `psnr` and `_mses`.
    """
    train_frac = min(max((step - 1) / (config.max_steps - 1), 0.0), 1.0)
    lr = lr_schedule(config)(step)
    for group in optimizer.param_groups:
        group["lr"] = lr

    renderings, ray_history = model(batch, train_frac=train_frac,
                                    use_kernels=use_kernels, train=True,
                                    generator=generator)
    losses = losses_lib.compute_losses(
        model, batch, renderings, ray_history, config, step,
        num_patch_rays=num_patch_rays, use_kernels=use_kernels)
    loss = losses_lib.total_loss(losses)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    _clip_and_scrub([p for g in optimizer.param_groups for p in g["params"]],
                    config)
    optimizer.step()

    stats = {k: v.detach() for k, v in losses.items()}
    stats["loss"] = loss.detach()
    stats["psnr"] = -10.0 * torch.log10(torch.clamp(stats["_mses"][-1],
                                                    min=1e-10))
    return stats
