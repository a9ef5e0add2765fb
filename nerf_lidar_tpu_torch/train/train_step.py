"""One optimisation step (port of `nerf_lidar_tpu/train/train_step.py`).

Adam with the reference's betas and eps over up to three parameter groups,
as the JAX `optax.multi_transform`: `model`, and with pose refinement
`posenet`, with track refinement `tracknet`. Each group's learning rate is
set on the host each step from its own schedule at the optimizer's update
count (0 for the first update, as optax's `scale_by_schedule` counts):
`lr_schedule`, and `posenet_schedule` / `tracknet_schedule`, which are 0
outside their step windows. Every gradient is NaN-scrubbed; then each
group is clipped by its own global norm and by value, as each group's
optax chain clips. The pose deltas move the batch (by `cam_idx`) and the
track deltas the tracks before the forward; both start at zero.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs import Config
from ..models import posenet as posenet_lib
from ..ops import mathx
from . import losses as losses_lib


def lr_schedule(config: Config):
    """Log-lerp decay with reverse-cosine warmup: step -> learning rate."""
    def fn(step: int) -> float:
        return mathx.learning_rate_decay(
            step, config.lr_init, config.lr_final, config.max_steps,
            config.lr_delay_steps, config.lr_delay_mult)
    return fn


def posenet_schedule(config: Config):
    """Posenet rate: live only in (start_step, end_step)."""
    def fn(step: int) -> float:
        if not config.start_step < step < config.end_step:
            return 0.0
        return mathx.learning_rate_decay(
            step - config.start_step, config.pn_lr_init, config.pn_lr_final,
            config.end_step - config.start_step, config.lr_delay_steps,
            config.lr_delay_mult)
    return fn


def tracknet_schedule(config: Config):
    """Tracknet rate: live only in (track_start_opt, track_start_opt +
    5000)."""
    def fn(step: int) -> float:
        start = config.track_start_opt
        if not start < step < start + 5000:
            return 0.0
        return mathx.learning_rate_decay(
            step - start, config.tn_lr_init, config.tn_lr_final,
            config.max_steps - start, config.lr_delay_steps,
            config.lr_delay_mult)
    return fn


def check_ported(config: Config) -> None:
    losses_lib.check_ported(config)


def make_optimizer(model: torch.nn.Module, config: Config,
                   posenet: Optional[torch.nn.Module] = None,
                   tracknet: Optional[torch.nn.Module] = None
                   ) -> torch.optim.Adam:
    """Adam over the model's parameters and those of the refiners given,
    one parameter group each (named "model", "posenet", "tracknet");
    `train_step` sets each group's rate."""
    groups = [dict(params=list(model.parameters()), name="model")]
    for name, module in (("posenet", posenet), ("tracknet", tracknet)):
        if module is not None:
            groups.append(dict(params=list(module.parameters()), name=name))
    return torch.optim.Adam(groups, lr=config.lr_init,
                            betas=(config.adam_beta1, config.adam_beta2),
                            eps=config.adam_eps)


def _schedules(config: Config):
    return dict(model=lr_schedule(config),
                posenet=posenet_schedule(config),
                tracknet=tracknet_schedule(config))


def _clip_and_scrub(groups, config: Config) -> None:
    """nan_to_num every gradient (NaN -> 0, +-inf -> +-float max); then,
    group by group, the optax chain's clips: by the group's global norm,
    then by value. A parameter without a gradient gets zeros, as every
    optax leaf gets one, so Adam moves all its moments."""
    for group in groups:
        grads = []
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            torch.nan_to_num_(p.grad)
            grads.append(p.grad)
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
               use_kernels: bool = True,
               posenet: Optional[torch.nn.Module] = None,
               tracknet: Optional[torch.nn.Module] = None,
               tracks: Optional[torch.Tensor] = None,
               track_mask: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """Update `model` (and the refiners given) in place on one batch.

    step: the number of updates made so far (the JAX `state.step`).
    generator: the step's randomness (on the batch's device), or None for
      the deterministic JAX `key=None` step.
    use_kernels: False runs the plain torch versions of every kernel.
    posenet: a `LearnPose` (with `pose_refine`); tracknet: a `TrackOpt`
      (with `track_refine`) over `tracks` [N_obj, T, 9] / `track_mask`.
    Returns the stats (detached scalar tensors): every loss term, `loss`,
    `psnr`, `_mses`, and with a sample budget `obj_overflow` and
    `obj_hit_frac`.
    """
    train_frac = min(max((step - 1) / (config.max_steps - 1), 0.0), 1.0)
    schedules = _schedules(config)
    for group in optimizer.param_groups:
        group["lr"] = schedules[group.get("name", "model")](step)

    if config.pose_refine and posenet is not None:
        R, t = posenet(batch["cam_idx"][..., 0])
        batch = posenet_lib.apply_pose_refinement(R, t, batch)
    if config.track_refine and tracknet is not None and tracks is not None:
        tracks = tracknet(tracks)
    renderings, ray_history = model(batch, train_frac=train_frac,
                                    use_kernels=use_kernels, train=True,
                                    generator=generator, tracks=tracks,
                                    track_mask=track_mask)
    losses = losses_lib.compute_losses(
        model, batch, renderings, ray_history, config, step,
        num_patch_rays=num_patch_rays, use_kernels=use_kernels)
    loss = losses_lib.total_loss(losses)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    _clip_and_scrub(optimizer.param_groups, config)
    optimizer.step()

    stats = {k: v.detach() for k, v in losses.items()}
    stats["loss"] = loss.detach()
    stats["psnr"] = -10.0 * torch.log10(torch.clamp(stats["_mses"][-1],
                                                    min=1e-10))
    for stat in ("obj_overflow", "obj_hit_frac"):
        if f"_{stat}" in stats:
            stats[stat] = stats[f"_{stat}"]
    return stats
