"""Volume rendering: multisample ray casting and alpha compositing, with the
distance statistics of `compute_extras` (port of
`nerf_lidar_tpu/ops/render.py`)."""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from . import mathx, stepfun

_EPS = float(np.finfo(np.float32).eps)


def cast_rays(tdist, origins, directions, base_x, base_y, radii,
              n: int = 7, m: int = 3, std_scale: float = 0.35,
              generator: Optional[torch.Generator] = None):
    """Turn distance intervals into n spiral multisample points per frustum.

    tdist: [..., S+1]; origins/directions/base_x/base_y: [..., 3];
    radii: [..., 1]; generator (on tdist's device, or a
    `mathx.ShardedGenerator`): a random spiral phase per point, or None for
    none. Returns (means [..., S, n, 3], stds
    [..., S, n]).
    """
    t0 = tdist[..., :-1]
    t1 = tdist[..., 1:]

    j = torch.arange(n, dtype=tdist.dtype, device=tdist.device)
    t = t0[..., None] + (t1[..., None] - t0[..., None]) * (j + 0.5) / n
    deg = (2 * math.pi * m * j / n).expand(t.shape)
    if generator is not None:
        deg = deg + mathx.random_rows(torch.rand, t.shape, generator,
                                      dtype=t.dtype,
                                      device=t.device) * (2 * math.pi)
    r = radii[..., None]
    means = torch.stack([
        r * t * torch.cos(deg) / 2,
        r * t * torch.sin(deg) / 2,
        t,
    ], dim=-1)
    stds = std_scale * r * t

    # Spiral offsets from the pixel basis into world space, as explicit
    # multiply-adds like the reference (no 3x3 matmul).
    means = (means[..., 0:1] * base_x[..., None, None, :]
             + means[..., 1:2] * base_y[..., None, None, :]
             + means[..., 2:3] * directions[..., None, None, :])
    means = means + origins[..., None, None, :]
    return means, stds


def compute_alpha_weights(density, tdist, dirs, opaque_background=False):
    """Alpha-compositing weights from densities over intervals."""
    t_delta = tdist[..., 1:] - tdist[..., :-1]
    delta = t_delta * torch.linalg.norm(dirs[..., None, :], dim=-1)
    density_delta = density * delta

    if opaque_background:
        density_delta = torch.cat([
            density_delta[..., :-1],
            torch.full_like(density_delta[..., -1:], math.inf)], dim=-1)

    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([
        torch.zeros_like(density_delta[..., :1]),
        torch.cumsum(density_delta[..., :-1], dim=-1)], dim=-1))
    weights = alpha * trans
    return weights, alpha, trans


def volumetric_rendering(rgbs, weights, tdist, bg_rgbs,
                         semantic: Optional[torch.Tensor] = None,
                         intensity: Optional[torch.Tensor] = None,
                         sem_detach: bool = True,
                         t_far: Optional[torch.Tensor] = None,
                         compute_extras: bool = False,
                         extras: Optional[Dict[str, torch.Tensor]] = None
                         ) -> Dict[str, torch.Tensor]:
    """Composite per-sample quantities along rays.

    rgbs: [..., S, 3]; weights: [..., S]; tdist: [..., S+1]; bg_rgbs: a
    float or [..., 3] per ray; semantic: [..., S, K], composited with
    detached weights when `sem_detach`; intensity: [..., S] or [..., S, 1],
    always composited with detached weights; extras: per-sample
    [..., S, D] values (the normals), composited with the weights whenever
    given. With `compute_extras` also acc, distance_mean
    and the 5th / 50th / 95th distance percentiles over the weights with
    the background's share placed at t_far [..., 1].
    """
    rendering = {}
    acc = weights.sum(dim=-1)
    bg_w = torch.clamp(1 - acc[..., None], min=0.0)
    rendering["rgb"] = (weights[..., None] * rgbs).sum(dim=-2) + bg_w * bg_rgbs

    t_mids = 0.5 * (tdist[..., :-1] + tdist[..., 1:])
    rendering["depth"] = ((weights * t_mids).sum(dim=-1)
                          / torch.clamp(acc, min=_EPS))

    if semantic is not None:
        w_sem = weights.detach() if sem_detach else weights
        rendering["semantic"] = (w_sem[..., None] * semantic).sum(dim=-2)
    if intensity is not None:
        if intensity.ndim == weights.ndim + 1:
            intensity = intensity[..., 0]
        rendering["intensity"] = (weights.detach() * intensity).sum(dim=-1)
    for k, v in (extras or {}).items():
        rendering[k] = (weights[..., None] * v).sum(dim=-2)

    if compute_extras:
        rendering["acc"] = acc
        expectation = (weights * torch.log(t_mids)).sum(dim=-1) \
            / torch.clamp(acc, min=_EPS)
        mean = torch.nan_to_num(torch.exp(expectation), nan=math.inf)
        rendering["distance_mean"] = torch.minimum(
            torch.maximum(mean, tdist[..., 0]), tdist[..., -1])
        t_aug = torch.cat([tdist, t_far], dim=-1)
        weights_aug = torch.cat([weights, bg_w], dim=-1)
        ps = [5, 50, 95]
        percentiles = stepfun.weighted_percentile(t_aug, weights_aug, ps)
        for i, p in enumerate(ps):
            name = "median" if p == 50 else f"percentile_{p}"
            rendering[f"distance_{name}"] = percentiles[..., i]
    return rendering
