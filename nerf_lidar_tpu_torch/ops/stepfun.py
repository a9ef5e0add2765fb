"""Step-function resampling (port of `nerf_lidar_tpu/ops/stepfun.py`).

Sampling is deterministic without a generator (the JAX `key=None`: a fixed
linspace) and jittered with one (training). The CDF inversion and the
dilation keep the reference's dense comparison grids, so ties and end
clamps match it exactly.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import mathx

_EPS = float(np.finfo(np.float32).eps)


def _linspace(start: float, stop: float, num: int, like: torch.Tensor):
    """float32 linspace rounded as `jnp.linspace` rounds it:
    start * (1 - i/div) + stop * i/div, with the last entry = stop."""
    start32, stop32 = np.float32(start), np.float32(stop)
    step = np.arange(num - 1, dtype=np.float32) / np.float32(num - 1)
    out = np.concatenate([start32 * (np.float32(1) - step) + stop32 * step,
                          [stop32]]).astype(np.float32)
    return torch.from_numpy(out).to(device=like.device, dtype=like.dtype)


def weight_to_pdf(t, w):
    return w / torch.clamp(t[..., 1:] - t[..., :-1], min=_EPS)


def pdf_to_weight(t, p):
    return p * (t[..., 1:] - t[..., :-1])


def max_dilate(t, w, dilation: float, domain=(-math.inf, math.inf)):
    """Dilate (max-pool) a non-negative step function."""
    t0 = t[..., :-1] - dilation
    t1 = t[..., 1:] + dilation
    t_dilate = torch.sort(torch.cat([t, t0, t1], dim=-1), dim=-1).values
    t_dilate = torch.clamp(t_dilate, *domain)
    inside = ((t0[..., None, :] <= t_dilate[..., None])
              & (t1[..., None, :] > t_dilate[..., None]))
    w_dilate = torch.where(inside, w[..., None, :],
                           torch.zeros((), dtype=w.dtype, device=w.device))
    w_dilate = w_dilate.amax(dim=-1)[..., :-1]
    return t_dilate, w_dilate


def max_dilate_weights(t, w, dilation: float, domain=(-math.inf, math.inf),
                       renormalize: bool = False):
    """Dilate a set of weights (as a PDF) via max-pooling."""
    p = weight_to_pdf(t, w)
    t_dilate, p_dilate = max_dilate(t, p, dilation, domain=domain)
    w_dilate = pdf_to_weight(t_dilate, p_dilate)
    if renormalize:
        w_dilate = w_dilate / torch.clamp(
            w_dilate.sum(dim=-1, keepdim=True), min=_EPS)
    return t_dilate, w_dilate


def integrate_weights(w: torch.Tensor) -> torch.Tensor:
    """CDF endpoints of a weight vector that sums to 1: [..., M] -> [..., M+1]."""
    cw = torch.clamp(torch.cumsum(w[..., :-1], dim=-1), max=1)
    shape = cw.shape[:-1] + (1,)
    return torch.cat([torch.zeros(shape, dtype=cw.dtype, device=cw.device), cw,
                      torch.ones(shape, dtype=cw.dtype, device=cw.device)],
                     dim=-1)


def invert_cdf(u, t, w_logits):
    """Invert the CDF defined by (t, softmax(w_logits)) at points u."""
    w = torch.softmax(w_logits, dim=-1)
    cw = integrate_weights(w)
    return mathx.sorted_interp(u, cw, t)


def sample(t, w_logits, num_samples: int, deterministic_center: bool = False,
           generator: Optional[torch.Generator] = None,
           single_jitter: bool = False):
    """Piecewise-constant PDF sampling from a step function.

    t: [..., M+1] sorted bin endpoints; w_logits: [..., M] bin weight logits.
    generator: None samples a fixed linspace; a generator (on t's device)
      jitters a strided linspace, by one offset per ray with
      `single_jitter`, so samples stay sorted.
    Returns [..., num_samples].
    """
    if generator is None:
        if deterministic_center:
            pad = 1 / (2 * num_samples)
            u = _linspace(pad, 1.0 - pad - _EPS, num_samples, t)
        else:
            u = _linspace(0, 1.0 - _EPS, num_samples, t)
        u = u.expand(t.shape[:-1] + (num_samples,))
    else:
        u_max = _EPS + (1 - _EPS) / num_samples
        max_jitter = (1 - u_max) / (num_samples - 1) - _EPS
        d = 1 if single_jitter else num_samples
        jitter = torch.rand(t.shape[:-1] + (d,), generator=generator,
                            dtype=t.dtype, device=t.device)
        u = _linspace(0, 1 - u_max, num_samples, t) + jitter * max_jitter
    return invert_cdf(u, t, w_logits)


def sample_intervals(t, w_logits, num_samples: int,
                     domain=(-math.inf, math.inf),
                     generator: Optional[torch.Generator] = None,
                     single_jitter: bool = False):
    """Sample *intervals* (fenceposts) from a step function: [..., S+1]."""
    if num_samples <= 1:
        raise ValueError(f"num_samples must be > 1, is {num_samples}.")
    centers = sample(t, w_logits, num_samples, deterministic_center=True,
                     generator=generator, single_jitter=single_jitter)
    mid = (centers[..., 1:] + centers[..., :-1]) / 2
    minval, maxval = domain
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=minval)
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=maxval)
    return torch.cat([first, mid, last], dim=-1)


def lossfun_distortion(t, w):
    """iint w_i w_j |t_i - t_j|: the mip-NeRF 360 distortion loss."""
    ut = (t[..., 1:] + t[..., :-1]) / 2
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    loss_inter = (w * (w[..., None, :] * dut).sum(dim=-1)).sum(dim=-1)
    loss_intra = (w**2 * (t[..., 1:] - t[..., :-1])).sum(dim=-1) / 3
    return loss_inter + loss_intra


def blur_stepfun(x, y, r: float):
    """Convolve a step function (x, y) with a box filter of radius r.

    Returns (xr, yr): the blurred piecewise-linear function's 2M knots and
    values, with yr[..., 0] = 0 (for the anti-aliased interlevel loss).
    """
    xr, xr_idx = torch.sort(torch.cat([x - r, x + r], dim=-1), dim=-1,
                            stable=True)
    zero = torch.zeros_like(y[..., :1])
    y1 = (torch.cat([y, zero], dim=-1) - torch.cat([zero, y], dim=-1)) / (
        2 * r)
    y2 = torch.gather(torch.cat([y1, -y1], dim=-1), -1, xr_idx[..., :-1])
    yr = torch.clamp(torch.cumsum(
        (xr[..., 1:] - xr[..., :-1]) * torch.cumsum(y2, dim=-1), dim=-1),
        min=0)
    return xr, torch.cat([torch.zeros_like(yr[..., :1]), yr], dim=-1)
