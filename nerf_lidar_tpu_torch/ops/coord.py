"""Ray-distance warps and the scene contraction (port of
`nerf_lidar_tpu/ops/coord.py`)."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import mathx

_EPS = float(np.finfo(np.float32).eps)


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis [..., 1], added left to right
    with one rounding each, as the JAX package's eager call computes it on
    the CPU (`Tensor.sum` adds in another order: a mesh vertex then moves
    by an ulp)."""
    out = x[..., :1] ** 2
    for i in range(1, x.shape[-1]):
        out = out + x[..., i:i + 1] ** 2
    return out


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root (in float64, rounded once), as
    XLA computes it: torch's vectorised float32 sqrt on the CPU is an ulp
    off on ~0.6% of values."""
    return torch.sqrt(x.double()).to(x.dtype)


def contract(x: torch.Tensor) -> torch.Tensor:
    """mip-NeRF 360 contraction (Eq. 10 of arxiv.org/abs/2111.12077)."""
    x_mag_sq = torch.clamp(_sum_sq(x), min=_EPS)
    x_mag = _sqrt(x_mag_sq)
    return torch.where(x_mag_sq <= 1, x, ((2 * x_mag - 1) / x_mag_sq) * x)


def inv_contract(z: torch.Tensor) -> torch.Tensor:
    """Inverse of `contract`."""
    z_mag_sq = torch.clamp(_sum_sq(z), min=_EPS)
    return torch.where(z_mag_sq <= 1, z,
                       z / (2 * _sqrt(z_mag_sq) - z_mag_sq))


def contract_mean_std(x: torch.Tensor, std: torch.Tensor):
    """Contract isotropic Gaussians (mean [..., 3], scalar std [...]).

    The std is scaled by det(J)^(1/3) of the contraction Jacobian, in closed
    form: for |x| > 1, det = (1/|x|^2) * (2/|x| - 1/|x|^2)^2.
    """
    x_mag_sq = torch.clamp((x**2).sum(dim=-1, keepdim=True), min=_EPS)
    x_mag = torch.sqrt(x_mag_sq)
    mask = x_mag_sq <= 1
    z = torch.where(mask, x, ((2 * x_mag - 1) / x_mag_sq) * x)
    det = ((1 / x_mag_sq) * (2 / x_mag - 1 / x_mag_sq) ** 2)[..., 0]
    std = torch.where(mask[..., 0], std, det ** (1.0 / x.shape[-1]) * std)
    return z, std


def track_linearize(fn: str, mean: torch.Tensor, std: torch.Tensor):
    """Push isotropic Gaussians through `fn` (only 'contract' exists)."""
    if fn != "contract":
        raise NotImplementedError(fn)
    return contract_mean_std(mean, std)


def power_transformation(x, lam: float):
    """ZipNeRF Eq. 4 power transformation."""
    lam_1 = abs(lam - 1)
    return lam_1 / lam * ((x / lam_1 + 1) ** lam - 1)


def inv_power_transformation(x, lam: float):
    lam_1 = abs(lam - 1)
    return ((x * lam / lam_1 + 1 + _EPS) ** (1 / lam) - 1) * lam_1


def construct_ray_warps(fn, t_near, t_far, lam=None):
    """Bijection between metric distance t and normalized distance s.

    `fn` is one of None, 'piecewise', 'power_transformation', 'reciprocal',
    'log', 'exp', 'sqrt', 'square'. Returns (t_to_s, s_to_t).
    """
    if fn is None:
        fn_fwd = lambda x: x
        fn_inv = lambda x: x
    elif fn == "piecewise":
        fn_fwd = lambda x: torch.where(x < 1, 0.5 * x, 1 - 0.5 / x)
        fn_inv = lambda x: torch.where(x < 0.5, 2 * x, 0.5 / (1 - x))
    elif fn == "power_transformation":
        fn_fwd = lambda x: power_transformation(x * 2, lam=lam)
        fn_inv = lambda y: inv_power_transformation(y, lam=lam) / 2
    elif fn == "reciprocal":
        fn_fwd = lambda x: 1.0 / x
        fn_inv = lambda x: 1.0 / x
    elif fn == "log":
        fn_fwd, fn_inv = torch.log, torch.exp
    elif fn == "exp":
        fn_fwd, fn_inv = torch.exp, torch.log
    elif fn == "sqrt":
        fn_fwd, fn_inv = torch.sqrt, torch.square
    elif fn == "square":
        fn_fwd, fn_inv = torch.square, torch.sqrt
    else:
        raise NotImplementedError(fn)

    s_near, s_far = fn_fwd(t_near), fn_fwd(t_far)
    t_to_s = lambda t: (fn_fwd(t) - s_near) / (s_far - s_near)
    s_to_t = lambda s: fn_inv(s * s_far + (1 - s) * s_near)
    return t_to_s, s_to_t


def expected_sin(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """E[sin(x)] for x ~ N(mean, var)."""
    return torch.exp(-0.5 * var) * mathx.safe_sin(mean)


def integrated_pos_enc(mean: torch.Tensor, var: torch.Tensor, min_deg: int,
                       max_deg: int) -> torch.Tensor:
    """mip-NeRF integrated positional encoding."""
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=mean.dtype,
                                 device=mean.device)
    shape = mean.shape[:-1] + (-1,)
    scaled_mean = (mean[..., None, :] * scales[:, None]).reshape(shape)
    scaled_var = (var[..., None, :] * scales[:, None] ** 2).reshape(shape)
    return expected_sin(
        torch.cat([scaled_mean, scaled_mean + 0.5 * math.pi], dim=-1),
        torch.cat([scaled_var] * 2, dim=-1))


def pos_enc(x: torch.Tensor, min_deg: int, max_deg: int,
            append_identity: bool = True) -> torch.Tensor:
    """Classic NeRF positional encoding."""
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=x.dtype,
                                 device=x.device)
    shape = x.shape[:-1] + (-1,)
    scaled_x = (x[..., None, :] * scales[:, None]).reshape(shape)
    four_feat = torch.sin(
        torch.cat([scaled_x, scaled_x + 0.5 * math.pi], dim=-1))
    if append_identity:
        return torch.cat([x, four_feat], dim=-1)
    return four_feat
