"""Reflection directions and the integrated directional encoding of
Ref-NeRF (port of `nerf_lidar_tpu/ops/ref_utils.py`).

`IntegratedDirEnc` is the IDE (Eqs. 6-8 of arxiv.org/abs/2112.03907) in
the JAX package's real-arithmetic form: the spherical harmonics' z part as
a Vandermonde matrix times a coefficient matrix built in numpy once, the
(x + iy)^m part as r^m (cos m phi + i sin m phi). The coefficient matrix
and the (m, l) orders are buffers on the module's device, outside the
state dict.

At the poles (x = y = 0) phi is atan2(0, 1) = 0, the value atan2(0, 0)
gives, so the encoding is the JAX one; the gradient there is 0 where
atan2's is 0 / 0.
"""

from __future__ import annotations

import math as pymath

import numpy as np
import torch
from torch import nn


def reflect(viewdirs: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """u = 2 dot(n, v) n - v."""
    return (2.0 * torch.sum(normals * viewdirs, dim=-1, keepdim=True)
            * normals - viewdirs)


def l2_normalize(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=eps)


def compute_weighted_mae(weights, normals, normals_gt) -> torch.Tensor:
    """Weighted mean angular error in degrees."""
    one_eps = 1 - 1e-3
    dots = torch.clamp((normals * normals_gt).sum(-1), -one_eps, one_eps)
    return ((weights * torch.arccos(dots)).sum() / weights.sum()
            * 180.0 / pymath.pi)


def generalized_binomial_coeff(a, k):
    return np.prod(a - np.arange(k)) / pymath.factorial(k)


def assoc_legendre_coeff(l, m, k):
    """Coefficient of cos^k sin^m in P_l^m(cos theta)."""
    return ((-1) ** m * 2**l * pymath.factorial(l) / pymath.factorial(k)
            / pymath.factorial(l - k - m)
            * generalized_binomial_coeff(0.5 * (l + k + m - 1.0), l))


def sph_harm_coeff(l, m, k):
    return (np.sqrt((2.0 * l + 1.0) * pymath.factorial(l - m)
                    / (4.0 * np.pi * pymath.factorial(l + m)))
            * assoc_legendre_coeff(l, m, k))


def get_ml_array(deg_view: int) -> np.ndarray:
    ml_list = []
    for i in range(deg_view):
        l = 2**i
        for m in range(l + 1):
            ml_list.append((m, l))
    return np.array(ml_list).T


def ide_width(deg_view: int) -> int:
    """Width of the IDE: real and imaginary part of every (m, l)."""
    return 2 * get_ml_array(deg_view).shape[1]


class IntegratedDirEnc(nn.Module):
    """fn(xyz [..., 3], kappa_inv [..., 1]) -> [..., ide_width(deg_view)];
    xyz and kappa_inv broadcast against each other."""

    def __init__(self, deg_view: int, device=None):
        super().__init__()
        if deg_view > 5:
            raise ValueError(
                "Only deg_view of at most 5 is numerically stable.")
        ml_array = get_ml_array(deg_view)
        l_max = 2 ** (deg_view - 1)
        mat = np.zeros((l_max + 1, ml_array.shape[1]))
        for i, (m, l) in enumerate(ml_array.T):
            for k in range(l - m + 1):
                mat[k, i] = sph_harm_coeff(l, m, k)
        self.m_int = [int(m) for m in ml_array[0]]
        for name, value in (("mat", mat), ("m_arr", ml_array[0]),
                            ("l_arr", ml_array[1])):
            self.register_buffer(name, torch.tensor(
                np.asarray(value, np.float32), device=device),
                persistent=False)

    def forward(self, xyz: torch.Tensor, kappa_inv: torch.Tensor
                ) -> torch.Tensor:
        x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
        ones = torch.ones_like(z)
        vmz = torch.cat([ones] + [z**i for i in range(1, self.mat.shape[0])],
                        dim=-1)
        r = torch.sqrt(torch.clamp(x**2 + y**2, min=1e-20))
        pole = (x == 0) & (y == 0)
        phi = torch.atan2(torch.where(pole, torch.zeros_like(y), y),
                          torch.where(pole, torch.ones_like(x), x))
        rm = torch.cat([ones if m == 0 else r**m for m in self.m_int],
                       dim=-1)
        vmxy_re = rm * torch.cos(self.m_arr * phi)
        vmxy_im = rm * torch.sin(self.m_arr * phi)
        assoc = vmz @ self.mat
        sigma = 0.5 * self.l_arr * (self.l_arr + 1)
        atten = torch.exp(-sigma * kappa_inv)
        return torch.cat([vmxy_re * assoc * atten, vmxy_im * assoc * atten],
                         dim=-1)


def generate_ide_fn(deg_view: int, device=None) -> IntegratedDirEnc:
    """The integrated directional encoding of `deg_view` (a module)."""
    return IntegratedDirEnc(deg_view, device)


def generate_dir_enc_fn(deg_view: int, device=None):
    """Plain spherical-harmonic direction encoding (kappa_inv = 0)."""
    ide_fn = generate_ide_fn(deg_view, device)

    def dir_enc_fn(xyz):
        return ide_fn(xyz, torch.zeros_like(xyz[..., :1]))

    return dir_enc_fn


def orientation_loss(weights, normals, viewdirs) -> torch.Tensor:
    """Ref-NeRF orientation penalty: normals should not face away from the
    camera."""
    n_dot_v = (normals * -viewdirs[..., None, :]).sum(dim=-1)
    return (weights * torch.clamp(n_dot_v, max=0.0) ** 2).sum(
        dim=-1).mean()


def predicted_normal_loss(weights, normals, normals_pred) -> torch.Tensor:
    """Consistency between density normals and predicted normals."""
    return torch.mean(
        (weights * (1.0 - torch.sum(normals * normals_pred, dim=-1))
         ).sum(dim=-1))
