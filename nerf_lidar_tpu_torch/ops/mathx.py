"""Math helpers (port of `nerf_lidar_tpu/ops/mathx.py`).

`sorted_interp` keeps the dense masked-extrema form of the reference: every
query is compared with every knot ([..., M, N] grid), so ties and the clamp at
both ends behave exactly as in the JAX version.
"""

from __future__ import annotations

import torch

_TINY = 1e-20


def safe_div(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """n/d with 0 where d == 0."""
    d_ok = d != 0.0
    safe_d = torch.where(d_ok, d, torch.ones_like(d))
    return torch.where(d_ok, n / safe_d, torch.zeros_like(n))


def safe_sqrt(x: torch.Tensor, eps: float = _TINY) -> torch.Tensor:
    """sqrt clamped away from 0."""
    return torch.sqrt(torch.clamp(x, min=eps))


def _find_interval(mask: torch.Tensor, y: torch.Tensor):
    """Given mask[..., M, N] (x >= y boundaries), bracketing values of y."""
    y0 = torch.where(mask, y[..., None], y[..., :1, None]).amax(dim=-2)
    y1 = torch.where(~mask, y[..., None], y[..., -1:, None]).amin(dim=-2)
    return y0, y1


def sorted_interp(x: torch.Tensor, xp: torch.Tensor,
                  fp: torch.Tensor) -> torch.Tensor:
    """interp() where xp and fp are sorted along the last axis.

    x: [..., N], xp/fp: [..., M]. Returns [..., N].
    """
    mask = x[..., None, :] >= xp[..., :, None]
    fp0, fp1 = _find_interval(mask, fp)
    xp0, xp1 = _find_interval(mask, xp)
    offset = torch.clamp(safe_div(x - xp0, xp1 - xp0), 0, 1)
    return fp0 + offset * (fp1 - fp0)
