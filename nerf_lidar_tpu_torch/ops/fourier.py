"""Spectral position encoding of the `dense_fourier` fields (port of
`nerf_lidar_tpu/ops/fourier.py`).

The spectral encoder keeps a dense tiled band in the hash table
(`ops/grid.py:spec_for`) and carries the band above it as random Fourier
features: one [N, 3] @ [3, F] product, sin / cos, and the integrated-
positional-encoding damping exp(-2 pi^2 sigma^2 |f|^2) of a Gaussian of
std sigma. JAX computes them outside any Pallas kernel, so here they are
plain torch ops on every device.

`make_frequency_matrix` is the fixed [3, F] matrix: unit directions drawn
from JAX's `PRNGKey(key)` (`utils/jax_prng.py`, bit for bit) times
log-spaced magnitudes in [min_res, max_res], each float32 step rounded as
XLA's CPU code rounds it (see `tests/test_torch_fourier.py` for what is and
is not bit-equal to the JAX package's matrix). The JAX package recomputes
the matrix at every init and never stores it; so does the port (a
non-persistent buffer of the MLP).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import jax_prng

# Cephes' expf polynomial, as XLA's CPU backend evaluates exp in float32.
_EXP_P = tuple(np.float32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


def _exp_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 exp on the CPU (Cephes: x = n ln2 + r, a degree-5
    polynomial in r, times 2^n)."""
    f32, fma = np.float32, jax_prng._fma
    x = np.clip(np.asarray(x, f32), f32(-88.3762626647949),
                f32(88.3762626647950))
    n = np.floor(x * f32(1.44269504088896341) + f32(0.5))
    r = fma(n, f32(2.12194440e-4), fma(n, f32(-0.693359375), x))
    y = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = fma(y, r, c)
    y = f32(1.0) + fma(y, r * r, r)
    return y * np.ldexp(f32(1.0), n.astype(np.int32)).astype(f32)


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """`jnp.linspace(start, stop, num)` in float32 inside a jitted function,
    as XLA simplifies it: start * (1 - i r) + i (stop r) with r = 1 /
    (num - 1), the stop appended. XLA's CPU code evaluates the short
    loops (num <= 257: the presets' F = 96, 256) one rounding per step,
    and the long ones with fused multiply-adds."""
    f32, fma = np.float32, jax_prng._fma
    a, b = f32(start), f32(stop)
    if num == 1:
        return np.array([a], f32)
    r = f32(1.0) / f32(num - 1)
    i = np.arange(num - 1, dtype=f32)
    if num <= 257:
        body = a * (f32(1.0) - i * r) + i * (b * r)
    else:
        body = fma(i, b * r, a * fma(-i, r, f32(1.0)))
    return np.concatenate([body, [b]]).astype(f32)


def make_frequency_matrix(key: int, num_freqs: int, min_res: float,
                          max_res: float) -> np.ndarray:
    """[3, F] float32 frequency matrix: random unit directions (from JAX's
    `split(PRNGKey(key))[0]`) times log-spaced magnitudes in [min_res,
    max_res] cycles per unit cube, as the JAX `make_frequency_matrix`."""
    f32, fma = np.float32, jax_prng._fma
    k1 = jax_prng.split(jax_prng.PRNGKey(key))[0]
    dirs = jax_prng.normal(k1, (3, num_freqs))
    norm = np.sqrt(fma(dirs[2], dirs[2],
                       fma(dirs[1], dirs[1], dirs[0] * dirs[0])))
    mags = _exp_f32(_linspace_f32(np.log(min_res), np.log(max_res),
                                  num_freqs))
    return ((dirs / norm[None, :]) * mags[None, :]).astype(f32)


def fourier_encode(x01: torch.Tensor, stds: torch.Tensor,
                   freqs: torch.Tensor) -> torch.Tensor:
    """IPE-damped Fourier features, averaged over the multisample axis.

    x01: [..., n, 3] positions in [0, 1]; stds: [..., n] isotropic Gaussian
    stds; freqs: [3, F]. Returns [..., 2F] (sin || cos)."""
    two_pi = 2.0 * math.pi
    phase = two_pi * (x01 @ freqs)
    f2 = (freqs * freqs).sum(dim=0)
    damp = torch.exp(-0.5 * (two_pi * stds[..., None]) ** 2 * f2)
    feats = torch.cat([torch.sin(phase) * damp, torch.cos(phase) * damp],
                      dim=-1)
    return feats.mean(dim=-2)


def fourier_encode_pooled(x01: torch.Tensor, stds: torch.Tensor,
                          freqs: torch.Tensor) -> torch.Tensor:
    """Single-Gaussian IPE Fourier features: the n-point cloud collapsed to
    one isotropic Gaussian (mean of the means; variance the mean per-point
    variance plus the spread of the means), then the exact expectation
    under it.

    x01: [..., n, 3]; stds: [..., n]; freqs: [3, F]. Returns [..., 2F]."""
    two_pi = 2.0 * math.pi
    mu = x01.mean(dim=-2)
    spread = ((x01 - mu[..., None, :]) ** 2).mean(dim=(-2, -1))
    sigma2 = (stds**2).mean(dim=-1) + spread
    phase = two_pi * (mu @ freqs)
    f2 = (freqs * freqs).sum(dim=0)
    damp = torch.exp(-0.5 * two_pi**2 * sigma2[..., None] * f2)
    return torch.cat([torch.sin(phase) * damp, torch.cos(phase) * damp],
                     dim=-1)
