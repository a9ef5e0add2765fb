"""Multiresolution hash-grid encoder (port of `nerf_lidar_tpu/ops/grid.py`).

`HashGridSpec`/`spec_for` are re-derived here in numpy (the JAX module
imports jax); `tests/test_torch_grid.py` holds the two equal.

The multisample encode exists twice:
- `hash_encode_multisample_plain`: straightforward torch, the twin of the
  JAX `_ms_encode_impl` (linear interpolation, no coarse cutoff);
- `hash_encode_multisample`: the wrapper the model calls. A CPU tensor takes
  the plain version; a CUDA tensor launches kernel H1 (`csrc/kernels.cu`,
  `hash_encode_ms`) or raises.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import _build

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
# Channel widths kernel H1 is instantiated for: those of the ported presets'
# grids (proposal 1, NeRF 4, tiny_debug's NeRF 2).
_KERNEL_LEVEL_DIMS = (1, 2, 4)
# The 8 unit-cube corner offsets, corner c = (c & 1, c >> 1 & 1, c >> 2 & 1).
_CORNERS3 = [[(c >> d) & 1 for d in range(3)] for c in range(8)]


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static description of a multiresolution hash grid (same fields and
    derivations as the JAX `HashGridSpec`)."""
    num_levels: int = 10
    level_dim: int = 4
    base_resolution: int = 16
    desired_resolution: int = 8192
    log2_hashmap_size: int = 21
    input_dim: int = 3
    interp: str = "linear"
    diff_inputs: bool = True

    @property
    def per_level_scale(self) -> float:
        if self.num_levels <= 1:
            return 1.0
        return float(np.exp2(
            np.log2(self.desired_resolution / self.base_resolution)
            / (self.num_levels - 1)))

    @property
    def scales(self) -> Tuple[float, ...]:
        """Continuous grid scale per level: exp2(l*S)*H - 1."""
        s = self.per_level_scale
        return tuple(
            float(np.exp2(l * np.log2(s)) * self.base_resolution - 1.0)
            for l in range(self.num_levels))

    @property
    def resolutions(self) -> Tuple[int, ...]:
        """Grid side length per level: ceil(H * s^l) + 1."""
        s = self.per_level_scale
        return tuple(
            int(np.ceil(self.base_resolution * s**l)) + 1
            for l in range(self.num_levels))

    @property
    def rows_per_level(self) -> Tuple[int, ...]:
        max_rows = 2**self.log2_hashmap_size
        return tuple(int(np.ceil(min(max_rows, r**self.input_dim) / 8) * 8)
                     for r in self.resolutions)

    @property
    def offsets(self) -> Tuple[int, ...]:
        offs = [0]
        for n in self.rows_per_level:
            offs.append(offs[-1] + n)
        return tuple(offs)

    @property
    def total_rows(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def is_tiled(self, level: int) -> bool:
        """Direct (tiled) indexing when the full grid fits the hashmap."""
        r = self.resolutions[level]
        return r**self.input_dim <= self.rows_per_level[level]

    def grid_sizes(self) -> np.ndarray:
        """Per-level resolutions used by the erf multisample downweighting."""
        return np.asarray(self.resolutions, dtype=np.float32)


def spec_for(grid_cfg) -> HashGridSpec:
    """The table spec for a `configs.GridConfig` ('hash' encoder only)."""
    if grid_cfg.encoder != "hash":
        raise NotImplementedError(
            f"encoder={grid_cfg.encoder!r} is not ported (only 'hash')")
    return HashGridSpec(
        num_levels=grid_cfg.num_levels, level_dim=grid_cfg.level_dim,
        base_resolution=grid_cfg.base_resolution,
        desired_resolution=grid_cfg.desired_resolution,
        log2_hashmap_size=grid_cfg.log2_hashmap_size,
        interp=grid_cfg.interp, diff_inputs=grid_cfg.diff_inputs)


def _check_ported(spec: HashGridSpec) -> None:
    if spec.interp != "linear":
        raise NotImplementedError(f"interp={spec.interp!r} is not ported")
    if spec.input_dim != 3:
        raise NotImplementedError(f"input_dim={spec.input_dim} is not ported")


def _corner_index(spec: HashGridSpec, level: int, cx, cy, cz):
    """Row index within `level` for non-negative int64 corner coords, with
    the reference's uint32 wraparound (each product and the XOR masked to
    32 bits) before `% rows`."""
    if spec.is_tiled(level):
        r = spec.resolutions[level]
        idx = (cx + ((cy * r) & _U32) + ((((cz * r) & _U32) * r) & _U32)) & _U32
    else:
        idx = (((cx * _PRIMES[0]) & _U32) ^ ((cy * _PRIMES[1]) & _U32)
               ^ ((cz * _PRIMES[2]) & _U32))
    return idx % spec.rows_per_level[level]


def hash_encode_multisample_plain(table: torch.Tensor, x01: torch.Tensor,
                                  stds: torch.Tensor, spec: HashGridSpec):
    """Encode n multisample points and reduce with erf downweighting.

    table: [total_rows, C]; x01: [..., n, 3] (points outside [0, 1] encode
    to 0); stds: [..., n]. Returns ([..., L*C] features, [..., n, L] erf
    weights), as the JAX `hash_encode_multisample`.
    """
    _check_ported(spec)
    batch_shape = x01.shape[:-2]
    n_ms = x01.shape[-2]
    c = spec.level_dim
    x = x01.reshape(-1, 3)
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1)
    # Out-of-range points are zeroed after the gather; indexing them at the
    # origin keeps every corner coordinate small and non-negative.
    x = torch.where(oob[:, None], torch.zeros_like(x), x)
    s = stds.reshape(-1)
    grid_sizes = spec.grid_sizes()

    outs, weights = [], []
    for l in range(spec.num_levels):
        tbl = table[spec.offsets[l]:spec.offsets[l + 1]]
        pos = x * spec.scales[l] + 0.5
        pos_grid = torch.floor(pos)
        frac = pos - pos_grid
        ig = pos_grid.to(torch.int64)
        acc = None
        for cx, cy, cz in _CORNERS3:
            w = ((frac[:, 0] if cx else 1.0 - frac[:, 0])
                 * (frac[:, 1] if cy else 1.0 - frac[:, 1])
                 * (frac[:, 2] if cz else 1.0 - frac[:, 2]))
            idx = _corner_index(spec, l, ig[:, 0] + cx, ig[:, 1] + cy,
                                ig[:, 2] + cz)
            term = w[:, None] * tbl[idx]
            acc = term if acc is None else acc + term
        acc = torch.where(oob[:, None], torch.zeros_like(acc), acc)
        g2 = float(grid_sizes[l] * grid_sizes[l])
        w_l = torch.erf(1.0 / torch.sqrt(torch.clamp(8.0 * s**2 * g2,
                                                     min=1e-10)))
        weights.append(w_l)
        outs.append((acc * w_l[:, None]).reshape(-1, n_ms, c).mean(dim=1))
    out = torch.cat(outs, dim=-1).reshape(batch_shape + (spec.output_dim,))
    w = torch.stack(weights, dim=-1).reshape(
        batch_shape + (n_ms, spec.num_levels))
    return out, w


def _kernel_levels(spec: HashGridSpec):
    """Per-level constants of kernel H1, as the C arrays it reads."""
    return (np.asarray(spec.scales, np.float32),
            spec.grid_sizes(),
            np.asarray(spec.resolutions, np.uint32),
            np.asarray(spec.rows_per_level, np.uint32),
            np.asarray(spec.offsets[:-1], np.uint32),
            np.asarray([spec.is_tiled(l) for l in range(spec.num_levels)],
                       np.int32))


def hash_encode_multisample(table: torch.Tensor, x01: torch.Tensor,
                            stds: torch.Tensor,
                            spec: HashGridSpec) -> torch.Tensor:
    """[..., L*C] multisample features (no erf weights).

    CPU tensors take `hash_encode_multisample_plain`; CUDA tensors launch
    kernel H1 (`hash_encode_ms`), and a build or launch failure raises.
    """
    if x01.device.type == "cpu":
        return hash_encode_multisample_plain(table, x01, stds, spec)[0]
    _check_ported(spec)
    if spec.level_dim not in _KERNEL_LEVEL_DIMS:
        raise NotImplementedError(
            f"kernel hash_encode_ms is built for level_dim in "
            f"{_KERNEL_LEVEL_DIMS}, not {spec.level_dim}")
    if spec.total_rows > _U32:
        raise ValueError("table rows exceed the kernel's uint32 offsets")
    batch_shape = x01.shape[:-2]
    n_ms = x01.shape[-2]
    x = x01.reshape(-1, n_ms, 3).contiguous()
    s = stds.reshape(-1, n_ms).contiguous()
    table = table.contiguous()
    b = x.shape[0]
    _build.require_cuda_f32("table", table, (spec.total_rows, spec.level_dim))
    _build.require_cuda_f32("x01", x, (b, n_ms, 3))
    _build.require_cuda_f32("stds", s, (b, n_ms))
    out = torch.empty((b, spec.output_dim), dtype=torch.float32,
                      device=x.device)
    levels = _kernel_levels(spec)
    lib = _build.library()
    rc = lib.nl_hash_encode_ms(
        table.data_ptr(), x.data_ptr(), s.data_ptr(), out.data_ptr(),
        b, n_ms, spec.num_levels, spec.level_dim,
        *(a.ctypes.data for a in levels),
        x.device.index, _build.stream_of(x))
    _build.check(lib, rc, "hash_encode_ms")
    hash_encode_multisample.launches += 1
    return out.reshape(batch_shape + (spec.output_dim,))


hash_encode_multisample.launches = 0
