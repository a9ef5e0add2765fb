"""Multiresolution hash-grid encoder (port of `nerf_lidar_tpu/ops/grid.py`).

`HashGridSpec`/`spec_for` are re-derived here in numpy (the JAX module
imports jax); `tests/test_torch_grid.py` holds the two equal.

The multisample encode exists twice:
- `hash_encode_multisample_plain`: straightforward torch, the twin of the
  JAX `_ms_encode_impl` (linear interpolation, no coarse cutoff), and
  `hash_encode_multisample_bwd_plain`, its gradients written out;
- `hash_encode_multisample`: the wrapper the model calls, a
  `torch.autograd.Function`. CPU tensors take the plain versions; CUDA
  tensors launch kernel H1 (`csrc/kernels.cu`, `hash_encode_ms`) and in
  backward `hash_encode_ms_bwd`, or raise.

The JAX `hash_encode` (no erf weights, the object MLPs' encode) is the
multisample encode at n = 1 and stds = 0, whose erf weight
erf(1 / sqrt(max(0, 1e-10))) = erf(1e5) is exactly 1 in float32; the
object MLPs call the same wrapper with stds 0 (kernel H1, and in backward
d_table and d_x01).

`scatter_add_rows` (kernel K3 on CUDA, `index_add` on the CPU) is the row
scatter-add that K3's Pallas version did with a one-hot matmul; the
hash-decay loss sums its levels with it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from . import _build

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
# Channel widths kernel H1 is instantiated for: those of the ported presets'
# grids (proposal 1, NeRF 4, tiny_debug's NeRF 2).
_KERNEL_LEVEL_DIMS = (1, 2, 4)
# Channel widths kernel K3 takes: the powers of two that divide a warp.
_SCATTER_WIDTHS = (1, 2, 4, 8, 16, 32)
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


def hash_encode_multisample_bwd_plain(table: torch.Tensor, x01: torch.Tensor,
                                      stds: torch.Tensor, g_out: torch.Tensor,
                                      spec: HashGridSpec,
                                      needs=(True, True, True)):
    """Gradients of `hash_encode_multisample_plain`'s features, written out
    (the plain twin of kernel H1's backward).

    g_out: [..., L*C], the gradient of the features. Returns (d_table,
    d_x01, d_stds), each None where `needs` (table, x01, stds) is False.
    Out-of-range points get zero gradient, as the JAX `where` gives them.
    """
    _check_ported(spec)
    n_ms = x01.shape[-2]
    c = spec.level_dim
    x = x01.reshape(-1, 3)
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1)
    x = torch.where(oob[:, None], torch.zeros_like(x), x)
    s = stds.reshape(-1)
    g = g_out.reshape(-1, spec.output_dim)
    keep = (~oob).to(x.dtype) / n_ms
    d_table = torch.zeros_like(table) if needs[0] else None
    d_x = torch.zeros_like(x) if needs[1] else None
    d_s = torch.zeros_like(s) if needs[2] else None
    grid_sizes = spec.grid_sizes()

    for l in range(spec.num_levels):
        gl = g[:, l * c:(l + 1) * c].repeat_interleave(n_ms, dim=0)
        pos = x * spec.scales[l] + 0.5
        pos_grid = torch.floor(pos)
        frac = pos - pos_grid
        ig = pos_grid.to(torch.int64)
        u = 8.0 * s**2 * float(grid_sizes[l] * grid_sizes[l])
        v = 1.0 / torch.sqrt(torch.clamp(u, min=1e-10))
        coef = keep * torch.erf(v)
        fdot = torch.zeros_like(s)
        dfrac = torch.zeros_like(x)
        for corner in _CORNERS3:
            f = [frac[:, d] if corner[d] else 1.0 - frac[:, d]
                 for d in range(3)]
            w = f[0] * f[1] * f[2]
            idx = spec.offsets[l] + _corner_index(
                spec, l, ig[:, 0] + corner[0], ig[:, 1] + corner[1],
                ig[:, 2] + corner[2])
            if d_table is not None:
                d_table.index_add_(0, idx, (coef * w)[:, None] * gl)
            if d_x is not None or d_s is not None:
                dot = (table[idx] * gl).sum(dim=-1)
                fdot = fdot + w * dot
                for d in range(3):
                    sign = 1.0 if corner[d] else -1.0
                    others = f[(d + 1) % 3] * f[(d + 2) % 3]
                    dfrac[:, d] += sign * others * dot
        if d_x is not None:
            d_x += (coef * spec.scales[l])[:, None] * dfrac
        if d_s is not None:
            # d erf(v)/ds with v = u^-1/2, u = 8 s^2 g^2; 0 where u is
            # clamped.
            dwl = (2.0 / np.sqrt(np.pi)) * torch.exp(-v * v) * (
                -0.5 * v / u) * (16.0 * s * float(grid_sizes[l]) ** 2)
            d_s += keep * torch.where(u > 1e-10, dwl, 0.0) * fdot
    return (d_table,
            None if d_x is None else d_x.reshape(x01.shape),
            None if d_s is None else d_s.reshape(stds.shape))


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU: then the plain version runs;
    otherwise the kernel's wrapper runs and refuses a tensor off the card."""
    return all(t.device.type == "cpu" for t in tensors)


def _kernel_levels(spec: HashGridSpec):
    """Per-level constants of kernel H1, as the C arrays it reads."""
    return (np.asarray(spec.scales, np.float32),
            spec.grid_sizes(),
            np.asarray(spec.resolutions, np.uint32),
            np.asarray(spec.rows_per_level, np.uint32),
            np.asarray(spec.offsets[:-1], np.uint32),
            np.asarray([spec.is_tiled(l) for l in range(spec.num_levels)],
                       np.int32))


def level_major(spec: HashGridSpec, l2_bytes: int) -> bool:
    """Block order of kernel H1 and its backward on a card with an L2 of
    `l2_bytes`, as measured on the train step's and a render chunk's points
    (PERF.md): a table larger than the L2 (the NeRF grid's 240 MB against
    the H100's 50 MB) runs level-major, so that one level's slice (up to
    33.5 MB) takes the reads or atomics in L2, and each block stages its
    tile of x01 / stds through shared memory; a table that fits (the
    proposal grids' 26 and 43 MB) runs a tile's levels in neighbouring
    blocks, which find the tile in L2."""
    return spec.total_rows * spec.level_dim * 4 > l2_bytes


@functools.cache
def _l2_bytes(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).L2_cache_size


def _aligned(name: str, t: torch.Tensor, c: int) -> torch.Tensor:
    """Raise unless t starts on a 4c-byte boundary: kernel H1 reads rows of
    C floats as one 4C-byte vector, K3 reads 16 bytes (c = 4) at a time."""
    if t.data_ptr() % (4 * c):
        raise ValueError(f"{name}: expected a {4 * c}-byte aligned tensor")
    return t


def _kernel_inputs(table, x01, stds, spec: HashGridSpec):
    """Checked, contiguous [rows, C], [B, n, 3], [B, n] views for H1 and its
    backward; raises on what the kernels do not take."""
    _check_ported(spec)
    if spec.level_dim not in _KERNEL_LEVEL_DIMS:
        raise NotImplementedError(
            f"kernel hash_encode_ms is built for level_dim in "
            f"{_KERNEL_LEVEL_DIMS}, not {spec.level_dim}")
    if spec.total_rows > _U32:
        raise ValueError("table rows exceed the kernel's uint32 offsets")
    n_ms = x01.shape[-2]
    x = x01.reshape(-1, n_ms, 3).contiguous()
    s = stds.reshape(-1, n_ms).contiguous()
    table = table.contiguous()
    b = x.shape[0]
    _build.require_cuda("table", table, (spec.total_rows, spec.level_dim))
    _build.require_cuda("x01", x, (b, n_ms, 3))
    _build.require_cuda("stds", s, (b, n_ms))
    return _aligned("table", table, spec.level_dim), x, s


def _encode_kernel(table, x01, stds, spec: HashGridSpec) -> torch.Tensor:
    """Launch kernel H1 (`hash_encode_ms`): [..., L*C] features."""
    table, x, s = _kernel_inputs(table, x01, stds, spec)
    b, n_ms = s.shape
    out = torch.empty((b, spec.output_dim), dtype=torch.float32,
                      device=x.device)
    arrays = _kernel_levels(spec)  # alive through the call
    lib = _build.library()
    rc = lib.nl_hash_encode_ms(
        table.data_ptr(), x.data_ptr(), s.data_ptr(), out.data_ptr(),
        b, n_ms, spec.num_levels, spec.level_dim,
        *(a.ctypes.data for a in arrays),
        level_major(spec, _l2_bytes(x.device.index)),
        x.device.index, _build.stream_of(x))
    _build.check(lib, rc, "hash_encode_ms")
    hash_encode_multisample.launches += 1
    return out.reshape(x01.shape[:-2] + (spec.output_dim,))


def hash_encode_multisample_bwd(table: torch.Tensor, x01: torch.Tensor,
                                stds: torch.Tensor, g_out: torch.Tensor,
                                spec: HashGridSpec, needs=(True, True, True)):
    """Same contract as `hash_encode_multisample_bwd_plain`; CUDA tensors
    launch the H1 backward kernel (`hash_encode_ms_bwd`) or raise."""
    if _on_cpu(table, x01, stds, g_out):
        return hash_encode_multisample_bwd_plain(table, x01, stds, g_out,
                                                 spec, needs)
    table, x, s = _kernel_inputs(table, x01, stds, spec)
    b, n_ms = s.shape
    g = g_out.contiguous()
    _build.require_cuda("g_out", g, x01.shape[:-2] + (spec.output_dim,))
    g = _aligned("g_out", g.reshape(b, spec.output_dim), spec.level_dim)
    outs = [torch.zeros_like(t) if need else None
            for t, need in zip((table, x, s), needs)]
    ptr = lambda t: None if t is None else t.data_ptr()
    arrays = _kernel_levels(spec)  # alive through the call
    lib = _build.library()
    rc = lib.nl_hash_encode_ms_bwd(
        table.data_ptr(), x.data_ptr(), s.data_ptr(), g.data_ptr(),
        *(ptr(t) for t in outs), b, n_ms, spec.num_levels, spec.level_dim,
        *(a.ctypes.data for a in arrays),
        level_major(spec, _l2_bytes(x.device.index)),
        x.device.index, _build.stream_of(x))
    _build.check(lib, rc, "hash_encode_ms_bwd")
    hash_encode_multisample_bwd.launches += 1
    d_table, d_x, d_s = outs
    return (d_table,
            None if d_x is None else d_x.reshape(x01.shape),
            None if d_s is None else d_s.reshape(stds.shape))


hash_encode_multisample_bwd.launches = 0


class HashEncodeMS(torch.autograd.Function):
    """The multisample encode with its written-out backward: kernel H1 and
    its backward on CUDA tensors, the plain twins on CPU tensors."""

    @staticmethod
    def forward(ctx, table, x01, stds, spec: HashGridSpec):
        ctx.spec = spec
        ctx.save_for_backward(table, x01, stds)
        if _on_cpu(table, x01, stds):
            return hash_encode_multisample_plain(table, x01, stds, spec)[0]
        return _encode_kernel(table, x01, stds, spec)

    @staticmethod
    def backward(ctx, g_out):
        table, x01, stds = ctx.saved_tensors
        grads = hash_encode_multisample_bwd(
            table, x01, stds, g_out, ctx.spec, ctx.needs_input_grad[:3])
        return (*grads, None)


def hash_encode_multisample(table: torch.Tensor, x01: torch.Tensor,
                            stds: torch.Tensor,
                            spec: HashGridSpec) -> torch.Tensor:
    """[..., L*C] multisample features (no erf weights), differentiable in
    table, x01 and stds.

    CPU tensors take `hash_encode_multisample_plain` and its written-out
    backward; CUDA tensors launch kernel H1 (`hash_encode_ms`) and, in
    backward, `hash_encode_ms_bwd`; a build or launch failure raises.
    """
    return HashEncodeMS.apply(table, x01, stds, spec)


hash_encode_multisample.launches = 0


@functools.lru_cache(maxsize=8)
def level_ids(spec: HashGridSpec, device=None) -> torch.Tensor:
    """[total_rows] int32 level id of every table row (the segment ids of
    the hash-decay loss). Built once per (spec, device) and shared: do not
    modify it."""
    return torch.repeat_interleave(
        torch.arange(spec.num_levels, dtype=torch.int32, device=device),
        torch.tensor(spec.rows_per_level, device=device),
        output_size=spec.total_rows)


def scatter_add_rows_plain(idx: torch.Tensor, vals: torch.Tensor,
                           rows: int) -> torch.Tensor:
    """out[r] = sum of vals[i] over idx[i] == r: idx [N] int32, vals [N, C]
    -> [rows, C]. Indices outside [0, rows) are dropped, as the one-hot of
    the TPU kernel (K3, `experiments/scatter_variants.py`) drops them."""
    ok = (idx >= 0) & (idx < rows)
    out = vals.new_zeros((rows, vals.shape[-1]))
    return out.index_add(0, idx[ok].long(), vals[ok])


def _scatter_kernel(idx: torch.Tensor, vals: torch.Tensor,
                    rows: int) -> torch.Tensor:
    """Launch kernel K3 (`scatter_add_rows`)."""
    idx, vals = idx.contiguous(), vals.contiguous()
    n, c = vals.shape
    if c not in _SCATTER_WIDTHS:
        raise NotImplementedError(f"kernel scatter_add_rows takes C in "
                                  f"{_SCATTER_WIDTHS}, not {c}")
    _build.require_cuda("idx", idx, (n,), torch.int32)
    _build.require_cuda("vals", vals, (n, c))
    _aligned("idx", idx, 4)
    _aligned("vals", vals, 4)
    out = torch.zeros((rows, c), dtype=torch.float32, device=vals.device)
    lib = _build.library()
    rc = lib.nl_scatter_add_rows(idx.data_ptr(), vals.data_ptr(),
                                 out.data_ptr(), n, c, rows,
                                 vals.device.index, _build.stream_of(vals))
    _build.check(lib, rc, "scatter_add_rows")
    scatter_add_rows.launches += 1
    return out


class ScatterAddRows(torch.autograd.Function):
    """K3 with its backward, the gather g_out[idx] (0 for dropped rows)."""

    @staticmethod
    def forward(ctx, idx, vals, rows: int):
        ctx.save_for_backward(idx)
        ctx.rows = rows
        if _on_cpu(idx, vals):
            return scatter_add_rows_plain(idx, vals, rows)
        return _scatter_kernel(idx, vals, rows)

    @staticmethod
    def backward(ctx, g_out):
        (idx,) = ctx.saved_tensors
        # Dropped indices read an appended zero row.
        g = torch.cat([g_out, g_out.new_zeros((1, g_out.shape[1]))])
        ok = (idx >= 0) & (idx < ctx.rows)
        return None, g.index_select(0, torch.where(ok, idx, ctx.rows)), None


def scatter_add_rows(idx: torch.Tensor, vals: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """Same contract as `scatter_add_rows_plain`, differentiable in vals;
    CUDA tensors launch kernel K3 (`scatter_add_rows`) or raise, also on an
    idx or vals that does not start on 16 bytes."""
    if idx.dim() != 1 or vals.dim() != 2 or idx.shape[0] != vals.shape[0]:
        raise ValueError(f"expected idx [N] and vals [N, C], got "
                         f"{tuple(idx.shape)} and {tuple(vals.shape)}")
    return ScatterAddRows.apply(idx, vals, rows)


scatter_add_rows.launches = 0
