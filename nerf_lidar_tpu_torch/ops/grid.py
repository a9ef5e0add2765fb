"""Multiresolution hash-grid encoder (port of `nerf_lidar_tpu/ops/grid.py`).

`HashGridSpec`/`spec_for` are re-derived here in numpy (the JAX module
imports jax); `tests/test_torch_grid.py` holds the two equal.

The multisample encode exists twice:
- `hash_encode_multisample_plain`: straightforward torch, the twin of the
  JAX `_ms_encode_impl` (trilinear or tetrahedral interpolation, levels at
  or below a coarse cutoff encoding the multisample mean), and
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

Deterministic sums: with `torch.are_deterministic_algorithms_enabled()`
the backward and K3 take `hash_encode_multisample_bwd_det` and
`scatter_add_rows_det`, whose results do not depend on the order of their
sums, as the JAX package's XLA scatter-adds do not: each term is rounded
once to a fixed-point int64 (`fixed_exponents`) and summed exactly, on
CUDA by the kernels `hash_encode_ms_bwd_fixed` / `scatter_add_rows_fixed`
(d_x01 / d_stds by the atomic-free `hash_encode_ms_pos_grads`), on the CPU
by their plain twins (`..._det_plain`: the same terms and rounding,
`index_add_` on int64). A non-finite term flags its entry NaN / +inf /
-inf, as a float sum of the same terms ends.
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
# Channel widths kernel H1 is instantiated for: those of the presets' grids
# (proposal 1 and 4, NeRF 4 and 16, object and tiny_debug's NeRF 2).
_KERNEL_LEVEL_DIMS = (1, 2, 4, 16)
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
    """The table spec for a `configs.GridConfig`, as the JAX `spec_for`.

    encoder='dense_fourier' keeps only the dense tiled band: levels up to
    fourier_dense_res, with the hashmap sized to hold the finest corner
    lattice (the high-resolution band is `ops/fourier.py`'s features)."""
    if grid_cfg.encoder not in ("hash", "dense_fourier"):
        raise NotImplementedError(
            f"encoder={grid_cfg.encoder!r} is not ported")
    num_levels = grid_cfg.num_levels
    desired = grid_cfg.desired_resolution
    log2 = grid_cfg.log2_hashmap_size
    if grid_cfg.encoder == "dense_fourier":
        desired = min(grid_cfg.fourier_dense_res, desired)
        num_levels = int(np.log(desired / grid_cfg.base_resolution)
                         / np.log(grid_cfg.level_interval)) + 1
        log2 = max(log2, int(np.ceil(np.log2((desired + 2) ** 3))))
    return HashGridSpec(
        num_levels=num_levels, level_dim=grid_cfg.level_dim,
        base_resolution=grid_cfg.base_resolution,
        desired_resolution=desired, log2_hashmap_size=log2,
        interp=grid_cfg.interp, diff_inputs=grid_cfg.diff_inputs)


def _check_ported(spec: HashGridSpec) -> None:
    if spec.interp not in ("linear", "tetra"):
        raise NotImplementedError(f"interp={spec.interp!r} is not ported")
    if spec.input_dim != 3:
        raise NotImplementedError(f"input_dim={spec.input_dim} is not ported")


def mean_levels(spec: HashGridSpec, coarse_res_cutoff: int):
    """Per level: True where the level encodes only the multisample mean
    point (resolution <= coarse_res_cutoff; the JAX coarse cutoff)."""
    return [r <= coarse_res_cutoff for r in spec.resolutions]


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


def grid_pos(x: torch.Tensor, scale: float) -> torch.Tensor:
    """pos = x * scale + 0.5 with one rounding (a fused multiply-add), as
    XLA's CPU code and kernel H1 (`cell_of`) compute it: the float32
    product is exact in float64 and so is the sum, so rounding that once
    gives the fused result. At the finest levels one float32 ulp of pos is
    ~1e-3 of a cell, so a second rounding would move the weights."""
    s = float(np.float32(scale))
    return (x.to(torch.float64) * s + 0.5).to(x.dtype)


def _balanced_grad(op, fx, fy, fz):
    """[N, 3] gradient of op(op(fx, fy), fz) for op = maximum / minimum,
    with JAX's (and torch's) rule at ties: an input equal to the result
    takes 1, or 0.5 when the other input equals it too."""
    def share(a, b, m):
        return torch.where(a == m, torch.where(b == m, 0.5, 1.0), 0.0)
    m = op(fx, fy)
    s = op(m, fz)
    dm = share(m, fz, s)
    return torch.stack([share(fx, fy, m) * dm, share(fy, fx, m) * dm,
                        share(fz, m, s)], dim=-1)


def _corners(spec: HashGridSpec, level: int, x: torch.Tensor,
             grads: bool = False):
    """The interpolation corners of `level` at points x [N, 3] (in range):
    a list of (row within the level [N], weight [N], d weight / d frac
    [N, 3] or None unless `grads`), as the JAX `_corner_list`: the 8 cube
    corners (linear) or the 4 vertices of the Kuhn simplex that holds the
    point (tetra; ranks with the JAX tie-break, weights 1-s1, s1-s2,
    s2-s3, s3 of the sorted fractions)."""
    pos = grid_pos(x, spec.scales[level])
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    ig = pos_grid.to(torch.int64)
    out = []
    if spec.interp == "tetra":
        fx, fy, fz = frac.unbind(-1)
        ranks = torch.stack([
            (fy > fx).long() + (fz > fx).long(),
            (fx >= fy).long() + (fz > fy).long(),
            (fx >= fz).long() + (fy >= fz).long()], dim=-1)
        s1 = torch.maximum(torch.maximum(fx, fy), fz)
        s3 = torch.minimum(torch.minimum(fx, fy), fz)
        s2 = fx + fy + fz - s1 - s3
        weights = [1.0 - s1, s1 - s2, s2 - s3, s3]
        dws = [None] * 4
        if grads:
            d1 = _balanced_grad(torch.maximum, fx, fy, fz)
            d3 = _balanced_grad(torch.minimum, fx, fy, fz)
            d2 = 1.0 - d1 - d3
            dws = [-d1, d1 - d2, d2 - d3, d3]
        for k in range(4):
            c = ig + (ranks < k).long()
            idx = _corner_index(spec, level, c[:, 0], c[:, 1], c[:, 2])
            out.append((idx, weights[k], dws[k]))
        return out
    for corner in _CORNERS3:
        f = [frac[:, d] if corner[d] else 1.0 - frac[:, d] for d in range(3)]
        dw = None
        if grads:
            dw = torch.stack([(1.0 if corner[d] else -1.0)
                              * f[(d + 1) % 3] * f[(d + 2) % 3]
                              for d in range(3)], dim=-1)
        idx = _corner_index(spec, level, ig[:, 0] + corner[0],
                            ig[:, 1] + corner[1], ig[:, 2] + corner[2])
        out.append((idx, f[0] * f[1] * f[2], dw))
    return out


def _in_range(x: torch.Tensor):
    """(x with out-of-range points moved to the origin, their mask [N]).
    Out-of-range points encode to 0 after the gather; indexing them at the
    origin keeps every corner coordinate small and non-negative."""
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1)
    return torch.where(oob[:, None], torch.zeros_like(x), x), oob


def _seq_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over axis 1 of [B, n, ...]: summed in point order and times
    float32(1 / n), as XLA's CPU code and kernel H1 take it, so that all
    three pick the same cell for a mean on a cell face."""
    acc = x[:, 0]
    for j in range(1, x.shape[1]):
        acc = acc + x[:, j]
    return acc * float(np.float32(1.0) / np.float32(x.shape[1]))


def _erf_weight(s: torch.Tensor, grid_size: float):
    """(erf weight, u = 8 s^2 g^2, v = u^-1/2 clamped): the ZipNeRF
    downweighting of a level at per-point stds s."""
    u = 8.0 * s**2 * float(grid_size * grid_size)
    v = 1.0 / torch.sqrt(torch.clamp(u, min=1e-10))
    return torch.erf(v), u, v


def erf_weights(stds: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """[..., n, L] erf weights of every point and level at stds [..., n]
    (the second output of the JAX `hash_encode_multisample`; no gradient
    to stds when `spec.diff_inputs` is False, as its custom VJP)."""
    if not spec.diff_inputs:
        stds = stds.detach()
    return torch.stack([_erf_weight(stds, g)[0] for g in spec.grid_sizes()],
                       dim=-1)


def hash_encode_multisample_plain(table: torch.Tensor, x01: torch.Tensor,
                                  stds: torch.Tensor, spec: HashGridSpec,
                                  coarse_res_cutoff: int = 0):
    """Encode n multisample points and reduce with erf downweighting.

    table: [total_rows, C]; x01: [..., n, 3] (points outside [0, 1] encode
    to 0); stds: [..., n]. Levels at or below `coarse_res_cutoff` encode the
    mean of the n points (out-of-range ones included; the level is 0 when
    the mean is out of range) once, weighted by the mean erf weight.
    Returns ([..., L*C] features, [..., n, L] erf weights), as the JAX
    `hash_encode_multisample`. With `spec.diff_inputs` False no gradient
    reaches x01 or stds (the JAX custom VJP's zeros).
    """
    _check_ported(spec)
    if not spec.diff_inputs:
        x01, stds = x01.detach(), stds.detach()
    batch_shape = x01.shape[:-2]
    n_ms = x01.shape[-2]
    c = spec.level_dim
    x, oob = _in_range(x01.reshape(-1, 3))
    s = stds.reshape(-1)
    grid_sizes = spec.grid_sizes()
    mean = None

    outs, weights = [], []
    for l, at_mean in enumerate(mean_levels(spec, coarse_res_cutoff)):
        tbl = table[spec.offsets[l]:spec.offsets[l + 1]]
        w_l = _erf_weight(s, grid_sizes[l])[0]
        weights.append(w_l)
        if at_mean and mean is None:
            mean = _in_range(_seq_mean(x01.reshape(-1, n_ms, 3)))
        pts, pts_oob = mean if at_mean else (x, oob)
        acc = None
        for idx, w, _ in _corners(spec, l, pts):
            term = w[:, None] * tbl[idx]
            acc = term if acc is None else acc + term
        acc = torch.where(pts_oob[:, None], torch.zeros_like(acc), acc)
        if at_mean:
            outs.append(acc * _seq_mean(w_l.reshape(-1, n_ms))[:, None])
        else:
            outs.append((acc * w_l[:, None]).reshape(-1, n_ms, c).mean(dim=1))
    out = torch.cat(outs, dim=-1).reshape(batch_shape + (spec.output_dim,))
    w = torch.stack(weights, dim=-1).reshape(
        batch_shape + (n_ms, spec.num_levels))
    return out, w


def hash_encode_multisample_bwd_plain(table: torch.Tensor, x01: torch.Tensor,
                                      stds: torch.Tensor, g_out: torch.Tensor,
                                      spec: HashGridSpec,
                                      needs=(True, True, True),
                                      coarse_res_cutoff: int = 0):
    """Gradients of `hash_encode_multisample_plain`'s features, written out
    (the plain twin of kernel H1's backward).

    g_out: [..., L*C], the gradient of the features. Returns (d_table,
    d_x01, d_stds), each None where `needs` (table, x01, stds) is False.
    Out-of-range points get zero gradient, as the JAX `where` gives them;
    a mean-point level scatters into d_table at the mean point with the
    mean erf weight, and passes 1/n of the mean's gradient to each point.
    (The JAX custom VJP of `diff_inputs=False` is d_table alone: the caller
    asks for no more.)
    """
    _check_ported(spec)
    n_ms = x01.shape[-2]
    c = spec.level_dim
    x, oob = _in_range(x01.reshape(-1, 3))
    s = stds.reshape(-1)
    g = g_out.reshape(-1, spec.output_dim)
    keep = (~oob).to(x.dtype) / n_ms
    d_table = torch.zeros_like(table) if needs[0] else None
    d_x = torch.zeros_like(x) if needs[1] else None
    d_s = torch.zeros_like(s) if needs[2] else None
    pos_grads = d_x is not None or d_s is not None
    grid_sizes = spec.grid_sizes()
    mean = None

    for l, at_mean in enumerate(mean_levels(spec, coarse_res_cutoff)):
        gl = g[:, l * c:(l + 1) * c]
        erf_w, u, v = _erf_weight(s, grid_sizes[l])
        if at_mean:
            if mean is None:
                mean = _in_range(_seq_mean(x01.reshape(-1, n_ms, 3)))
            pts, keep_m = mean[0], (~mean[1]).to(x.dtype)
            coef = keep_m * _seq_mean(erf_w.reshape(-1, n_ms))
        else:
            pts, coef = x, keep * erf_w
            gl = gl.repeat_interleave(n_ms, dim=0)
        fdot = torch.zeros_like(coef)
        dfrac = torch.zeros_like(pts)
        for idx, w, dw in _corners(spec, l, pts, grads=pos_grads):
            idx = spec.offsets[l] + idx
            if d_table is not None:
                d_table.index_add_(0, idx, (coef * w)[:, None] * gl)
            if pos_grads:
                dot = (table[idx] * gl).sum(dim=-1)
                fdot = fdot + w * dot
                dfrac = dfrac + dw * dot[:, None]
        if at_mean:
            # x_mean = sum_j x_j / n and w_mean = sum_j w_j / n.
            coef = coef / n_ms
            fdot = (keep_m * fdot / n_ms).repeat_interleave(n_ms)
            if d_x is not None:
                d_x += ((coef * spec.scales[l])[:, None]
                        * dfrac).repeat_interleave(n_ms, dim=0)
        else:
            fdot = keep * fdot
            if d_x is not None:
                d_x += (coef * spec.scales[l])[:, None] * dfrac
        if d_s is not None:
            # d erf(v)/ds with v = u^-1/2, u = 8 s^2 g^2; 0 where u is
            # clamped.
            dwl = (2.0 / np.sqrt(np.pi)) * torch.exp(-v * v) * (
                -0.5 * v / u) * (16.0 * s * float(grid_sizes[l]) ** 2)
            d_s += torch.where(u > 1e-10, dwl, 0.0) * fdot
    return (d_table,
            None if d_x is None else d_x.reshape(x01.shape),
            None if d_s is None else d_s.reshape(stds.shape))


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU: then the plain version runs;
    otherwise the kernel's wrapper runs and refuses a tensor off the card."""
    return all(t.device.type == "cpu" for t in tensors)


def _kernel_levels(spec: HashGridSpec, coarse_res_cutoff: int):
    """Per-level constants of kernel H1, as the C arrays it reads."""
    return (np.asarray(spec.scales, np.float32),
            spec.grid_sizes(),
            np.asarray(spec.resolutions, np.uint32),
            np.asarray(spec.rows_per_level, np.uint32),
            np.asarray(spec.offsets[:-1], np.uint32),
            np.asarray([spec.is_tiled(l) for l in range(spec.num_levels)],
                       np.int32),
            np.asarray(mean_levels(spec, coarse_res_cutoff), np.int32))


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
    C floats as 4C-byte vectors of up to 16 bytes (c = min(C, 4)), K3 reads
    16 bytes (c = 4) at a time."""
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
    return _aligned("table", table, min(spec.level_dim, 4)), x, s


def _encode_kernel(table, x01, stds, spec: HashGridSpec,
                   coarse_res_cutoff: int = 0) -> torch.Tensor:
    """Launch kernel H1 (`hash_encode_ms`): [..., L*C] features."""
    table, x, s = _kernel_inputs(table, x01, stds, spec)
    b, n_ms = s.shape
    out = torch.empty((b, spec.output_dim), dtype=torch.float32,
                      device=x.device)
    arrays = _kernel_levels(spec, coarse_res_cutoff)  # alive through the call
    lib = _build.library()
    rc = lib.nl_hash_encode_ms(
        table.data_ptr(), x.data_ptr(), s.data_ptr(), out.data_ptr(),
        b, n_ms, spec.num_levels, spec.level_dim,
        *(a.ctypes.data for a in arrays), spec.interp == "tetra",
        level_major(spec, _l2_bytes(x.device.index)),
        x.device.index, _build.stream_of(x))
    _build.check(lib, rc, "hash_encode_ms")
    hash_encode_multisample.launches += 1
    return out.reshape(x01.shape[:-2] + (spec.output_dim,))


def _bwd_kernel_inputs(table, x01, stds, g_out, spec: HashGridSpec):
    """`_kernel_inputs` and g_out as a checked [B, L*C] view."""
    table, x, s = _kernel_inputs(table, x01, stds, spec)
    g = g_out.contiguous()
    _build.require_cuda("g_out", g, x01.shape[:-2] + (spec.output_dim,))
    g = _aligned("g_out", g.reshape(s.shape[0], spec.output_dim),
                 min(spec.level_dim, 4))
    return table, x, s, g


def hash_encode_multisample_bwd(table: torch.Tensor, x01: torch.Tensor,
                                stds: torch.Tensor, g_out: torch.Tensor,
                                spec: HashGridSpec, needs=(True, True, True),
                                coarse_res_cutoff: int = 0):
    """Same contract as `hash_encode_multisample_bwd_plain`; CUDA tensors
    launch the H1 backward kernel (`hash_encode_ms_bwd`) or raise. With
    torch's deterministic algorithms on: `hash_encode_multisample_bwd_det`
    (its kernels on CUDA tensors, its plain twin on CPU ones)."""
    if torch.are_deterministic_algorithms_enabled():
        return hash_encode_multisample_bwd_det(
            table, x01, stds, g_out, spec, needs, coarse_res_cutoff)
    if _on_cpu(table, x01, stds, g_out):
        return hash_encode_multisample_bwd_plain(table, x01, stds, g_out,
                                                 spec, needs,
                                                 coarse_res_cutoff)
    table, x, s, g = _bwd_kernel_inputs(table, x01, stds, g_out, spec)
    b, n_ms = s.shape
    outs = [torch.zeros_like(t) if need else None
            for t, need in zip((table, x, s), needs)]
    ptr = lambda t: None if t is None else t.data_ptr()
    arrays = _kernel_levels(spec, coarse_res_cutoff)  # alive through the call
    lib = _build.library()
    rc = lib.nl_hash_encode_ms_bwd(
        table.data_ptr(), x.data_ptr(), s.data_ptr(), g.data_ptr(),
        *(ptr(t) for t in outs), b, n_ms, spec.num_levels, spec.level_dim,
        *(a.ctypes.data for a in arrays), spec.interp == "tetra",
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
    its backward on CUDA tensors, the plain twins on CPU tensors. With
    `spec.diff_inputs` False x01 and stds get no gradient (zero), whatever
    autograd asks: the JAX `_ms_encode_nodiff_bwd`."""

    @staticmethod
    def forward(ctx, table, x01, stds, spec: HashGridSpec,
                coarse_res_cutoff: int):
        ctx.spec = spec
        ctx.cutoff = coarse_res_cutoff
        ctx.save_for_backward(table, x01, stds)
        if _on_cpu(table, x01, stds):
            return hash_encode_multisample_plain(
                table, x01, stds, spec, coarse_res_cutoff)[0]
        return _encode_kernel(table, x01, stds, spec, coarse_res_cutoff)

    @staticmethod
    def backward(ctx, g_out):
        table, x01, stds = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        if not ctx.spec.diff_inputs:
            needs = (needs[0], False, False)
        grads = hash_encode_multisample_bwd(
            table, x01, stds, g_out, ctx.spec, needs, ctx.cutoff)
        return (*grads, None, None)


def hash_encode_multisample(table: torch.Tensor, x01: torch.Tensor,
                            stds: torch.Tensor, spec: HashGridSpec,
                            coarse_res_cutoff: int = 0) -> torch.Tensor:
    """[..., L*C] multisample features (no erf weights), differentiable in
    table, and in x01 and stds unless `spec.diff_inputs` is False; levels
    at or below `coarse_res_cutoff` encode the multisample mean.

    CPU tensors take `hash_encode_multisample_plain` and its written-out
    backward; CUDA tensors launch kernel H1 (`hash_encode_ms`) and, in
    backward, `hash_encode_ms_bwd`; a build or launch failure raises.
    """
    return HashEncodeMS.apply(table, x01, stds, spec, coarse_res_cutoff)


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


@functools.lru_cache(maxsize=8)
def level_rows(spec: HashGridSpec, device=None) -> torch.Tensor:
    """[num_levels, 1] float32 row count of every level (the hash-decay
    loss's denominators), made on the device once per (spec, device): a
    tensor built from the tuple at every step copies from the host and
    waits for the device. Shared: do not modify it."""
    return torch.tensor(spec.rows_per_level, dtype=torch.float32,
                        device=device)[:, None]


def scatter_add_rows_plain(idx: torch.Tensor, vals: torch.Tensor,
                           rows: int) -> torch.Tensor:
    """out[r] = sum of vals[i] over idx[i] == r: idx [N] int32, vals [N, C]
    -> [rows, C]. Indices outside [0, rows) are dropped, as the one-hot of
    the TPU kernel (K3, `experiments/scatter_variants.py`) drops them."""
    ok = (idx >= 0) & (idx < rows)
    out = vals.new_zeros((rows, vals.shape[-1]))
    return out.index_add(0, idx[ok].long(), vals[ok])


def _scatter_inputs(idx: torch.Tensor, vals: torch.Tensor):
    """Checked, contiguous idx [N] int32 and vals [N, C] for K3; raises on
    what the kernels do not take."""
    idx, vals = idx.contiguous(), vals.contiguous()
    n, c = vals.shape
    if c not in _SCATTER_WIDTHS:
        raise NotImplementedError(f"kernel scatter_add_rows takes C in "
                                  f"{_SCATTER_WIDTHS}, not {c}")
    _build.require_cuda("idx", idx, (n,), torch.int32)
    _build.require_cuda("vals", vals, (n, c))
    return _aligned("idx", idx, 4), _aligned("vals", vals, 4)


def _scatter_kernel(idx: torch.Tensor, vals: torch.Tensor,
                    rows: int) -> torch.Tensor:
    """Launch kernel K3 (`scatter_add_rows`)."""
    idx, vals = _scatter_inputs(idx, vals)
    n, c = vals.shape
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
        if torch.are_deterministic_algorithms_enabled():
            return scatter_add_rows_det(idx, vals, rows)
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


# Deterministic sums: fixed-point terms, summed exactly in int64.

_FIXED_BITS = 62


def _abs_bound(v: torch.Tensor) -> torch.Tensor:
    """[...] float64 sums over axis 0 of |v| over its finite entries: the
    bound S of the fixed-point sums of v's terms."""
    return v.abs().nan_to_num(nan=0.0, posinf=0.0).sum(0, dtype=torch.float64)


def fixed_exponents(bound: torch.Tensor) -> torch.Tensor:
    """int32 k = 62 - ceil(log2 S) of every entry of S (float64, >= 0), 0
    where S is 0: terms whose magnitudes sum to at most S, each rounded to
    the nearest integer of term * 2^k, sum to at most 2^62 in int64 (plus
    half a unit a term). The quantum of an entry is 2^-k."""
    mant, exp = torch.frexp(bound)
    ceil_log2 = exp - (mant == 0.5).to(exp.dtype)  # S = 2^e exactly: e
    k = _FIXED_BITS - ceil_log2
    return torch.where(bound > 0, k, torch.zeros_like(k)).to(torch.int32)


def _to_fixed(u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """int64 round(u * 2^k) (ties to even) of the finite entries of u, 0
    elsewhere: u * 2^k is exact in float64, as in float32 in the kernels."""
    u = torch.where(torch.isfinite(u), u, 0.0).to(torch.float64)
    return torch.round(u * torch.exp2(k.to(torch.float64))).to(torch.int64)


class _FixedSums:
    """The plain twin of the kernels' int64 accumulator and non-finite
    flags for a [rows, C] output. Integer sums are exact, so the result
    does not depend on the order of `add`s."""

    def __init__(self, rows: int, c: int, device):
        self.acc = torch.zeros((rows, c), dtype=torch.int64, device=device)
        self.flags = None  # [3, rows, C] counts of NaN, +inf, -inf terms

    def add(self, rows: torch.Tensor, u: torch.Tensor, k: torch.Tensor):
        """Adds the terms u [M, C] (float32) at rows [M], rounded at 2^k
        ([M, C] or broadcast)."""
        self.acc.index_add_(0, rows, _to_fixed(u, k))
        bad = torch.stack([torch.isnan(u), u == float("inf"),
                           u == float("-inf")])
        if bool(bad.any()):
            if self.flags is None:
                self.flags = torch.zeros((3,) + self.acc.shape,
                                         dtype=torch.int64,
                                         device=self.acc.device)
            self.flags.index_add_(1, rows, bad.to(torch.int64))

    def result(self, k_rows: torch.Tensor) -> torch.Tensor:
        """float32 sums: acc * 2^-k (k_rows [rows, C]) through float64, as
        `fixed_to_float` takes it; NaN where a NaN term or both infinities
        were added, else +-inf where one was."""
        out = (self.acc.to(torch.float64)
               * torch.exp2(-k_rows.to(torch.float64))).to(torch.float32)
        if self.flags is not None:
            nan, pos, neg = self.flags > 0
            out = torch.where(neg, float("-inf"), out)
            out = torch.where(pos, float("inf"), out)
            out = torch.where(nan | (pos & neg), float("nan"), out)
        return out


def _cube_weights(spec: HashGridSpec, level: int, pts: torch.Tensor):
    """[N, 8] interpolation weights of points pts [N, 3] (in range) per
    corner c = (c & 1, c >> 1 & 1, c >> 2 & 1) of their cell, as the
    kernels' `add_weights` keeps them: the 8 trilinear weights, or the 4
    simplex weights at their cube corners and 0 at the other 4."""
    corners = _corners(spec, level, pts)
    if spec.interp != "tetra":
        return torch.stack([w for _, w, _ in corners], dim=-1)
    pos = grid_pos(pts, spec.scales[level])
    frac = pos - torch.floor(pos)
    fx, fy, fz = frac.unbind(-1)
    ranks = torch.stack([
        (fy > fx).long() + (fz > fx).long(),
        (fx >= fy).long() + (fz > fy).long(),
        (fx >= fz).long() + (fy >= fz).long()], dim=-1)
    out = []
    for c, offset in enumerate(_CORNERS3):
        k = sum(offset)
        at = ((ranks < k).long() == torch.tensor(offset, device=pts.device)
              ).all(-1)
        out.append(torch.where(at, corners[k][1], 0.0))
    return torch.stack(out, dim=-1)


def _cells(spec: HashGridSpec, level: int, pts: torch.Tensor):
    """[N, 3] int64 cell of points pts [N, 3] at `level`."""
    return torch.floor(grid_pos(pts, spec.scales[level])).to(torch.int64)


def _table_runs(spec: HashGridSpec, x01: torch.Tensor, stds: torch.Tensor,
                coarse_res_cutoff: int):
    """Per level, the merged runs the deterministic backward rounds: a list
    of (level, sample ids [M], cells [M, 3], weights [M, 8]) as the kernel
    `hash_encode_ms_bwd_fixed` forms them. A run is a sample's consecutive
    in-range points in one cell (out-of-range points break none), its
    per-corner weights the sum in point order of erf_w / n times each
    point's corner weights; a mean-point level has one run a sample, the
    mean point's, weighted by the mean erf weight."""
    n = x01.shape[-2]
    x = x01.reshape(-1, n, 3)
    s = stds.reshape(-1, n)
    b = x.shape[0]
    inv_n = float(np.float32(1.0) / np.float32(n))
    out = []
    for l, at_mean in enumerate(mean_levels(spec, coarse_res_cutoff)):
        erf_w = _erf_weight(s, spec.grid_sizes()[l])[0]
        if at_mean:
            pts, oob = _in_range(_seq_mean(x))
            ids = torch.nonzero(~oob)[:, 0]
            w = _seq_mean(erf_w)[ids, None] * _cube_weights(
                spec, l, pts[ids])
            out.append((l, ids, _cells(spec, l, pts[ids]), w))
            continue
        pts, oob = _in_range(x.reshape(-1, 3))
        inside = (~oob).reshape(b, n)
        cells = _cells(spec, l, pts).reshape(b, n, 3)
        weights = _cube_weights(spec, l, pts).reshape(b, n, 8)
        coef = erf_w * inv_n
        have = torch.zeros(b, dtype=torch.bool, device=x.device)
        cur = torch.zeros((b, 3), dtype=torch.int64, device=x.device)
        acc = torch.zeros((b, 8), dtype=x.dtype, device=x.device)

        def emit(mask):
            ids = torch.nonzero(mask)[:, 0]
            if ids.numel():
                out.append((l, ids, cur[ids], acc[ids]))

        for j in range(n):
            ins = inside[:, j]
            ends = ins & have & (cells[:, j] != cur).any(-1)
            emit(ends)
            start = ins & ~(have & ~ends)
            cur = torch.where(start[:, None], cells[:, j], cur)
            acc = torch.where(start[:, None], 0.0, acc)
            have = have | ins
            acc = torch.where(ins[:, None],
                              acc + coef[:, j, None] * weights[:, j], acc)
        emit(have)
    return out


def _table_fixed_plain(x01: torch.Tensor, stds: torch.Tensor,
                       g_out: torch.Tensor, spec: HashGridSpec,
                       coarse_res_cutoff: int) -> torch.Tensor:
    """The deterministic d_table, plain: every merged run's corner value
    (weights x g_out) rounded once at its level's 2^k and summed in
    int64."""
    c, levels = spec.level_dim, spec.num_levels
    g = g_out.reshape(-1, spec.output_dim)
    k = fixed_exponents(_abs_bound(g).reshape(levels, c))
    sums = _FixedSums(spec.total_rows, c, g.device)
    for l, ids, cells, w in _table_runs(spec, x01, stds, coarse_res_cutoff):
        gl = g[ids, l * c:(l + 1) * c]
        for corner, offset in enumerate(_CORNERS3):
            wc = w[:, corner]
            sel = slice(None)
            if spec.interp == "tetra":  # corners no point reaches add none
                sel = torch.nonzero(wc != 0)[:, 0]
            cc = cells[sel] + torch.tensor(offset, device=cells.device)
            rows = spec.offsets[l] + _corner_index(
                spec, l, cc[:, 0], cc[:, 1], cc[:, 2])
            sums.add(rows, wc[sel, None] * gl[sel], k[l])
    return sums.result(k[level_ids(spec, g.device).long()])


def hash_encode_multisample_bwd_det_plain(
        table: torch.Tensor, x01: torch.Tensor, stds: torch.Tensor,
        g_out: torch.Tensor, spec: HashGridSpec, needs=(True, True, True),
        coarse_res_cutoff: int = 0):
    """The plain twin of `hash_encode_multisample_bwd_det`: d_table from
    fixed-point terms summed in int64 (bit-identical under any order of
    the samples), d_x01 / d_stds as `hash_encode_multisample_bwd_plain`
    (sums in a fixed order, no scatter)."""
    _check_ported(spec)
    _, d_x, d_s = hash_encode_multisample_bwd_plain(
        table, x01, stds, g_out, spec, (False, needs[1], needs[2]),
        coarse_res_cutoff)
    d_table = (_table_fixed_plain(x01, stds, g_out, spec, coarse_res_cutoff)
               if needs[0] else None)
    return d_table, d_x, d_s


def table_grad_terms(x01: torch.Tensor, stds: torch.Tensor,
                     g_out: torch.Tensor, spec: HashGridSpec,
                     coarse_res_cutoff: int = 0):
    """(terms [rows, C], counts [rows, 1]), float64: per d_table entry, the
    sum of the magnitudes of its written-out terms, |erf_w / n * corner
    weight * g_out| (a mean-point level: the mean erf weight), with the
    float32 cells and weights of the encode (a tetrahedral weight may
    round to -1 ulp), and the number of those terms; the tolerances of
    the deterministic backward are stated in them."""
    n, c = x01.shape[-2], spec.level_dim
    x = x01.reshape(-1, n, 3)
    s = stds.reshape(-1, n)
    g = g_out.reshape(-1, spec.output_dim).abs().to(torch.float64)
    terms = torch.zeros((spec.total_rows, c), dtype=torch.float64,
                        device=x.device)
    counts = torch.zeros((spec.total_rows, 1), dtype=torch.float64,
                         device=x.device)
    for l, at_mean in enumerate(mean_levels(spec, coarse_res_cutoff)):
        erf_w = _erf_weight(s, spec.grid_sizes()[l])[0]
        gl = g[:, l * c:(l + 1) * c]
        if at_mean:
            pts, oob = _in_range(_seq_mean(x))
            coef = _seq_mean(erf_w)
        else:
            pts, oob = _in_range(x.reshape(-1, 3))
            coef = erf_w.reshape(-1) / n
            gl = gl.repeat_interleave(n, dim=0)
        keep = torch.nonzero(~oob)[:, 0]
        for idx, w, _ in _corners(spec, l, pts[keep]):
            rows = spec.offsets[l] + idx
            terms.index_add_(0, rows, (coef[keep] * w).abs().to(
                torch.float64)[:, None] * gl[keep])
            counts.index_add_(0, rows, torch.ones(
                (len(rows), 1), dtype=torch.float64, device=x.device))
    return terms, counts


def table_grad_quantum(g_out: torch.Tensor,
                       spec: HashGridSpec) -> torch.Tensor:
    """[rows, C] float64 quantum 2^-k of every entry of the deterministic
    d_table for this g_out."""
    k = fixed_exponents(_abs_bound(g_out.reshape(-1, spec.output_dim))
                        .reshape(spec.num_levels, spec.level_dim))
    return torch.exp2(-k[level_ids(spec, g_out.device).long()].to(
        torch.float64))


def _fixed_to_float(lib, acc, flags, k, starts, out) -> None:
    """Launch `fixed_to_float`: out [rows, C] from acc, flags and k ([G, C]
    exponents of the row groups that start at `starts`, G + 1 of them)."""
    starts = np.asarray(starts, np.int64)  # alive through the call
    rc = lib.nl_fixed_to_float(
        acc.data_ptr(), flags.data_ptr(), k.data_ptr(), starts.ctypes.data,
        len(starts) - 1, out.data_ptr(), out.shape[0], out.shape[1],
        out.device.index, _build.stream_of(out))
    _build.check(lib, rc, "fixed_to_float")


def _fixed_buffers(rows: int, c: int, device):
    """Zeroed int64 sums [rows, C] and their flags, 4 bits an entry."""
    return (torch.zeros((rows, c), dtype=torch.int64, device=device),
            torch.zeros(((rows * c + 7) // 8,), dtype=torch.int32,
                        device=device))


def hash_encode_multisample_bwd_det(table: torch.Tensor, x01: torch.Tensor,
                                    stds: torch.Tensor, g_out: torch.Tensor,
                                    spec: HashGridSpec,
                                    needs=(True, True, True),
                                    coarse_res_cutoff: int = 0,
                                    level_major_order=None, threads=128):
    """Same contract as `hash_encode_multisample_bwd_plain`, with sums that
    do not depend on their order: CPU tensors take the plain twin
    (`hash_encode_multisample_bwd_det_plain`); CUDA tensors launch
    `hash_encode_ms_bwd_fixed` then `fixed_to_float` (d_table) and
    `hash_encode_ms_pos_grads` (d_x01 / d_stds), or raise.
    level_major_order (default: `level_major`) and threads (the block
    size, a multiple of 32) change the launch, never the result."""
    if _on_cpu(table, x01, stds, g_out):
        return hash_encode_multisample_bwd_det_plain(
            table, x01, stds, g_out, spec, needs, coarse_res_cutoff)
    table, x, s, g = _bwd_kernel_inputs(table, x01, stds, g_out, spec)
    b, n_ms = s.shape
    c, levels = spec.level_dim, spec.num_levels
    arrays = _kernel_levels(spec, coarse_res_cutoff)  # alive through the call
    lib = _build.library()
    dev, stream = x.device.index, _build.stream_of(x)
    d_table = d_x = d_s = None
    if needs[0]:
        if level_major_order is None:
            level_major_order = level_major(spec, _l2_bytes(dev))
        k = fixed_exponents(_abs_bound(g).reshape(levels, c))
        acc, flags = _fixed_buffers(spec.total_rows, c, x.device)
        rc = lib.nl_hash_encode_ms_bwd_fixed(
            x.data_ptr(), s.data_ptr(), g.data_ptr(), k.data_ptr(),
            acc.data_ptr(), flags.data_ptr(), b, n_ms, levels, c,
            *(a.ctypes.data for a in arrays), spec.interp == "tetra",
            bool(level_major_order), threads, dev, stream)
        _build.check(lib, rc, "hash_encode_ms_bwd_fixed")
        hash_encode_multisample_bwd_det.launches += 1
        d_table = torch.empty_like(table)
        _fixed_to_float(lib, acc, flags, k, spec.offsets, d_table)
    if needs[1] or needs[2]:
        d_x = torch.empty_like(x) if needs[1] else None
        d_s = torch.empty_like(s) if needs[2] else None
        ptr = lambda t: None if t is None else t.data_ptr()
        rc = lib.nl_hash_encode_ms_pos_grads(
            table.data_ptr(), x.data_ptr(), s.data_ptr(), g.data_ptr(),
            ptr(d_x), ptr(d_s), b, n_ms, levels, c,
            *(a.ctypes.data for a in arrays), spec.interp == "tetra", dev,
            stream)
        _build.check(lib, rc, "hash_encode_ms_pos_grads")
        hash_encode_multisample_bwd_det.position_launches += 1
    return (d_table,
            None if d_x is None else d_x.reshape(x01.shape),
            None if d_s is None else d_s.reshape(stds.shape))


hash_encode_multisample_bwd_det.launches = 0
hash_encode_multisample_bwd_det.position_launches = 0


def scatter_add_rows_det_plain(idx: torch.Tensor, vals: torch.Tensor,
                               rows: int) -> torch.Tensor:
    """The plain twin of `scatter_add_rows_det`: every value rounded at its
    channel's 2^k (S = the sum of |vals[:, c]| over the finite values) and
    summed in int64; bit-identical under any order of the rows."""
    k = fixed_exponents(_abs_bound(vals))
    sums = _FixedSums(rows, vals.shape[-1], vals.device)
    ok = (idx >= 0) & (idx < rows)
    sums.add(idx[ok].long(), vals[ok], k)
    return sums.result(k.expand(rows, -1))


def scatter_add_rows_det(idx: torch.Tensor, vals: torch.Tensor,
                         rows: int) -> torch.Tensor:
    """Same contract as `scatter_add_rows_plain` (no gradient), with sums
    that do not depend on their order: CPU tensors take
    `scatter_add_rows_det_plain`; CUDA tensors launch
    `scatter_add_rows_fixed` then `fixed_to_float`, or raise."""
    if _on_cpu(idx, vals):
        return scatter_add_rows_det_plain(idx, vals, rows)
    idx, vals = _scatter_inputs(idx, vals)
    n, c = vals.shape
    k = fixed_exponents(_abs_bound(vals))
    acc, flags = _fixed_buffers(rows, c, vals.device)
    lib = _build.library()
    rc = lib.nl_scatter_add_rows_fixed(
        idx.data_ptr(), vals.data_ptr(), k.data_ptr(), acc.data_ptr(),
        flags.data_ptr(), n, c, rows, vals.device.index,
        _build.stream_of(vals))
    _build.check(lib, rc, "scatter_add_rows_fixed")
    scatter_add_rows_det.launches += 1
    out = torch.empty((rows, c), dtype=torch.float32, device=vals.device)
    _fixed_to_float(lib, acc, flags, k.reshape(1, c), (0, rows), out)
    return out


scatter_add_rows_det.launches = 0


def _scatter_rows_det_any(idx: torch.Tensor, g: torch.Tensor,
                          rows: int) -> torch.Tensor:
    """scatter_add_rows_det at any width F of g [N, F]: column blocks of up
    to 32, each padded with zeros to a width K3 takes."""
    idx = idx.to(torch.int32)
    g32 = g.to(torch.float32)
    outs = []
    for c0 in range(0, g.shape[1], 32):
        part = g32[:, c0:c0 + 32]
        f = part.shape[1]
        width = next(w for w in _SCATTER_WIDTHS if w >= f)
        if width != f:
            part = torch.cat([part, part.new_zeros(part.shape[0],
                                                   width - f)], dim=1)
        outs.append(scatter_add_rows_det(idx, part.contiguous(), rows)[:, :f])
    return torch.cat(outs, dim=1).to(g.dtype)


class _SelectRowsDet(torch.autograd.Function):
    """src.index_select(0, idx), its backward summed by K3's deterministic
    variant."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.shape = src.shape
        return src.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        rows = ctx.shape[0]
        g2 = g.reshape(g.shape[0], -1)
        return _scatter_rows_det_any(idx, g2, rows).reshape(ctx.shape), None


def select_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`src.index_select(0, idx)`. With torch's deterministic algorithms on
    and a src that takes a gradient, the backward (a row scatter-add of the
    gradient) goes through `scatter_add_rows_det`: torch's deterministic
    `index_add_` sorts the indices and adds each row's duplicates in turn,
    which took ~90 ms a call on the object path's selects (a sample budget
    of indices onto one latent row)."""
    if torch.are_deterministic_algorithms_enabled() and src.requires_grad:
        return _SelectRowsDet.apply(src, idx)
    return src.index_select(0, idx)
