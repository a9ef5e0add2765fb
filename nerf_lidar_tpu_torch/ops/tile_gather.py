"""In-tile gathers (port of the Pallas gathers of
`nerf_lidar_tpu/ops/grid_pallas.py` and `experiments/gather_bench.py`).

- `take_along_axis(tbl, idx, axis)`: `out[..., i, j] = tbl[i, idx[..., i, j]]`
  (axis 1) or `tbl[idx[..., i, j], j]` (axis 0) for a table [A, B] and an
  index [I, J] or [G, I, J], whose leading grid dimension shares one table:
  K4's forms 2, 4 and 5 (the bench's `probe_mosaic_gather`);
- `take_rows(tbl, idx)`: K4's form 3, `out[n] = tbl[idx[n]]`;
- `tile_lane_gather(tbl, idx)`: K2, `take_along_axis` on axis 1 of one
  [8, 128] tile (`grid_pallas.tile_lane_gather`, and K4's form 1);
- `tile_grid_gather(tbl, idx)`: K5 (`bench_pallas_tile_gather`), K2 over a
  grid of index tiles: tbl [8, 128], idx [G, 8, 128].

Index rules are JAX's, which the Pallas kernels follow: an index i with
-size <= i < 0 wraps once to i + size; any other index outside [0, size)
gives NaN.

Each function has a plain version (`*_plain`) that CPU tensors take; CUDA
tensors launch the kernels of `csrc/gather.cu` (`take_along_axis`,
`take_rows`) or raise. Each public wrapper counts its own launches, so
that a run shows which TPU kernel's counterpart it went through.
"""

from __future__ import annotations

import torch

from . import _build

TILE = (8, 128)
_INT32_MAX = 2**31 - 1


def _wrap(idx: torch.Tensor, size: int):
    """(int64 index in [0, size), mask of the indices that give a value)."""
    ok = (idx >= -size) & (idx < size)
    safe = torch.where(idx < 0, idx + size, idx)
    return torch.where(ok, safe, 0).long(), ok


def _check_along_axis(tbl: torch.Tensor, idx: torch.Tensor, axis: int):
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, not {axis}")
    if tbl.dim() != 2 or idx.dim() not in (2, 3):
        raise ValueError(f"expected tbl [A, B] and idx [I, J] or [G, I, J], "
                         f"got {tuple(tbl.shape)} and {tuple(idx.shape)}")
    other = 1 - axis
    if idx.shape[idx.dim() - 2 + other] != tbl.shape[other]:
        raise ValueError(f"idx {tuple(idx.shape)} and tbl {tuple(tbl.shape)} "
                         f"differ outside axis {axis}")


def take_along_axis_plain(tbl: torch.Tensor, idx: torch.Tensor,
                          axis: int) -> torch.Tensor:
    """`jnp.take_along_axis(tbl, idx, axis)` for tbl [A, B] and idx [I, J]
    or [G, I, J], with JAX's index rules."""
    _check_along_axis(tbl, idx, axis)
    safe, ok = _wrap(idx, tbl.shape[axis])
    src = tbl if idx.dim() == 2 else tbl[None]
    out = torch.take_along_dim(src, safe, dim=axis - 2)
    return torch.where(ok, out, torch.nan)


def _check_rows(tbl: torch.Tensor, idx: torch.Tensor):
    if tbl.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"expected tbl [R, C] and idx [N], got "
                         f"{tuple(tbl.shape)} and {tuple(idx.shape)}")


def take_rows_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`jnp.take(tbl, idx, axis=0)` for tbl [R, C] and idx [N], with JAX's
    index rules."""
    _check_rows(tbl, idx)
    safe, ok = _wrap(idx, tbl.shape[0])
    return torch.where(ok[:, None], tbl.index_select(0, safe), torch.nan)


def _check_tile(tbl: torch.Tensor, idx: torch.Tensor, grid: bool):
    """K2 takes one [8, 128] index tile, K5 a grid of them [G, 8, 128]."""
    tiles = idx.dim() == 3 and tuple(idx.shape[1:]) == TILE
    if tuple(tbl.shape) != TILE or not (
            tiles if grid else tuple(idx.shape) == TILE):
        want = "[G, 8, 128]" if grid else "[8, 128]"
        raise ValueError(f"expected tbl [8, 128] and idx {want}, got "
                         f"{tuple(tbl.shape)} and {tuple(idx.shape)}")


def tile_lane_gather_plain(tbl: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """K2's plain version: `take_along_axis_plain(tbl, idx, 1)` on one
    [8, 128] tile."""
    _check_tile(tbl, idx, grid=False)
    return take_along_axis_plain(tbl, idx, 1)


def tile_grid_gather_plain(tbl: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """K5's plain version: `take_along_axis_plain(tbl, idx, 1)` for tbl
    [8, 128] and idx [G, 8, 128]."""
    _check_tile(tbl, idx, grid=True)
    return take_along_axis_plain(tbl, idx, 1)


def _along_axis_kernel(tbl: torch.Tensor, idx: torch.Tensor,
                       axis: int) -> torch.Tensor:
    """Launch kernel `take_along_axis` (csrc/gather.cu)."""
    _check_along_axis(tbl, idx, axis)
    tbl, idx = tbl.contiguous(), idx.contiguous()
    a, b = tbl.shape
    g = idx.shape[0] if idx.dim() == 3 else 1
    i, j = idx.shape[-2:]
    _build.require_cuda("tbl", tbl, (a, b))
    _build.require_cuda("idx", idx, tuple(idx.shape), torch.int32)
    if max(idx.numel(), a * b) > _INT32_MAX:
        raise ValueError(f"take_along_axis: the index and the table must "
                         f"hold at most 2^31 - 1 elements (the kernel's "
                         f"index math), got {idx.numel()} and {a * b}")
    out = torch.empty(idx.shape, dtype=torch.float32, device=tbl.device)
    lib = _build.library()
    rc = lib.nl_take_along_axis(tbl.data_ptr(), idx.data_ptr(),
                                out.data_ptr(), a, b, g, i, j, axis,
                                tbl.device.index, _build.stream_of(tbl))
    _build.check(lib, rc, "take_along_axis")
    return out


def tile_lane_gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K2: out[i, j] = tbl[i, idx[i, j]] for tbl [8, 128] float32 and idx
    [8, 128] int32. CUDA tensors launch kernel `take_along_axis`."""
    if tbl.device.type == "cpu" and idx.device.type == "cpu":
        return tile_lane_gather_plain(tbl, idx)
    _check_tile(tbl, idx, grid=False)
    out = _along_axis_kernel(tbl, idx, 1)
    tile_lane_gather.launches += 1
    return out


tile_lane_gather.launches = 0


def tile_grid_gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5: out[g, i, j] = tbl[i, idx[g, i, j]] for tbl [8, 128] float32 and
    idx [G, 8, 128] int32. CUDA tensors launch kernel `take_along_axis`."""
    if tbl.device.type == "cpu" and idx.device.type == "cpu":
        return tile_grid_gather_plain(tbl, idx)
    _check_tile(tbl, idx, grid=True)
    out = _along_axis_kernel(tbl, idx, 1)
    tile_grid_gather.launches += 1
    return out


tile_grid_gather.launches = 0


def take_along_axis(tbl: torch.Tensor, idx: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """Same contract as `take_along_axis_plain` (tbl float32, idx int32);
    CUDA tensors launch kernel `take_along_axis`."""
    if tbl.device.type == "cpu" and idx.device.type == "cpu":
        return take_along_axis_plain(tbl, idx, axis)
    out = _along_axis_kernel(tbl, idx, axis)
    take_along_axis.launches += 1
    return out


take_along_axis.launches = 0


def take_rows(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Same contract as `take_rows_plain` (tbl float32, idx int32, N * C
    and R * C at most 2^31 - 1 on CUDA); CUDA tensors launch kernel
    `take_rows`."""
    if tbl.device.type == "cpu" and idx.device.type == "cpu":
        return take_rows_plain(tbl, idx)
    _check_rows(tbl, idx)
    tbl, idx = tbl.contiguous(), idx.contiguous()
    r, c = tbl.shape
    n = idx.shape[0]
    _build.require_cuda("tbl", tbl, (r, c))
    _build.require_cuda("idx", idx, (n,), torch.int32)
    if max(n, r) * c > _INT32_MAX:
        raise ValueError(f"take_rows: N * C and R * C must fit in int32 "
                         f"(the kernel's index math), got N={n} R={r} C={c}")
    out = torch.empty((n, c), dtype=torch.float32, device=tbl.device)
    lib = _build.library()
    rc = lib.nl_take_rows(tbl.data_ptr(), idx.data_ptr(), out.data_ptr(),
                          r, c, n, tbl.device.index, _build.stream_of(tbl))
    _build.check(lib, rc, "take_rows")
    take_rows.launches += 1
    return out


take_rows.launches = 0


def same_values(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Exact equality, NaN where NaN: the test a gather passes."""
    nan = want.isnan()
    return (got.shape == want.shape and torch.equal(got.isnan(), nan)
            and torch.equal(torch.where(nan, 0.0, got),
                            torch.where(nan, 0.0, want)))
