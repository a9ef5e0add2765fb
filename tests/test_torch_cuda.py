"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc: it carries the `cuda` marker
and skips without a card. This file imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: as tests/test_torch_render_fused.py for K1; features rtol 1e-5
/ atol 1e-6 for H1 (the kernels change only the order of float sums); the
H1 backward and K3 sum with atomics, in an order that changes from run to
run: gradients and scatter sums rtol 1e-4 / atol 1e-5 of the largest value.
The in-tile gathers copy values: exactly equal, NaN positions included.
"""

import pytest
import torch

from nerf_lidar_tpu_torch import configs
from nerf_lidar_tpu_torch.ops import grid, render_fused, tile_gather

pytestmark = pytest.mark.cuda

TOL = dict(weights=(1e-5, 1e-6), depth=(1e-4, 1e-5), acc=(1e-5, 1e-6),
           rgb=(1e-5, 1e-5), semantic=(1e-5, 1e-5), intensity=(1e-5, 1e-5))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda", 0)


def _composite_args(dev, r, s, k, with_int, opaque, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.rand(*shape, device=dev, generator=g)
    return dict(
        density=rand(r, s) * 3,
        tdist=torch.sort(rand(r, s + 1) * 5, dim=-1).values,
        dirs=torch.randn(r, 3, device=dev, generator=g),
        rgb=rand(r, s, 3), semantic=rand(r, s, k) if k else None,
        intensity=rand(r, s) if with_int else None,
        opaque_background=opaque, bg_value=0.5)


@pytest.mark.parametrize("r,s,k,with_int,opaque", [
    (1, 32, 19, True, True), (513, 32, 19, False, True),
    (700, 16, 5, True, False), (300, 64, 0, False, True)])
def test_composite_kernel_matches_plain(dev, r, s, k, with_int, opaque):
    args = _composite_args(dev, r, s, k, with_int, opaque)
    before = render_fused.fused_composite.launches
    got = render_fused.fused_composite(**args)
    assert render_fused.fused_composite.launches == before + 1
    want = render_fused.fused_composite_plain(**args)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for key, (rtol, atol) in TOL.items():
        if key in want:
            torch.testing.assert_close(got[key], want[key], rtol=rtol,
                                       atol=atol, msg=key)


def test_composite_kernel_takes_strided_inputs(dev):
    args = _composite_args(dev, 64, 8, 3, True, True)
    strided = dict(args, rgb=args["rgb"].transpose(0, 1).contiguous()
                   .transpose(0, 1))
    assert not strided["rgb"].is_contiguous()
    got = render_fused.fused_composite(**strided)
    want = render_fused.fused_composite(**args)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


@pytest.mark.parametrize("level_dim", [1, 2, 4])
def test_hash_encode_kernel_matches_plain(dev, level_dim):
    spec = grid.spec_for(configs.GridConfig(
        level_dim=level_dim, base_resolution=4, desired_resolution=96,
        log2_hashmap_size=9))
    g = torch.Generator(device=dev).manual_seed(level_dim)
    table = torch.rand(spec.total_rows, level_dim, device=dev,
                       generator=g) * 2 - 1
    x01 = torch.rand(3, 50, 7, 3, device=dev, generator=g) * 1.2 - 0.1
    stds = torch.rand(3, 50, 7, device=dev, generator=g) * 0.05 + 1e-4
    before = grid.hash_encode_multisample.launches
    got = grid.hash_encode_multisample(table, x01, stds, spec)
    assert grid.hash_encode_multisample.launches == before + 1
    want = grid.hash_encode_multisample_plain(table, x01, stds, spec)[0]
    torch.cuda.synchronize()
    assert got.shape == (3, 50, spec.output_dim)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _close_to_max(got, want, name):
    scale = float(want.abs().max())
    assert scale > 0, name
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale,
                               msg=name)


@pytest.mark.parametrize("level_dim", [1, 2, 4])
def test_hash_encode_bwd_kernel_matches_plain(dev, level_dim):
    spec = grid.spec_for(configs.GridConfig(
        level_dim=level_dim, base_resolution=4, desired_resolution=96,
        log2_hashmap_size=9))
    g = torch.Generator(device=dev).manual_seed(10 + level_dim)
    table = torch.rand(spec.total_rows, level_dim, device=dev,
                       generator=g) * 2 - 1
    x01 = torch.rand(3, 50, 7, 3, device=dev, generator=g) * 1.2 - 0.1
    stds = torch.rand(3, 50, 7, device=dev, generator=g) * 0.05 + 1e-4
    g_out = torch.randn(3, 50, spec.output_dim, device=dev, generator=g)
    grads = {}
    for name, encode in (
            ("kernel", grid.hash_encode_multisample),
            ("plain", lambda *a: grid.hash_encode_multisample_plain(*a)[0])):
        leaves = [t.clone().requires_grad_(True) for t in (table, x01, stds)]
        out = encode(*leaves, spec)
        assert out.grad_fn is not None
        before = grid.hash_encode_multisample_bwd.launches
        out.backward(g_out)
        launched = grid.hash_encode_multisample_bwd.launches - before
        assert launched == (1 if name == "kernel" else 0)
        grads[name] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    written = grid.hash_encode_multisample_bwd_plain(table, x01, stds, g_out,
                                                     spec)
    for i, name in enumerate(("table", "x01", "stds")):
        _close_to_max(grads["kernel"][i], grads["plain"][i], name)
        _close_to_max(written[i], grads["plain"][i], f"bwd_plain {name}")


def test_hash_encode_bwd_kernel_table_only(dev):
    """The train path: positions need no gradient, so the kernel writes
    d_table alone."""
    spec = grid.spec_for(configs.tiny_debug().model.nerf_mlp.grid)
    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                       generator=g).requires_grad_(True)
    x01 = torch.rand(64, 3, 3, device=dev, generator=g)
    stds = torch.rand(64, 3, device=dev, generator=g) * 0.01
    grid.hash_encode_multisample(table, x01, stds, spec).square().sum() \
        .backward()
    want = torch.autograd.grad(
        grid.hash_encode_multisample_plain(table, x01, stds, spec)[0]
        .square().sum(), table)[0]
    _close_to_max(table.grad, want, "table")


@pytest.mark.parametrize("rows,n,c", [(4096, 1 << 16, 16), (1 << 17, 5000, 1),
                                      (10, 100_000, 4), (7, 3, 2),
                                      (3, 100_003, 32)])
def test_scatter_add_rows_kernel_matches_index_add(dev, rows, n, c):
    g = torch.Generator(device=dev).manual_seed(rows)
    idx = torch.randint(-2, rows + 2, (n,), device=dev, generator=g,
                        dtype=torch.int32)
    vals = torch.randn(n, c, device=dev, generator=g, requires_grad=True)
    before = grid.scatter_add_rows.launches
    got = grid.scatter_add_rows(idx, vals, rows)
    assert grid.scatter_add_rows.launches == before + 1
    want = grid.scatter_add_rows_plain(idx, vals.detach(), rows)
    torch.cuda.synchronize()
    _close_to_max(got.detach(), want, "sum")
    g_out = torch.randn(rows, c, device=dev, generator=g)
    got.backward(g_out)
    ok = (idx >= 0) & (idx < rows)
    want_grad = torch.where(ok[:, None], g_out[idx.clamp(0, rows - 1).long()],
                            0.0)
    torch.testing.assert_close(vals.grad, want_grad, rtol=0, atol=0)


def test_kernel_wrappers_reject_what_they_do_not_take(dev):
    spec = grid.spec_for(configs.tiny_debug().model.nerf_mlp.grid)
    table = torch.zeros(spec.total_rows, spec.level_dim, device=dev)
    x01 = torch.rand(4, 3, 3, device=dev)
    stds = torch.rand(4, 3, device=dev)
    with pytest.raises(ValueError, match="float32"):
        grid.hash_encode_multisample(table.double(), x01, stds, spec)
    with pytest.raises(ValueError, match="shape"):
        grid.hash_encode_multisample(table[:-8], x01, stds, spec)
    wide = grid.spec_for(configs.GridConfig(level_dim=8, base_resolution=4,
                                            desired_resolution=96,
                                            log2_hashmap_size=9))
    with pytest.raises(NotImplementedError, match="level_dim"):
        grid.hash_encode_multisample(
            torch.zeros(wide.total_rows, 8, device=dev), x01, stds, wide)
    args = _composite_args(dev, 8, 4, 2, False, True)
    with pytest.raises(ValueError, match="shape"):
        render_fused.fused_composite(**dict(args, tdist=args["tdist"][:, 1:]))
    with pytest.raises(ValueError, match="CUDA"):
        render_fused.fused_composite(**dict(args, dirs=args["dirs"].cpu()))

    # The H1 backward.
    g_out = torch.rand(4, spec.output_dim, device=dev)
    with pytest.raises(ValueError, match="g_out"):
        grid.hash_encode_multisample_bwd(table, x01, stds, g_out[:, 1:], spec)
    with pytest.raises(ValueError, match="float32"):
        grid.hash_encode_multisample_bwd(table, x01, stds, g_out.double(),
                                         spec)
    with pytest.raises(ValueError, match="CUDA"):
        grid.hash_encode_multisample_bwd(table, x01.cpu(), stds, g_out, spec)
    with pytest.raises(NotImplementedError, match="level_dim"):
        grid.hash_encode_multisample_bwd(
            torch.zeros(wide.total_rows, 8, device=dev), x01, stds,
            torch.rand(4, wide.output_dim, device=dev), wide)

    # K3.
    idx = torch.zeros(5, dtype=torch.int32, device=dev)
    vals = torch.rand(5, 16, device=dev)
    with pytest.raises(ValueError, match="int32"):
        grid.scatter_add_rows(idx.long(), vals, 8)
    with pytest.raises(ValueError, match="float32"):
        grid.scatter_add_rows(idx, vals.double(), 8)
    with pytest.raises(ValueError, match="CUDA"):
        grid.scatter_add_rows(idx, vals.cpu(), 8)
    with pytest.raises(ValueError, match="idx"):
        grid.scatter_add_rows(idx[:4], vals, 8)
    with pytest.raises(NotImplementedError, match="C in"):
        grid.scatter_add_rows(idx, vals[:, :3], 8)


def test_scatter_add_rows_kernel_sums_sorted_segments(dev):
    """The hash-decay use: every row of a level onto one output row, in
    sorted runs far longer than a warp's share."""
    spec = grid.spec_for(configs.tiny_debug().model.nerf_mlp.grid)
    g = torch.Generator(device=dev).manual_seed(4)
    table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                       generator=g) * 2 - 1
    ids = grid.level_ids(spec, dev)
    got = grid.scatter_add_rows(ids, table**2, spec.num_levels)
    want = grid.scatter_add_rows_plain(ids, table**2, spec.num_levels)
    torch.cuda.synchronize()
    _close_to_max(got, want, "level sums")


def _gather_indices(dev, shape, size, seed):
    """Indices in [-2 size, 2 size) (wrapped, in range and NaN cases) with
    the int32 extremes, -size, size and -1 in the first cells."""
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(-2 * size, 2 * size, shape, device=dev, generator=g,
                        dtype=torch.int32)
    idx.view(-1)[:5] = torch.tensor([-2**31, 2**31 - 1, -size, size, -1],
                                    dtype=torch.int32)
    return idx


@pytest.mark.parametrize("tbl_shape,idx_shape,axis", [
    ((8, 128), (8, 128), 1), ((256, 128), (256, 128), 1),
    ((128, 128), (128, 128), 0), ((8, 2**15), (8, 128), 1),
    ((8, 128), (1024, 8, 128), 1), ((96, 3), (5, 7, 3), 0),
    ((3, 20_000), (2, 3, 5), 1)])
def test_take_along_axis_kernel_matches_plain(dev, tbl_shape, idx_shape,
                                              axis):
    g = torch.Generator(device=dev).manual_seed(len(idx_shape))
    tbl = torch.randn(*tbl_shape, device=dev, generator=g)
    idx = _gather_indices(dev, idx_shape, tbl_shape[axis], 1)
    before = tile_gather.take_along_axis.launches
    got = tile_gather.take_along_axis(tbl, idx, axis)
    assert tile_gather.take_along_axis.launches == before + 1
    want = tile_gather.take_along_axis_plain(tbl, idx, axis)
    torch.cuda.synchronize()
    assert tile_gather.same_values(got, want)
    assert 0 < float(want.isnan().float().mean()) < 1


@pytest.mark.parametrize("name,idx_shape", [
    ("tile_lane_gather", (8, 128)), ("tile_grid_gather", (1024, 8, 128)),
    ("tile_grid_gather", (3, 8, 128))])
def test_tile_gather_kernels_match_plain(dev, name, idx_shape):
    """K2 and K5 on in-range and on out-of-range indices."""
    fn = getattr(tile_gather, name)
    plain = getattr(tile_gather, name + "_plain")
    tbl = torch.randn(8, 128, device=dev)
    for seed in (0, 1):
        idx = (_gather_indices(dev, idx_shape, 128, seed) if seed else
               torch.randint(0, 128, idx_shape, device=dev,
                             dtype=torch.int32))
        before = fn.launches
        got = fn(tbl, idx)
        assert fn.launches == before + 1
        assert tile_gather.same_values(got, plain(tbl, idx))


@pytest.mark.parametrize("r,c,n", [(512, 128, 256), (7, 1, 1000),
                                   (100_000, 16, 4096)])
def test_take_rows_kernel_matches_plain(dev, r, c, n):
    tbl = torch.randn(r, c, device=dev)
    idx = _gather_indices(dev, (n,), r, r)
    before = tile_gather.take_rows.launches
    got = tile_gather.take_rows(tbl, idx)
    assert tile_gather.take_rows.launches == before + 1
    assert tile_gather.same_values(got, tile_gather.take_rows_plain(tbl, idx))


def test_gather_wrappers_reject_what_they_do_not_take(dev):
    tbl = torch.randn(8, 128, device=dev)
    idx = torch.zeros(8, 128, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        tile_gather.take_along_axis(tbl, idx.long(), 1)
    with pytest.raises(ValueError, match="float32"):
        tile_gather.take_rows(tbl.double(), idx[0])
    with pytest.raises(ValueError, match="CUDA"):
        tile_gather.tile_lane_gather(tbl, idx.cpu())
