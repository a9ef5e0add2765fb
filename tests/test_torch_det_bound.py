"""The bound S of the deterministic sums and the twins given an exponent.

Kernel `abs_bound` (`grid.bound_exponents` on CUDA tensors) sums |v| over
the finite entries of each column in a fixed order (`grid._bound_plan`),
which its plain version `grid.abs_bound_plain` takes too; the CPU twins of
the deterministic kernels keep `grid._abs_bound` (torch's sum). Here, on
the CPU: the plain S against `_abs_bound` (float64 rounding, rtol 1e-12),
the exponents k of both equal on seeded data, with NaN and +-inf and with S
exactly a power of two, and the plain twins given an explicit k: the same
bits under any order of their rows or samples, and what they give by
default at the default k. The card holds the kernel to `abs_bound_plain`
bit for bit (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from nerf_lidar_tpu_torch import configs
from nerf_lidar_tpu_torch.ops import grid


def _seeded(seed, n, f, specials=True):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((n, f)) * rng.uniform(1e-6, 1e3)).astype(
        np.float32)
    if specials and n > 9:
        v[3, 0], v[5, f - 1], v[9, 0] = np.nan, np.inf, -np.inf
    return torch.from_numpy(v)


@pytest.mark.parametrize("n,f", [(0, 4), (1, 1), (7, 3), (1000, 4),
                                 (70_001, 3), (3000, 300), (12_345, 40)])
def test_plain_bound_against_torch_sum(n, f):
    """abs_bound_plain within float64 rounding of _abs_bound, NaN and
    +-inf skipped, and the same exponents; bound_exponents on the CPU is
    the plain S and its exponents."""
    v = _seeded(n + f, n, f)
    got, want = grid.abs_bound_plain(v), grid._abs_bound(v)
    assert got.dtype == torch.float64 and got.shape == (f,)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(grid.fixed_exponents(got), grid.fixed_exponents(want))
    s, k = grid.bound_exponents(v)
    assert torch.equal(s, got) and torch.equal(k, grid.fixed_exponents(got))


@pytest.mark.parametrize("f", [1, 2, 4, 6, 8, 40, 257])
def test_plain_bound_at_the_path_widths(f):
    """abs_bound_plain at every vector width of the plan (one value or four
    channels a load), N not a multiple of its chunk nor of Q, NaN and
    +-inf in the first and last columns: within float64 rounding of
    _abs_bound, the same exponents, and the non-finite entries skipped."""
    n = 33_331
    _, q, p, chunk = grid._bound_plan(n, f)
    assert n % chunk and (q == 1 or (n % chunk) % q)
    v = _seeded(f, n, f)
    v[n - 1, 0], v[n // 2, f - 1] = float("-inf"), float("nan")
    got = grid.abs_bound_plain(v)
    want = grid._abs_bound(v)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    assert torch.equal(grid.fixed_exponents(got), grid.fixed_exponents(want))
    finite = v.clone()
    finite[~torch.isfinite(finite)] = 0.0
    torch.testing.assert_close(got, finite.abs().double().sum(0),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed", range(6))
def test_exponents_equal_torch_on_seeded_data(seed):
    """k of the kernel's order equals fixed_exponents(_abs_bound(v)) on
    seeded data of the train path's shapes (cut to tiny_debug): a g_out of
    L x C columns and a hash table squared, with NaN and +-inf."""
    spec = grid.spec_for(configs.tiny_debug().model.nerf_mlp.grid)
    for v in (_seeded(seed, 4096, spec.output_dim),
              _seeded(seed + 50, spec.total_rows, spec.level_dim) ** 2):
        assert torch.equal(grid.bound_exponents(v)[1],
                           grid.fixed_exponents(grid._abs_bound(v)))


@pytest.mark.parametrize("n,f", [(16, 4), (4096, 40), (65_536, 1)])
def test_exponents_at_a_power_of_two(n, f):
    """S exactly 2^e (values 2^-j summing to a power of two, NaN and inf
    beside them): both sums give it exactly, and k = 62 - e."""
    v = torch.full((n, f), 0.25)
    e = int(np.log2(n * 0.25))
    assert n * 0.25 == 2.0**e
    v = torch.cat([v, torch.tensor([[float("nan")] * f, [float("inf")] * f,
                                    [float("-inf")] * f])])
    for s in (grid.abs_bound_plain(v), grid._abs_bound(v)):
        assert s.tolist() == [2.0**e] * f
        assert grid.fixed_exponents(s).tolist() == [62 - e] * f


def test_plan_depends_on_the_shape_alone():
    """The plan (V, Q, P, chunk): 16-byte vectors of 4 channels where F %
    4 == 0, Q threads a vector (a power of two; 1 above 256 vectors a
    row), at most 256 vectors a block's row and 256 blocks covering every
    row."""
    for n, f in ((0, 4), (1, 1), (655_360, 40), (14_995_560, 4),
                 (1 << 22, 16), (5000, 300), (5000, 1100), (1000, 6)):
        v, q, p, chunk = grid._bound_plan(n, f)
        w = f // v
        assert v == (4 if f % 4 == 0 else 1)
        assert q & (q - 1) == 0 and 1 <= p <= 256 and p * chunk >= n
        assert q == 1 if w > 256 else q * w <= 256 < 2 * q * w


def _k3_case(seed, c):
    rng = np.random.default_rng(seed)
    n, rows = 5000, 37
    idx = rng.integers(-2, rows + 2, n).astype(np.int32)
    vals = rng.standard_normal((n, c)).astype(np.float32)
    vals[11, 0], vals[12, c - 1] = np.nan, -np.inf
    idx[11], idx[12] = 3, 4
    return torch.from_numpy(idx), torch.from_numpy(vals), rows


@pytest.mark.parametrize("c", [1, 4, 16])
def test_scatter_twin_at_a_given_exponent(c):
    """scatter_add_rows_det_plain given k: the same bits under permutation
    of its rows; at the default k what it gives without one; at another k
    (3 bits coarser) the sums move by at most half its quantum a term."""
    idx, vals, rows = _k3_case(c, c)
    k0 = grid.fixed_exponents(grid._abs_bound(vals))
    default = grid.scatter_add_rows_det_plain(idx, vals, rows)
    torch.testing.assert_close(
        grid.scatter_add_rows_det_plain(idx, vals, rows, k0), default,
        rtol=0, atol=0, equal_nan=True)
    k = k0 - 3
    got = grid.scatter_add_rows_det_plain(idx, vals, rows, k)
    perm = torch.from_numpy(np.random.default_rng(c + 1).permutation(
        len(idx)))
    torch.testing.assert_close(
        grid.scatter_add_rows_det_plain(idx[perm], vals[perm], rows, k), got,
        rtol=0, atol=0, equal_nan=True)
    ok = (idx >= 0) & (idx < rows)
    counts = torch.zeros(rows, 1, dtype=torch.float64).index_add_(
        0, idx[ok].long(), torch.ones(int(ok.sum()), 1, dtype=torch.float64))
    fin = torch.isfinite(default) & torch.isfinite(got)
    diff = (got.double() - default.double()).abs()
    allowed = (0.5 * torch.exp2(-k.double()) + 0.5 * torch.exp2(-k0.double())
               ) * counts + 1e-6 * default.double().abs()
    assert bool((diff[fin] <= allowed.expand_as(diff)[fin]).all())
    assert torch.equal(torch.isnan(got), torch.isnan(default))


def test_table_twin_at_a_given_exponent():
    """hash_encode_multisample_bwd_det_plain given k ([L, C]): the same bits
    under permutation of the samples, what it gives by default at the
    default k, and another k changes its bits."""
    spec = grid.spec_for(configs.tiny_debug().model.nerf_mlp.grid)
    rng = np.random.default_rng(5)
    b, n = 512, 4
    x01 = torch.from_numpy(
        (rng.random((b, 1, 3)) * 0.8 + 0.1
         + (rng.random((b, n, 3)) - 0.5) * 0.02).astype(np.float32))
    stds = torch.from_numpy((rng.random((b, n)) * 0.01 + 1e-4)
                            .astype(np.float32))
    g_out = torch.from_numpy(rng.standard_normal((b, spec.output_dim))
                             .astype(np.float32))
    table = torch.zeros(spec.total_rows, spec.level_dim)
    only = (True, False, False)
    k0 = grid.fixed_exponents(grid._abs_bound(g_out)).reshape(
        spec.num_levels, spec.level_dim)
    default = grid.hash_encode_multisample_bwd_det_plain(
        table, x01, stds, g_out, spec, only)[0]
    assert torch.equal(grid.hash_encode_multisample_bwd_det_plain(
        table, x01, stds, g_out, spec, only, k=k0)[0], default)
    k = k0 - 40
    got = grid.hash_encode_multisample_bwd_det_plain(
        table, x01, stds, g_out, spec, only, k=k)[0]
    perm = torch.from_numpy(rng.permutation(b))
    assert torch.equal(grid.hash_encode_multisample_bwd_det_plain(
        table, x01[perm], stds[perm], g_out[perm], spec, only, k=k)[0], got)
    assert not torch.equal(got, default)
    torch.testing.assert_close(got, default, rtol=0, atol=float(
        torch.exp2(-k.double()).max()) * b * n * 8)
