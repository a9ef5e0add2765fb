"""The hash encode's position gradients from forward residuals, on the CPU.

Where x01 or stds take a gradient, the encode keeps R [L, n, 4, B, C] (the
terms d_x01 / d_stds contract with g_out; `hash_encode_ms_residuals_plain`,
the plain twin of kernel H1's residual mode) and the backward contracts it
(`pos_grads_from_residuals_plain`, the twin of `hash_encode_ms_pos_grads`),
in both modes. Here:
- the plain residuals and contraction against `jax.vjp` of the JAX
  `hash_encode_multisample` in x01 and stds, on test_torch_grid.py's
  points (ties, faces, clusters, out-of-range points and means): trilinear
  C1 / C2 / C4, tetrahedral C2 (the spectral object grid), mean-point
  levels, n = 1 at stds 0 (the object grid's encode), and the kernels'
  general widths C3 / C6 / C12 in both interpolations;
- the CPU autograd path's d_x01 / d_stds the same bits with torch's
  deterministic switch on and off;
- no residuals where x01 and stds take no gradient (render, eval, the
  static train step), counted on the wrapper; one residual call for a
  direct caller of the backward that passes none.

Tolerance: rtol 1e-4 / atol 1e-5 of the largest value, as
tests/test_torch_grid_bwd.py holds the gradients (float32 sums in another
order than JAX's autodiff).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu.ops import grid as jgrid
from nerf_lidar_tpu_torch.ops import grid

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_grid import mode_inputs, mode_specs  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5

# (interp, coarse cutoff, C, points a sample, stds 0)
CASES = [("linear", 0, 1, 5, False), ("linear", 0, 2, 5, False),
         ("linear", 0, 4, 5, False), ("tetra", 0, 2, 5, False),
         ("linear", 20, 4, 5, False), ("tetra", 20, 2, 5, False),
         ("linear", 0, 2, 1, True), ("linear", 0, 3, 5, False),
         ("tetra", 20, 6, 5, False), ("linear", 20, 12, 5, False),
         ("tetra", 0, 3, 1, True)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this module runs: the tier runs several
    test files at once, and torch's CPU ops on every core of each worker
    oversubscribe the machine (as tests/test_torch_raydrop_train.py
    found)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _case(interp, cutoff, c, n, zero_stds, seed):
    spec, spec_j = mode_specs(interp, c)
    table, x01, stds = mode_inputs(spec, seed=seed, n=max(n, 5))
    x01, stds = x01[:, :n].copy(), stds[:, :n].copy()
    if zero_stds:
        stds[:] = 0.0
    g_out = np.random.RandomState(seed).randn(
        x01.shape[0], spec.output_dim).astype(np.float32)
    return spec, spec_j, table, x01, stds, g_out


@pytest.mark.parametrize("interp,cutoff,c,n,zero_stds", CASES)
def test_residual_pos_grads_match_jax_vjp(interp, cutoff, c, n, zero_stds):
    spec, spec_j, table, x01, stds, g_out = _case(interp, cutoff, c, n,
                                                  zero_stds, 30 + c + n)
    assert ((x01 < 0) | (x01 > 1)).any(-1).any()
    _, vjp = jax.vjp(
        lambda x, s: jgrid.hash_encode_multisample(
            jnp.asarray(table), x, s, spec_j, coarse_res_cutoff=cutoff)[0],
        jnp.asarray(x01), jnp.asarray(stds))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g_out))]
    res = grid.hash_encode_ms_residuals_plain(
        *(torch.from_numpy(a) for a in (table, x01, stds)), spec, cutoff)
    assert res.shape == (spec.num_levels, n, 4, x01.shape[0], c)
    oob = torch.from_numpy(((x01 < 0) | (x01 > 1)).any(-1))
    point_levels = ~torch.tensor(grid.mean_levels(spec, cutoff))
    by_point = res[point_levels].permute(0, 3, 1, 2, 4)  # [L, B, n, 4, C]
    assert not by_point[:, oob].any()  # no gradient out of range
    got = grid.pos_grads_from_residuals_plain(res, torch.from_numpy(g_out))
    for name, a, b in zip(("x01", "stds"), got, want):
        if zero_stds and name == "stds":  # the erf weight is clamped at 0
            assert not np.abs(b).any() and not a.abs().any()
            continue
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy().reshape(b.shape), b, rtol=RTOL,
                                   atol=ATOL * np.abs(b).max(), err_msg=name)


def test_autograd_position_grads_same_bits_in_both_modes():
    """The autograd path (the forward's residuals, the backward's
    contraction) gives d_x01 / d_stds the same bits with torch's
    deterministic switch on and off."""
    spec, _, table, x01, stds, g_out = _case("tetra", 20, 2, 5, False, 7)
    grads = []
    was = torch.are_deterministic_algorithms_enabled()
    for det in (False, True):
        torch.use_deterministic_algorithms(det)
        try:
            leaves = [torch.from_numpy(a).requires_grad_(True)
                      for a in (table, x01, stds)]
            grid.hash_encode_multisample(*leaves, spec, 20).backward(
                torch.from_numpy(g_out))
        finally:
            torch.use_deterministic_algorithms(was)
        grads.append((leaves[1].grad, leaves[2].grad))
    for a, b in zip(*grads):
        assert a.abs().max() > 0 and torch.equal(a, b)


def test_residuals_only_where_positions_take_a_gradient():
    """No R where x01 and stds take no gradient (the table alone, under
    no_grad, diff_inputs False); one residual call a forward where they
    do, and none more in its backward; a direct caller of the backward
    that passes no R gets one residual call."""
    spec, _, table, x01, stds, g_out = _case("linear", 0, 4, 5, False, 3)
    t, x, s, g = (torch.from_numpy(a) for a in (table, x01, stds, g_out))
    nodiff, _ = mode_specs("linear", 4, diff_inputs=False)
    calls = lambda: grid.hash_encode_ms_residuals.calls  # noqa: E731
    before = calls()
    grid.hash_encode_multisample(t.clone().requires_grad_(True), x, s,
                                 spec).backward(g)
    with torch.no_grad():
        grid.hash_encode_multisample(t, x.clone().requires_grad_(True), s,
                                     spec)
    grid.hash_encode_multisample(t, x.clone().requires_grad_(True), s,
                                 nodiff).sum().backward()
    assert calls() == before
    leaf = x.clone().requires_grad_(True)
    out = grid.hash_encode_multisample(t, leaf, s, spec)
    assert calls() == before + 1
    out.backward(g)
    assert calls() == before + 1 and leaf.grad.abs().max() > 0
    direct = grid.hash_encode_multisample_bwd(t, x, s, g, spec,
                                              (False, True, True))
    assert calls() == before + 2
    assert direct[0] is None and torch.equal(direct[1], leaf.grad)
