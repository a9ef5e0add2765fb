"""The hash-grid backward and the K3 scatter-add against the JAX package.

- The plain encode's gradients (table, x01, stds), both by autograd through
  `hash_encode_multisample_plain` and from the written-out
  `hash_encode_multisample_bwd_plain` (the twin of kernel H1's backward),
  against `jax.vjp` of `nerf_lidar_tpu.ops.grid.hash_encode_multisample`,
  over tiled and hashed levels with points out of range.
- the same, written-out and through the wrapper, in every mode of
  tests/test_torch_grid.py (trilinear / tetrahedral, mean-point levels,
  C in {1, 2, 4, 16}, diff_inputs on and off: the JAX
  `_ms_encode_nodiff_bwd`, d_table with zero position gradients);
- `scatter_add_rows_plain` against K3 itself: the Pallas kernel of
  `experiments/scatter_variants.py`, run in interpret mode off the TPU.

Tolerances: gradients rtol 1e-4 / atol 1e-5 (sums of up to a few hundred
fp32 terms per table row, taken in another order than JAX's scatter);
scatter-add rtol 1e-5 / atol 1e-5 (sums of about eight values per row).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import configs
from nerf_lidar_tpu.ops import grid as jgrid
from nerf_lidar_tpu_torch import configs as tconfigs
from nerf_lidar_tpu_torch.ops import grid

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from experiments import scatter_variants  # noqa: E402
from test_torch_grid import MODES, mode_inputs, mode_specs  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _inputs(level_dim, seed):
    # A small hashmap forces hashing on the fine levels while the coarse
    # ones stay tiled; uniform(-1, 1) tables keep the values informative.
    kw = dict(level_dim=level_dim, base_resolution=4, desired_resolution=96,
              log2_hashmap_size=9)
    g = configs.GridConfig(**kw)  # the JAX side's
    spec = grid.spec_for(tconfigs.GridConfig(**kw))
    tiled = [spec.is_tiled(l) for l in range(spec.num_levels)]
    assert any(tiled) and not all(tiled)
    rng = np.random.RandomState(seed)
    table = rng.uniform(-1, 1, (spec.total_rows, level_dim)).astype(
        np.float32)
    x01 = rng.uniform(-0.1, 1.1, (30, 5, 3)).astype(np.float32)
    stds = rng.uniform(1e-4, 0.05, (30, 5)).astype(np.float32)
    stds[0, :2] = 1e-7  # the erf weight's clamp
    g_out = rng.randn(30, spec.output_dim).astype(np.float32)
    assert ((x01 < 0) | (x01 > 1)).any(-1).mean() > 0.2
    return g, spec, table, x01, stds, g_out


def _jax_grads(g, table, x01, stds, g_out):
    spec_j = jgrid.spec_for(g)
    _, vjp = jax.vjp(
        lambda t, x, s: jgrid.hash_encode_multisample(t, x, s, spec_j)[0],
        jnp.asarray(table), jnp.asarray(x01), jnp.asarray(stds))
    return [np.asarray(a) for a in vjp(jnp.asarray(g_out))]


@pytest.mark.parametrize("level_dim", [1, 2, 4])
@pytest.mark.parametrize("how", ["autograd", "bwd_plain", "wrapper"])
def test_encode_grads_match_jax_vjp(level_dim, how):
    g, spec, table, x01, stds, g_out = _inputs(level_dim, level_dim)
    want = _jax_grads(g, table, x01, stds, g_out)
    t, x, s = (torch.from_numpy(a).requires_grad_(True)
               for a in (table, x01, stds))
    if how == "bwd_plain":
        got = grid.hash_encode_multisample_bwd_plain(
            t.detach(), x.detach(), s.detach(), torch.from_numpy(g_out),
            spec)
    else:
        encode = (grid.hash_encode_multisample if how == "wrapper" else
                  lambda *a: grid.hash_encode_multisample_plain(*a)[0])
        out = encode(t, x, s, spec)
        out.backward(torch.from_numpy(g_out))
        got = (t.grad, x.grad, s.grad)
    for name, a, b in zip(("table", "x01", "stds"), got, want):
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("diff_inputs", [True, False])
@pytest.mark.parametrize("interp,cutoff,c", MODES)
def test_encode_mode_grads_match_jax(interp, cutoff, c, diff_inputs):
    """The written-out backward and the wrapper's autograd against
    `jax.vjp` in every mode, on test_torch_grid.py's points (ties, faces,
    clusters, out-of-range means). With diff_inputs False the JAX encode
    is `_ms_encode_nodiff` (its custom VJP: d_table alone, zero position
    and std gradients), and the wrapper passes no gradient to x01 / stds."""
    spec, spec_j = mode_specs(interp, c, diff_inputs)
    table, x01, stds = mode_inputs(spec, seed=10 + c)
    g_out = np.random.RandomState(c).randn(
        x01.shape[0], spec.output_dim).astype(np.float32)
    _, vjp = jax.vjp(
        lambda t, x, s: jgrid.hash_encode_multisample(
            t, x, s, spec_j, coarse_res_cutoff=cutoff)[0],
        jnp.asarray(table), jnp.asarray(x01), jnp.asarray(stds))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g_out))]
    if not diff_inputs:
        assert not np.abs(want[1]).any() and not np.abs(want[2]).any()
    needs = (True, diff_inputs, diff_inputs)
    written = grid.hash_encode_multisample_bwd_plain(
        *(torch.from_numpy(a) for a in (table, x01, stds, g_out)), spec,
        needs, cutoff)
    t, x, s = (torch.from_numpy(a).requires_grad_(True)
               for a in (table, x01, stds))
    grid.hash_encode_multisample(t, x, s, spec, cutoff).backward(
        torch.from_numpy(g_out))
    for i, name in enumerate(("table", "x01", "stds")):
        if not needs[i]:
            assert written[i] is None, name
            assert (t, x, s)[i].grad is None, name
            continue
        assert np.abs(want[i]).max() > 0, name
        for how, got in (("bwd_plain", written[i]), ("wrapper",
                                                     (t, x, s)[i].grad)):
            np.testing.assert_allclose(got.numpy(), want[i], rtol=RTOL,
                                       atol=ATOL * np.abs(want[i]).max(),
                                       err_msg=f"{name} {how}")


def test_nodiff_plain_encode_stops_position_gradients():
    """The plain encode itself (the model's `use_kernels=False` path)
    gives x01 and stds no gradient when diff_inputs is False, as the JAX
    custom VJP gives zeros."""
    spec, _ = mode_specs("tetra", 4, diff_inputs=False)
    table, x01, stds = mode_inputs(spec, seed=3)
    t, x, s = (torch.from_numpy(a).requires_grad_(True)
               for a in (table, x01, stds))
    grid.hash_encode_multisample_plain(t, x, s, spec, 20)[0].sum().backward()
    assert x.grad is None and s.grad is None
    assert float(t.grad.abs().sum()) > 0


def test_wrapper_output_has_grad_fn():
    """The wrapper's features carry a backward whenever the table requires
    grad (the CUDA branch once returned a plain tensor, and a loss on it
    left table.grad None)."""
    spec = grid.spec_for(tconfigs.tiny_debug().model.nerf_mlp.grid)
    table = torch.zeros(spec.total_rows, spec.level_dim, requires_grad=True)
    out = grid.hash_encode_multisample(table, torch.rand(4, 3, 3) * 0.9,
                                       torch.rand(4, 3) * 0.01, spec)
    assert out.grad_fn is not None
    out.sum().backward()
    assert table.grad is not None and float(table.grad.abs().sum()) > 0


def test_bwd_plain_computes_only_what_is_asked():
    g, spec, table, x01, stds, g_out = _inputs(4, 7)
    args = [torch.from_numpy(a) for a in (table, x01, stds, g_out)]
    d_t, d_x, d_s = grid.hash_encode_multisample_bwd_plain(
        *args, spec, needs=(True, False, False))
    assert d_x is None and d_s is None
    full = grid.hash_encode_multisample_bwd_plain(*args, spec)
    torch.testing.assert_close(d_t, full[0], rtol=0, atol=0)
    assert grid.hash_encode_multisample_bwd_plain(
        *args, spec, needs=(False, True, True))[0] is None


def test_scatter_add_rows_plain_matches_k3():
    rows, n, c = 256, 2048, scatter_variants.C
    rng = np.random.RandomState(0)
    idx = rng.randint(0, rows, n).astype(np.int32)
    vals = rng.randn(n, c).astype(np.float32)
    want = np.asarray(scatter_variants.pallas_mxu_scatter(
        jnp.asarray(idx), jnp.asarray(vals), rows))
    got = grid.scatter_add_rows_plain(torch.from_numpy(idx),
                                      torch.from_numpy(vals), rows)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # The CPU path of the wrapper is the plain version.
    wrapped = grid.scatter_add_rows(torch.from_numpy(idx),
                                    torch.from_numpy(vals), rows)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


def test_scatter_add_rows_drops_out_of_range_and_differentiates():
    idx = torch.tensor([0, 3, -1, 3, 4, 1], dtype=torch.int32)
    vals = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    vals.requires_grad_(True)
    out = grid.scatter_add_rows(idx, vals, 4)
    torch.testing.assert_close(out.detach(), torch.tensor(
        [[0.0, 1.0], [10.0, 11.0], [0.0, 0.0], [8.0, 10.0]]))
    g = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    out.backward(g)
    torch.testing.assert_close(vals.grad, torch.tensor(
        [[0.0, 1.0], [6.0, 7.0], [0.0, 0.0], [6.0, 7.0], [0.0, 0.0],
         [2.0, 3.0]]))
    with pytest.raises(ValueError, match="idx"):
        grid.scatter_add_rows(idx[:-1], vals, 4)


def test_level_ids_match_jax():
    spec = grid.spec_for(tconfigs.tiny_debug().model.nerf_mlp.grid)
    want = jgrid.spec_for(configs.tiny_debug().model.nerf_mlp.grid)
    np.testing.assert_array_equal(grid.level_ids(spec).numpy(),
                                  want.level_ids())
