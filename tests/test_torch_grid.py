"""The port's hash-grid spec and plain multisample encode against the JAX
`ops/grid.py` (the CUDA kernel H1 is held against the plain encode on the
card by chip_smoke.py).

Tolerance: features rtol 1e-5 / atol 1e-6; erf weights rtol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import configs
from nerf_lidar_tpu.ops import grid as jgrid
from nerf_lidar_tpu_torch.ops import grid


def _grid_cfgs():
    tiny = configs.tiny_debug().model
    full = configs.nuscenes_single().model
    return {
        "tiny_nerf": tiny.nerf_mlp.grid,
        "tiny_prop0": tiny.prop_mlp_for_level(0).grid,
        "nusc_nerf": full.nerf_mlp.grid,
        "nusc_prop0": full.prop_mlp_for_level(0).grid,
        "nusc_prop1": full.prop_mlp_for_level(1).grid,
    }


@pytest.mark.parametrize("name", sorted(_grid_cfgs()))
def test_spec_matches_jax(name):
    g = _grid_cfgs()[name]
    got, want = grid.spec_for(g), jgrid.spec_for(g)
    assert got.offsets == want.offsets
    assert got.rows_per_level == want.rows_per_level
    assert got.resolutions == want.resolutions
    assert got.scales == want.scales
    assert got.output_dim == want.output_dim
    assert ([got.is_tiled(l) for l in range(got.num_levels)]
            == [want.is_tiled(l) for l in range(want.num_levels)])
    np.testing.assert_array_equal(got.grid_sizes(), want.grid_sizes())


def test_nuscenes_single_nerf_spec_size():
    spec = grid.spec_for(configs.nuscenes_single().model.nerf_mlp.grid)
    assert spec.total_rows == 14_995_560
    assert [spec.is_tiled(l) for l in range(10)] == [True] * 3 + [False] * 7


@pytest.mark.parametrize("level_dim", [1, 4])
def test_plain_encode_matches_jax(level_dim):
    # A small hashmap forces hashing on the fine levels while the coarse
    # ones stay tiled; uniform(-1, 1) tables keep the values informative.
    g = configs.GridConfig(level_dim=level_dim, base_resolution=4,
                           desired_resolution=96, log2_hashmap_size=9)
    spec_j = jgrid.spec_for(g)
    spec = grid.spec_for(g)
    tiled = [spec.is_tiled(l) for l in range(spec.num_levels)]
    assert any(tiled) and not all(tiled)

    rng = np.random.RandomState(level_dim)
    table = rng.uniform(-1, 1, (spec.total_rows, level_dim)).astype(np.float32)
    x01 = rng.uniform(-0.1, 1.1, (40, 7, 3)).astype(np.float32)
    x01[:4, 0] = [1.0, 0.0, 0.5]  # on the boundary of the unit cube
    stds = rng.uniform(1e-4, 0.05, (40, 7)).astype(np.float32)
    assert ((x01 < 0) | (x01 > 1)).any(-1).mean() > 0.2

    feats, w = grid.hash_encode_multisample_plain(
        torch.from_numpy(table), torch.from_numpy(x01),
        torch.from_numpy(stds), spec)
    jfeats, jw = jgrid.hash_encode_multisample(
        jnp.asarray(table), jnp.asarray(x01), jnp.asarray(stds), spec_j)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    # The CPU path of the dispatching wrapper is the plain version.
    wrapped = grid.hash_encode_multisample(
        torch.from_numpy(table), torch.from_numpy(x01),
        torch.from_numpy(stds), spec)
    np.testing.assert_array_equal(wrapped.numpy(), feats.numpy())


def test_unported_grid_flags_raise():
    g = configs.tiny_debug().model.nerf_mlp.grid
    with pytest.raises(NotImplementedError):
        grid.spec_for(dataclasses.replace(g, encoder="dense_fourier"))
    spec = grid.spec_for(dataclasses.replace(g, interp="tetra"))
    with pytest.raises(NotImplementedError):
        grid.hash_encode_multisample_plain(
            torch.zeros(spec.total_rows, spec.level_dim),
            torch.zeros(2, 3, 3), torch.zeros(2, 3), spec)
