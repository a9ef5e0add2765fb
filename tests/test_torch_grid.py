"""The port's hash-grid spec and plain multisample encode against the JAX
`ops/grid.py` (the CUDA kernel H1 is held against the plain encode on the
card by chip_smoke.py and tests/test_torch_cuda.py): the presets' grids
(the spectral encoder's dense band too), trilinear and tetrahedral
interpolation, mean-point coarse levels, C in {1, 2, 4, 8, 16} and the
kernels' general widths C in {3, 6, 12}, on points with ties of their
fractional parts and on cell faces; and the general path's walk plans
(`grid.walk_plan`: slices a lane, lanes a sample, walks a level, the
backward's padded rows), which the kernels take as given.

Tolerance: features rtol 1e-5 / atol 1e-6; erf weights rtol 1e-6.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import configs
from nerf_lidar_tpu.ops import grid as jgrid
from nerf_lidar_tpu_torch import configs as tconfigs
from nerf_lidar_tpu_torch.ops import grid


def _grid_cfgs(cfgs=configs):
    """The grids of the presets, from the JAX `configs` or the port's."""
    tiny = cfgs.tiny_debug().model
    full = cfgs.nuscenes_single().model
    out = {
        "tiny_nerf": tiny.nerf_mlp.grid,
        "tiny_prop0": tiny.prop_mlp_for_level(0).grid,
        "nusc_nerf": full.nerf_mlp.grid,
        "nusc_prop0": full.prop_mlp_for_level(0).grid,
        "nusc_prop1": full.prop_mlp_for_level(1).grid,
    }
    speed = cfgs.nuscenes_single_speed()
    for name, cfg in (("fast", cfgs.nuscenes_single_fast()),
                      ("mxu", cfgs.nuscenes_single_mxu()),
                      ("speed", speed),
                      ("specobj", cfgs.spectral_obj_variant(speed))):
        m = cfg.model
        out[f"{name}_nerf"] = m.nerf_mlp.grid
        out[f"{name}_obj"] = m.obj_mlp.grid
        for i in range(len(m.num_prop_samples)):
            out[f"{name}_prop{i}"] = m.prop_mlp_for_level(i).grid
    return out


@pytest.mark.parametrize("name", sorted(_grid_cfgs()))
def test_spec_matches_jax(name):
    got = grid.spec_for(_grid_cfgs(tconfigs)[name])
    want = jgrid.spec_for(_grid_cfgs()[name])
    assert got.offsets == want.offsets
    assert got.rows_per_level == want.rows_per_level
    assert got.resolutions == want.resolutions
    assert got.scales == want.scales
    assert got.output_dim == want.output_dim
    assert ([got.is_tiled(l) for l in range(got.num_levels)]
            == [want.is_tiled(l) for l in range(want.num_levels)])
    np.testing.assert_array_equal(got.grid_sizes(), want.grid_sizes())


def test_nuscenes_single_nerf_spec_size():
    spec = grid.spec_for(tconfigs.nuscenes_single().model.nerf_mlp.grid)
    assert spec.total_rows == 14_995_560
    assert [spec.is_tiled(l) for l in range(10)] == [True] * 3 + [False] * 7


@pytest.mark.parametrize("level_dim", [1, 4])
def test_plain_encode_matches_jax(level_dim):
    # A small hashmap forces hashing on the fine levels while the coarse
    # ones stay tiled; uniform(-1, 1) tables keep the values informative.
    kw = dict(level_dim=level_dim, base_resolution=4, desired_resolution=96,
              log2_hashmap_size=9)
    spec_j = jgrid.spec_for(configs.GridConfig(**kw))
    spec = grid.spec_for(tconfigs.GridConfig(**kw))
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
    """What still refuses: an encoder other than 'hash' / 'dense_fourier',
    an interpolation other than 'linear' / 'tetra', input_dim != 3. The
    spectral encoder's dense band and tetrahedral interpolation, refused
    before, now build and encode."""
    g = tconfigs.tiny_debug().model.nerf_mlp.grid
    with pytest.raises(NotImplementedError):
        grid.spec_for(dataclasses.replace(g, encoder="fourier_only"))
    spec = grid.spec_for(dataclasses.replace(g, interp="cubic"))
    with pytest.raises(NotImplementedError):
        grid.hash_encode_multisample_plain(
            torch.zeros(spec.total_rows, spec.level_dim),
            torch.zeros(2, 3, 3), torch.zeros(2, 3), spec)
    with pytest.raises(NotImplementedError):
        grid.hash_encode_multisample_plain(
            torch.zeros(8, 2), torch.zeros(2, 3, 2), torch.zeros(2, 3),
            dataclasses.replace(grid.spec_for(g), input_dim=2))
    for kw in (dict(encoder="dense_fourier"), dict(interp="tetra")):
        spec = grid.spec_for(dataclasses.replace(g, **kw))
        want = jgrid.spec_for(dataclasses.replace(
            configs.tiny_debug().model.nerf_mlp.grid, **kw))
        assert spec.offsets == want.offsets and spec.interp == want.interp
        feats, _ = grid.hash_encode_multisample_plain(
            torch.ones(spec.total_rows, spec.level_dim),
            torch.full((2, 3, 3), 0.5), torch.zeros(2, 3), spec)
        torch.testing.assert_close(feats, torch.ones_like(feats))


def mode_inputs(spec, seed, b=40, n=5):
    """Seeded (table uniform(-1, 1), x01 [b, n, 3], stds [b, n]) whose
    points stress the new modes: uniform points with out-of-range ones;
    x == y (a tie of two fractional parts at every level, where the
    tetrahedral ranks break by axis order); x == y == z; points on the
    cell faces of level 1 (pos integral, a fraction 0); multisamples
    within 1e-3 of one point (one cell at the coarse levels, a mean point
    near them); a sample whose mean is out of range though some points are
    in."""
    rng = np.random.RandomState(seed)
    table = rng.uniform(-1, 1, (spec.total_rows, spec.level_dim)).astype(
        np.float32)
    x01 = rng.uniform(-0.1, 1.1, (b, n, 3)).astype(np.float32)
    q = b // 8
    x01[q:2 * q, :, 1] = x01[q:2 * q, :, 0]
    x01[2 * q:3 * q, :, 1:] = x01[2 * q:3 * q, :, :1]
    k = rng.randint(1, int(spec.scales[1]), (q, n, 3))
    x01[3 * q:4 * q] = ((k - 0.5) / np.float32(spec.scales[1])).astype(
        np.float32)
    x01[4 * q:6 * q] = (rng.uniform(0.05, 0.95, (2 * q, 1, 3))
                        + rng.uniform(-5e-4, 5e-4, (2 * q, n, 3)))
    x01[6 * q, :, 0] = [1.05, 1.05, 1.05, 0.9, 0.9][:n]
    stds = rng.uniform(1e-4, 0.05, (b, n)).astype(np.float32)
    return table, np.clip(x01, -0.2, 1.2).astype(np.float32), stds


# A small hashmap hashes the fine levels while the coarse ones stay tiled;
# cutoff 20 puts levels 5 and 9 (and 17 at C = 16's spec) at the mean. C 3,
# 6 and 12: widths the kernels take by their general path (a row read as
# slices of gcd(C, 4) floats).
MODES = [(interp, cutoff, c) for interp in ("linear", "tetra")
         for cutoff in (0, 20) for c in (1, 2, 4, 8, 16, 3, 6, 12)]


def mode_specs(interp, c, diff_inputs=True):
    """(the port's spec, the JAX spec) of the modes' grid."""
    kw = dict(level_dim=c, base_resolution=4, desired_resolution=96,
              log2_hashmap_size=9, interp=interp, diff_inputs=diff_inputs)
    return (grid.spec_for(tconfigs.GridConfig(**kw)),
            jgrid.spec_for(configs.GridConfig(**kw)))


@pytest.mark.parametrize("interp,cutoff,c", MODES)
def test_plain_encode_modes_match_jax(interp, cutoff, c):
    spec, spec_j = mode_specs(interp, c)
    mean = grid.mean_levels(spec, cutoff)
    assert any(mean) == (cutoff > 0) and not all(mean)
    table, x01, stds = mode_inputs(spec, seed=c)
    feats, w = grid.hash_encode_multisample_plain(
        torch.from_numpy(table), torch.from_numpy(x01),
        torch.from_numpy(stds), spec, cutoff)
    jfeats, jw = jgrid.hash_encode_multisample(
        jnp.asarray(table), jnp.asarray(x01), jnp.asarray(stds), spec_j,
        coarse_res_cutoff=cutoff)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    wrapped = grid.hash_encode_multisample(
        torch.from_numpy(table), torch.from_numpy(x01),
        torch.from_numpy(stds), spec, cutoff)
    np.testing.assert_array_equal(wrapped.numpy(), feats.numpy())


# (width, slices, lanes, walks, padded) of the general path's plans: H1
# (both modes), H1-bwd, its deterministic variant.
WALK_PLANS = {
    3: ((1, 3, 1, 1, 0), (1, 3, 1, 1, 4), (1, 3, 1, 1, 0)),
    5: ((1, 4, 2, 1, 0), (1, 4, 1, 2, 8), (1, 4, 1, 2, 0)),
    6: ((2, 2, 2, 1, 0), (2, 3, 1, 1, 8), (2, 1, 1, 3, 0)),
    7: ((1, 4, 2, 1, 0), (1, 4, 1, 2, 8), (1, 4, 1, 2, 0)),
    10: ((2, 2, 3, 1, 0), (2, 4, 1, 2, 12), (2, 1, 1, 5, 0)),
    12: ((4, 1, 3, 1, 0), (4, 3, 1, 1, 0), (4, 1, 1, 3, 0)),
    20: ((4, 1, 5, 1, 0), (4, 4, 1, 2, 0), (4, 1, 1, 5, 0)),
    36: ((4, 1, 9, 1, 0), (4, 4, 1, 3, 0), (4, 1, 1, 9, 0)),
}
KERNELS = ("encode", "backward", "deterministic")


@pytest.mark.parametrize("c", sorted(WALK_PLANS))
def test_walk_plan_of_the_general_widths(c):
    """The general path's plans at the card tests' widths: H1 a float4 of
    a row a lane (C6: two lanes a sample, C12 three), one walk a level;
    H1-bwd a lane a sample, C3, C6 and C12 (the grids of chip_smoke.py
    [21]) one walk a level, its padded rows 16 bytes where C % 4; the
    deterministic variant 4 floats a walk at gcd(C, 4) = 1, a slice
    otherwise."""
    got = [grid.walk_plan(c, k) for k in KERNELS]
    assert [dataclasses.astuple(p) for p in got] == list(WALK_PLANS[c])


@pytest.mark.parametrize("c", range(1, 161))
def test_walk_plan_covers_every_row(c):
    """Any width: None for the tuned ones; else the slices are gcd(C, 4)
    floats, a lane takes at most the kernels' span (H1: 4 floats, H1-bwd:
    4 slices, its deterministic variant 4 floats at gcd(C, 4) = 1 and a
    slice otherwise), a sample at most
    a warp (the backward: one lane), and the walks cover the S slices with
    no walk to spare; H1 takes one walk for C <= 128, H1-bwd for S <= 4;
    an atomic backward walk that leaves slices to another covers a
    multiple of 4 floats (its float4 spans start on 16 bytes)."""
    if c in (1, 2, 4, 8, 16):
        assert all(grid.walk_plan(c, k) is None for k in KERNELS)
        return
    v = math.gcd(c, 4)
    s = c // v
    for kernel, most in zip(KERNELS, (4 // v, 4, 4 if v == 1 else 1)):
        p = grid.walk_plan(c, kernel)
        assert p.width == v and 1 <= p.slices <= most
        assert 1 <= p.lanes <= (32 if kernel == "encode" else 1)
        cover = p.lanes * p.slices
        assert cover * p.walks >= s > cover * (p.walks - 1)
        if kernel == "backward" and p.walks > 1:
            assert p.slices * p.width % 4 == 0
        if (c <= 128 and kernel == "encode") or (
                s <= 4 and kernel == "backward"):
            assert p.walks == 1
        assert p.padded == (-(-c // 4) * 4
                            if kernel == "backward" and c % 4 else 0)


def test_backward_pads_rows_where_the_call_is_dense():
    """The atomic backward sums into 16-byte rows where a call's
    point-levels reach the table's rows (the C3 NeRF train call), into
    d_table where they do not (the C3 object grid's), never at C % 4 ==
    0 or a tuned width."""
    nerf = grid.spec_for(dataclasses.replace(
        tconfigs.nuscenes_single().model.nerf_mlp.grid, level_dim=3))
    obj = grid.spec_for(dataclasses.replace(
        tconfigs.nuscenes_single().model.obj_mlp.grid, level_dim=3))
    plan = grid.walk_plan(3, "backward")
    assert grid.pad_rows(nerf, 655_360 * 7, plan)
    assert not grid.pad_rows(obj, 81_920, plan)
    for c in (4, 12):
        spec = grid.spec_for(dataclasses.replace(
            tconfigs.nuscenes_single().model.nerf_mlp.grid, level_dim=c))
        assert not grid.pad_rows(spec, 10**9,
                                 grid.walk_plan(c, "backward"))
