"""The hash-table gradient check of chip_smoke.py [8] (kernels on vs off
after one train step), on tiny_debug-size tensors on the CPU.

The check holds each entry of a table's gradient to TABLE_GRAD_EPS_MULT
float32 eps of the magnitudes of the terms summed into it, beyond what the
two sides' different encode inputs carry. It must pass a gradient that
differs only by the order of its float32 sums, also where the terms of a
row cancel far below their magnitudes (which failed the former 1e-3 of the
largest value), and fail a zeroed, sign-flipped or row-permuted one.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from nerf_lidar_tpu_torch import configs
from nerf_lidar_tpu_torch.ops import grid

SPEC = grid.spec_for(configs.tiny_debug().model.nerf_mlp.grid)
DECAY = 0.1  # the presets' hash_decay_mults


def _inputs(seed, b=3000, n=3):
    """A table and (x01, stds, g_out) of b samples of n points, clustered
    along 30 rays as the model's samples are, so that coarse rows take
    hundreds of terms and fine rows a few."""
    rng = np.random.RandomState(seed)
    origin = rng.rand(30, 1, 1, 3) * 0.5 + 0.25
    step = rng.randn(30, 1, 1, 3) * 0.002
    t = np.arange(b // 30)[None, :, None, None]
    x01 = origin + step * t + rng.randn(30, b // 30, n, 3) * 1e-3
    table = rng.rand(SPEC.total_rows, SPEC.level_dim) * 2 - 1
    stds = rng.rand(b, n) * 0.01 + 1e-4
    g_out = rng.randn(b, SPEC.output_dim)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return (f32(table), f32(x01.reshape(b, n, 3)), f32(stds), f32(g_out))


def _grad(table, x01, stds, g_out):
    """The table's gradient: the encode backward (index_add_ in point
    order, float32) plus the hash-decay term's."""
    d = grid.hash_encode_multisample_bwd_plain(
        table, x01, stds, g_out, SPEC, needs=(True, False, False))[0]
    return d + chip_smoke.hash_decay_grad(table, SPEC, DECAY)


def _reordered(inputs, seed):
    """The same points in another order: the same sums, summed in another
    order."""
    table, *rest = inputs
    perm = torch.from_numpy(np.random.RandomState(seed).permutation(
        rest[0].shape[0]))
    return (table, *(t[perm] for t in rest))


def _excess(got, on, off):
    table = on[0]
    terms, upstream = chip_smoke.table_grad_bounds(
        SPEC, table, on[1:], off[1:],
        chip_smoke.hash_decay_grad(table, SPEC, DECAY))
    return chip_smoke.table_grad_excess(got, _grad(*off), terms, upstream)


def _cancelling(inputs):
    """Every point twice, with g_out and -(1 + 1e-6) g_out: each row's
    gradient ends ~1e-6 of its terms' magnitudes, as rows of a proposal
    grid's table can in training."""
    table, x01, stds, g_out = inputs
    return (table, torch.cat([x01, x01]), torch.cat([stds, stds]),
            torch.cat([g_out, -g_out * (1 + 1e-6)]))


@pytest.mark.parametrize("cancel", [False, True])
def test_passes_reordered_float32_sums(cancel):
    off = _inputs(0)
    if cancel:
        off = _cancelling(off)
    on = _reordered(off, 1)
    got = _grad(*on)
    want = _grad(*off)
    assert not torch.equal(got, want)  # the order did change the sums
    excess = _excess(got, on, off)
    assert excess <= chip_smoke.TABLE_GRAD_EPS_MULT
    if cancel:
        # The former check, 1e-3 of the largest value, fails this gradient.
        err = float((got - want).abs().max())
        assert err > chip_smoke.GRAD_TOL * float(want.abs().max())


def test_passes_what_different_encode_inputs_carry():
    """The kernels-on step's encode sees slightly other points and feature
    gradients (the resampling and the MLPs run in another order): the
    difference they carry is allowed, and nothing beyond it."""
    off = _inputs(2)
    rng = np.random.RandomState(3)
    table, x01, stds, g_out = off
    on = _reordered((
        table, x01 + torch.from_numpy(rng.randn(*x01.shape).astype(
            np.float32)) * 1e-6,
        stds, g_out * (1 + torch.from_numpy(rng.randn(*g_out.shape).astype(
            np.float32)) * 1e-5)), 4)
    got = _grad(*on)
    assert _excess(got, on, off) <= chip_smoke.TABLE_GRAD_EPS_MULT
    table_only = (table, x01, stds, g_out)
    assert _excess(got, table_only, off) > chip_smoke.TABLE_GRAD_EPS_MULT


@pytest.mark.parametrize("fault", ["zero", "sign", "rows", "nan"])
@pytest.mark.parametrize("cancel", [False, True])
def test_fails_a_wrong_table_gradient(fault, cancel):
    off = _inputs(5)
    if cancel:
        off = _cancelling(off)
    on = _reordered(off, 6)
    got = _grad(*on)
    if fault == "zero":
        got = torch.zeros_like(got)
    elif fault == "sign":
        got = -got
    elif fault == "rows":
        got = got[torch.from_numpy(np.random.RandomState(7).permutation(
            got.shape[0]))]
    else:
        got[3, 0] = float("nan")
    assert _excess(got, on, off) > chip_smoke.TABLE_GRAD_EPS_MULT
