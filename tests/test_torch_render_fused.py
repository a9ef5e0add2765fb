"""The port's plain fused compositor against the JAX Pallas `fused_composite`
(interpret mode on the CPU) and the JAX reference chain
`compute_alpha_weights` + `volumetric_rendering`. The CUDA kernel K1 is
held against the plain version on the card by chip_smoke.py.

Tolerances are those of tests/test_render_pallas.py: weights rtol 1e-5 /
atol 1e-6; depth rtol 1e-4 / atol 1e-5; rgb, semantic and intensity rtol
1e-5 / atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu.ops import render as jrender
from nerf_lidar_tpu.ops import render_pallas
from nerf_lidar_tpu_torch.ops import render_fused

TOL = dict(weights=(1e-5, 1e-6), depth=(1e-4, 1e-5), rgb=(1e-5, 1e-5),
           semantic=(1e-5, 1e-5), intensity=(1e-5, 1e-5))


def _inputs(r, s, k, seed):
    rng = np.random.RandomState(seed)
    density = (rng.rand(r, s) * 3).astype(np.float32)
    tdist = np.sort(rng.rand(r, s + 1).astype(np.float32) * 5, axis=-1)
    dirs = rng.randn(r, 3).astype(np.float32)
    rgb = rng.rand(r, s, 3).astype(np.float32)
    sem = rng.rand(r, s, k).astype(np.float32)
    inten = rng.rand(r, s).astype(np.float32)
    return density, tdist, dirs, rgb, sem, inten


def _check(got, want, keys):
    for key in keys:
        rtol, atol = TOL[key]
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("r,k,opaque,with_int", [
    (512, 5, True, False),
    (512, 5, False, False),
    (700, 5, True, False),   # ragged: not a multiple of the Pallas block
    (600, 19, True, False),  # the slice's class count
    (512, 5, True, True),    # with intensity
])
def test_plain_matches_pallas_and_reference(r, k, opaque, with_int):
    density, tdist, dirs, rgb, sem, inten = _inputs(r, 32, k, seed=r + k)
    inten = inten if with_int else None
    got = render_fused.fused_composite_plain(
        *map(torch.from_numpy, (density, tdist, dirs, rgb, sem)),
        intensity=None if inten is None else torch.from_numpy(inten),
        opaque_background=opaque, bg_value=1.0)
    keys = ["weights", "depth", "rgb", "semantic"] + (
        ["intensity"] if with_int else [])

    pallas = render_pallas.fused_composite(
        *map(jnp.asarray, (density, tdist, dirs, rgb, sem)),
        intensity=None if inten is None else jnp.asarray(inten),
        opaque_background=opaque, bg_value=1.0)
    _check(got, pallas, keys)
    np.testing.assert_allclose(got["acc"].numpy(), np.asarray(pallas["acc"]),
                               rtol=1e-5, atol=1e-6)

    w_ref, _, _ = jrender.compute_alpha_weights(
        jnp.asarray(density), jnp.asarray(tdist), jnp.asarray(dirs),
        opaque_background=opaque)
    ref = jrender.volumetric_rendering(
        jnp.asarray(rgb), w_ref, jnp.asarray(tdist), 1.0,
        jnp.asarray(tdist[:, -1:]), compute_extras=False,
        semantic=jnp.asarray(sem),
        intensity=None if inten is None else jnp.asarray(inten))
    ref["weights"] = w_ref
    _check(got, ref, keys)


def test_cpu_wrapper_is_the_plain_version():
    density, tdist, dirs, rgb, sem, inten = map(
        torch.from_numpy, _inputs(64, 8, 3, seed=1))
    a = render_fused.fused_composite(density, tdist, dirs, rgb, sem, inten)
    b = render_fused.fused_composite_plain(density, tdist, dirs, rgb, sem,
                                           inten)
    assert set(a) == set(b)
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
