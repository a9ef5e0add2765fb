"""The port's plain tensor ops against the JAX package on the same inputs.

Tolerance: rtol 1e-5, atol 1e-6 (fp32; the two frameworks round sums and
transcendental functions differently in the last bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu.ops import coord as jcoord
from nerf_lidar_tpu.ops import mathx as jmathx
from nerf_lidar_tpu.ops import render as jrender
from nerf_lidar_tpu.ops import stepfun as jstepfun
from nerf_lidar_tpu_torch.ops import coord, mathx, render, stepfun

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x))


def _sorted_steps(rng, r, m):
    """[r, m] increasing knots with repeated values (ties)."""
    t = np.sort(rng.rand(r, m).astype(np.float32), axis=-1)
    t[:, 3] = t[:, 2]
    return t


def test_sorted_interp_ties_and_clamping():
    rng = np.random.RandomState(0)
    xp = _sorted_steps(rng, 16, 12)
    fp = np.cumsum(rng.rand(16, 12).astype(np.float32), axis=-1)
    # Queries below, inside, on and above the knots.
    x = np.concatenate([rng.uniform(-0.2, 1.2, (16, 20)), xp[:, :4]],
                       axis=-1).astype(np.float32)
    _close(mathx.sorted_interp(_t(x), _t(xp), _t(fp)),
           jmathx.sorted_interp(jnp.asarray(x), jnp.asarray(xp),
                                jnp.asarray(fp)))


def test_safe_div_and_sqrt():
    rng = np.random.RandomState(9)
    n = rng.randn(64).astype(np.float32)
    d = rng.randn(64).astype(np.float32)
    d[::4] = 0.0
    x = np.concatenate([rng.rand(60), [0.0, -1.0, 1e-30, 4.0]]).astype(
        np.float32)
    _close(mathx.safe_div(_t(n), _t(d)), jmathx.safe_div(jnp.asarray(n),
                                                        jnp.asarray(d)))
    _close(mathx.safe_sqrt(_t(x)), jmathx.safe_sqrt(jnp.asarray(x)))


@pytest.mark.parametrize("fn", [None, "piecewise", "power_transformation",
                                "reciprocal", "log", "sqrt"])
def test_construct_ray_warps(fn):
    rng = np.random.RandomState(1)
    near = rng.uniform(0.1, 0.5, (32, 1)).astype(np.float32)
    far = rng.uniform(5.0, 12.0, (32, 1)).astype(np.float32)
    s = rng.rand(32, 9).astype(np.float32)
    t = (near + s * (far - near)).astype(np.float32)
    t2s, s2t = coord.construct_ray_warps(fn, _t(near), _t(far), lam=-1.5)
    jt2s, js2t = jcoord.construct_ray_warps(fn, jnp.asarray(near),
                                            jnp.asarray(far), lam=-1.5)
    _close(s2t(_t(s)), js2t(jnp.asarray(s)))
    _close(t2s(_t(t)), jt2s(jnp.asarray(t)))


def test_contract_mean_std():
    rng = np.random.RandomState(2)
    x = (rng.randn(64, 7, 3) * 2).astype(np.float32)
    std = rng.rand(64, 7).astype(np.float32) * 0.1
    z, s = coord.contract_mean_std(_t(x), _t(std))
    jz, js = jcoord.track_linearize("contract", jnp.asarray(x),
                                    jnp.asarray(std))
    _close(z, jz)
    _close(s, js)


def test_pos_enc():
    rng = np.random.RandomState(3)
    x = rng.randn(50, 3).astype(np.float32)
    _close(coord.pos_enc(_t(x), 0, 4), jcoord.pos_enc(jnp.asarray(x), 0, 4))


def _step_fn(rng, r=24, m=17):
    t = np.sort(rng.rand(r, m + 1).astype(np.float32), axis=-1)
    w = rng.rand(r, m).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    return t, w


def test_max_dilate_weights():
    rng = np.random.RandomState(4)
    t, w = _step_fn(rng)
    got = stepfun.max_dilate_weights(_t(t), _t(w), 0.03, domain=(0.0, 1.0),
                                     renormalize=True)
    want = jstepfun.max_dilate_weights(jnp.asarray(t), jnp.asarray(w), 0.03,
                                       domain=(0.0, 1.0), renormalize=True)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("center", [False, True])
def test_sample_deterministic(center):
    rng = np.random.RandomState(10)
    t, w = _step_fn(rng)
    logits = np.log(w).astype(np.float32)
    got = stepfun.sample(_t(t), _t(logits), 24, deterministic_center=center)
    want = jstepfun.sample(None, jnp.asarray(t), jnp.asarray(logits), 24,
                           deterministic_center=center)
    _close(got, want)


def test_sample_intervals_deterministic():
    rng = np.random.RandomState(5)
    t, w = _step_fn(rng)
    logits = np.log(w + 1e-3).astype(np.float32)
    got = stepfun.sample_intervals(_t(t), _t(logits), 33, domain=(0.0, 1.0))
    want = jstepfun.sample_intervals(None, jnp.asarray(t),
                                     jnp.asarray(logits), 33,
                                     domain=(0.0, 1.0))
    _close(got, want)


def _rays(rng, r):
    d = rng.randn(r, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    bx = np.cross(d, [0.0, 0.0, 1.0])
    bx /= np.linalg.norm(bx, axis=-1, keepdims=True)
    by = np.cross(d, bx)
    return dict(origins=rng.randn(r, 3).astype(np.float32) * 0.1,
                directions=d, base_x=bx.astype(np.float32),
                base_y=by.astype(np.float32),
                radii=np.full((r, 1), 5e-3, np.float32))


def test_cast_rays():
    rng = np.random.RandomState(6)
    rays = _rays(rng, 40)
    tdist = np.sort(rng.uniform(0.2, 8.0, (40, 9)).astype(np.float32), -1)
    args = [rays[k] for k in ("origins", "directions", "base_x", "base_y",
                              "radii")]
    means, stds = render.cast_rays(_t(tdist), *map(_t, args), n=7, m=3,
                                   std_scale=0.35)
    jm, js = jrender.cast_rays(jnp.asarray(tdist), *map(jnp.asarray, args),
                               key=None, n=7, m=3, std_scale=0.35)
    _close(means, jm)
    _close(stds, js)


def _composite_inputs(seed, r=64, s=16, k=5):
    rng = np.random.RandomState(seed)
    density = (rng.rand(r, s) * 3).astype(np.float32)
    tdist = np.sort(rng.rand(r, s + 1).astype(np.float32) * 5, axis=-1)
    dirs = rng.randn(r, 3).astype(np.float32)
    rgb = rng.rand(r, s, 3).astype(np.float32)
    sem = rng.rand(r, s, k).astype(np.float32)
    inten = rng.rand(r, s, 1).astype(np.float32)
    return density, tdist, dirs, rgb, sem, inten


@pytest.mark.parametrize("opaque", [True, False])
def test_compute_alpha_weights(opaque):
    density, tdist, dirs = _composite_inputs(7)[:3]
    got = render.compute_alpha_weights(_t(density), _t(tdist), _t(dirs),
                                       opaque_background=opaque)
    want = jrender.compute_alpha_weights(
        jnp.asarray(density), jnp.asarray(tdist), jnp.asarray(dirs),
        opaque_background=opaque)
    for g, w in zip(got, want):
        _close(g, w)


def test_volumetric_rendering():
    density, tdist, dirs, rgb, sem, inten = _composite_inputs(8)
    w, _, _ = jrender.compute_alpha_weights(
        jnp.asarray(density), jnp.asarray(tdist), jnp.asarray(dirs),
        opaque_background=False)
    w = np.asarray(w)
    got = render.volumetric_rendering(_t(rgb), _t(w), _t(tdist), 1.0,
                                      semantic=_t(sem), intensity=_t(inten))
    want = jrender.volumetric_rendering(
        jnp.asarray(rgb), jnp.asarray(w), jnp.asarray(tdist), 1.0,
        jnp.asarray(tdist[:, -1:]), compute_extras=False,
        semantic=jnp.asarray(sem), intensity=jnp.asarray(inten))
    assert set(got) == set(want)
    for k in got:
        _close(got[k], want[k])
