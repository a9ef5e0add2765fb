"""`ops/ref_utils.py`, `mathx.safe_exp` / `safe_sin` / `safe_cos` and
`coord.integrated_pos_enc` against the JAX package on seeded inputs.

Tolerances: values rtol 1e-5 / atol 1e-6 (float32 transcendentals of the
two frameworks; exp below float32's smallest normal number, which XLA's
CPU code flushes to 0, atol 1e-37); the IDE rtol 1e-5 / atol 1e-6 plus 16
float32 eps of sum_k |c_k| |z|^k, the magnitude of the alternating sum its
z part takes (coefficients up to ~1e4 at deg_view 5);
gradients rtol 1e-4 / atol 1e-5 of the largest, away from the poles. At
the poles (x = y = 0) the encodings are equal and the port's gradients are
finite (JAX's are 0 / 0 there through atan2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu.ops import coord as jcoord
from nerf_lidar_tpu.ops import mathx as jmathx
from nerf_lidar_tpu.ops import ref_utils as jref
from nerf_lidar_tpu_torch.ops import coord, mathx, ref_utils


def _dirs(n, seed, poles=True):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if poles:
        d[:4] = [[0, 0, 1], [0, 0, -1], [0, 0, 1], [0, 0, -1]]
    return d


@pytest.mark.parametrize("deg_view", [1, 2, 3, 4, 5])
def test_ide_matches_jax_poles_included(deg_view):
    d = _dirs(64, deg_view)
    kappa = np.random.RandomState(9).uniform(0, 2, (64, 1)).astype(
        np.float32)
    kappa[2:4] = 0.0
    want = np.asarray(jref.generate_ide_fn(deg_view)(jnp.asarray(d),
                                                     jnp.asarray(kappa)))
    ide = ref_utils.generate_ide_fn(deg_view)
    got = ide(torch.from_numpy(d), torch.from_numpy(kappa)).numpy()
    assert got.shape == want.shape == (64, ref_utils.ide_width(deg_view))
    # Each harmonic's z part sums up to 2^(deg_view - 1) + 1 terms
    # c_k z^k with alternating signs and |c_k| up to ~1e4 at deg_view 5:
    # float32 rounding of that sum scales with sum_k |c_k| |z|^k, not
    # with the result.
    zk = np.abs(d[:, 2:3]) ** np.arange(ide.mat.shape[0])
    cond = np.tile(zk @ np.abs(ide.mat.numpy()), 2)
    err = np.abs(got - want)
    bound = 1e-6 + 1e-5 * np.abs(want) + 16 * np.finfo(np.float32).eps * cond
    assert (err <= bound).all(), float((err / bound).max())
    # Broadcasting, as the MLP calls it: per-ray directions, per-sample
    # roughness.
    per = ide(torch.from_numpy(d)[:, None, :],
              torch.from_numpy(np.stack([kappa, kappa * 2], 1)))
    assert per.shape == (64, 2) + want.shape[1:]
    torch.testing.assert_close(per[:, 0], torch.from_numpy(got))
    # The buffers live outside the state dict, on the module's device.
    assert dict(ide.state_dict()) == {}
    assert ide.mat.dtype == torch.float32


def test_ide_gradients_finite_at_the_poles_and_match_jax_elsewhere():
    d = _dirs(32, 3)
    kappa = np.random.RandomState(4).uniform(0, 1, (32, 1)).astype(
        np.float32)
    wts = np.random.RandomState(5).randn(32, ref_utils.ide_width(4)).astype(
        np.float32)
    jfn = jref.generate_ide_fn(4)
    gx, gk = jax.grad(lambda x, k: (jfn(x, k) * wts).sum(), (0, 1))(
        jnp.asarray(d), jnp.asarray(kappa))
    x = torch.from_numpy(d).requires_grad_()
    k = torch.from_numpy(kappa).requires_grad_()
    (ref_utils.generate_ide_fn(4)(x, k) * torch.from_numpy(wts)).sum(
    ).backward()
    assert bool(torch.isfinite(x.grad).all()) and bool(
        torch.isfinite(k.grad).all())
    for got, want in ((x.grad[4:], gx[4:]), (k.grad, gk)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_dir_enc_reflect_normalize_and_mae():
    d, n = _dirs(40, 1), _dirs(40, 2, poles=False)
    np.testing.assert_allclose(
        ref_utils.generate_dir_enc_fn(3)(torch.from_numpy(d)).numpy(),
        np.asarray(jref.generate_dir_enc_fn(3)(jnp.asarray(d))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        ref_utils.reflect(torch.from_numpy(d), torch.from_numpy(n)).numpy(),
        np.asarray(jref.reflect(jnp.asarray(d), jnp.asarray(n))),
        rtol=1e-5, atol=1e-6)
    x = np.concatenate([d * 3.0, np.zeros((2, 3), np.float32)])
    np.testing.assert_allclose(
        ref_utils.l2_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jref.l2_normalize(jnp.asarray(x))), rtol=1e-6, atol=0)
    w = np.random.RandomState(3).uniform(0, 1, 40).astype(np.float32)
    np.testing.assert_allclose(
        float(ref_utils.compute_weighted_mae(
            torch.from_numpy(w), torch.from_numpy(d), torch.from_numpy(n))),
        float(jref.compute_weighted_mae(jnp.asarray(w), jnp.asarray(d),
                                        jnp.asarray(n))), rtol=1e-5)


def test_orientation_and_predicted_normal_losses():
    rng = np.random.RandomState(7)
    w = rng.uniform(0, 0.2, (16, 6)).astype(np.float32)
    normals = _dirs(96, 8, poles=False).reshape(16, 6, 3)
    pred = _dirs(96, 9, poles=False).reshape(16, 6, 3)
    v = _dirs(16, 10, poles=False)
    for got, want in (
            (ref_utils.orientation_loss(*map(torch.from_numpy,
                                             (w, normals, v))),
             jref.orientation_loss(*map(jnp.asarray, (w, normals, v)))),
            (ref_utils.predicted_normal_loss(*map(torch.from_numpy,
                                                  (w, normals, pred))),
             jref.predicted_normal_loss(*map(jnp.asarray,
                                             (w, normals, pred))))):
        assert float(want) > 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_safe_exp_sin_cos_match_jax():
    x = np.array([-100.0, -1.0, 0.0, 3.0, 87.0, 88.0, 89.0, 200.0],
                 np.float32)
    # atol: below float32's smallest normal number, which XLA's CPU code
    # flushes to 0 (exp(-100)).
    np.testing.assert_allclose(mathx.safe_exp(torch.from_numpy(x)).numpy(),
                               np.asarray(jmathx.safe_exp(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-37)
    t = torch.from_numpy(x).requires_grad_()
    mathx.safe_exp(t).sum().backward()
    want = np.asarray(jax.grad(lambda a: jmathx.safe_exp(a).sum())(
        jnp.asarray(x)))
    # Beyond 88 the gradient stays exp(88), where autograd through the
    # clamp would give 0.
    assert float(t.grad[-1]) > 1e38
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6, atol=1e-37)
    big = np.array([-1e4, -400.0, -1.0, 0.5, 314.0, 315.0, 1e5], np.float32)
    for fn, jfn in ((mathx.safe_sin, jmathx.safe_sin),
                    (mathx.safe_cos, jmathx.safe_cos)):
        np.testing.assert_allclose(fn(torch.from_numpy(big)).numpy(),
                                   np.asarray(jfn(jnp.asarray(big))),
                                   rtol=1e-5, atol=1e-5)


def test_integrated_pos_enc_matches_jax():
    rng = np.random.RandomState(11)
    mean = rng.randn(5, 7, 3).astype(np.float32)
    var = rng.uniform(0, 0.1, (5, 7, 3)).astype(np.float32)
    for lo, hi in ((0, 4), (2, 6)):
        np.testing.assert_allclose(
            coord.integrated_pos_enc(torch.from_numpy(mean),
                                     torch.from_numpy(var), lo, hi).numpy(),
            np.asarray(jcoord.integrated_pos_enc(
                jnp.asarray(mean), jnp.asarray(var), lo, hi)),
            rtol=1e-5, atol=1e-5)
