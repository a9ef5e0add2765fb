"""The spectral encoder's pieces against the JAX package: the port's
threefry2x32 (`utils/jax_prng.py`) against `jax.random`, the Fourier
frequency matrix of every preset against `nerf_lidar_tpu.ops.fourier`, and
`fourier_encode` / `fourier_encode_pooled` with their gradients.

- Keys, splits, bits, uniform and normal draws: bit for bit (the normal
  draws at F in {96, 256, 512}, the presets' widths).
- erfinv: XLA's float32 polynomial over XLA's Cephes log1p; 12 of 320,003
  inputs differ by up to 2 ulps (where the emulated Cephes logf misses
  XLA's by one ulp), none at the presets' draws.
- The frequency matrix is held against the JAX one as the JAX package
  computes it in training and rendering, inside a jitted function (the
  eager call rounds linspace and exp otherwise, up to 17 ulps away from
  the jitted one): equal for (96, 48, 2048) and (96, 32, 1024); 3 entries
  1 ulp apart for (96, 48, 512), 12 for (256, 48, 8192) and 15 entries up
  to 15 ulps for (512, 48, 8192), where XLA vectorises the magnitudes'
  loop. What that does to the features: the phase 2 pi x.f moves by at
  most 2 pi |df| (4e-2 rad on the 0.3% of the speed field's frequencies
  that differ, 0 on the others; the float32 phases themselves round to
  1e-2 rad there) and the IPE damping of those bands at a sample's std is
  exp(-2 pi^2 sigma^2 |f|^2) (below 1e-15 for sigma >= 1e-3 at |f| >=
  4096): held here at stds 0 (the bound) and at stds 1e-3.
- `fourier_encode(_pooled)`: float64 on both sides rtol 1e-10; float32
  atol 8 x float32 eps x the largest phase (the phases' rounding), and the
  gradients (x01, stds) against `jax.vjp` at the same scale times the
  largest frequency.
- The reference's own hazard, the reason the port cannot simply store
  nothing: with `jax_threefry_partitionable=False` the JAX package draws
  a different matrix (entries up to 752.3 apart at F = 96); the port
  reproduces jax 0.9.0's default, True.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import configs
from nerf_lidar_tpu.ops import fourier as jfourier
from nerf_lidar_tpu.ops import grid as jgrid
from nerf_lidar_tpu_torch.ops import fourier
from nerf_lidar_tpu_torch.utils import jax_prng

SEEDS = (0, 7, 123456, 2**31 - 1)


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


def _preset_triples():
    """{(F, lo, hi)} of every spectral grid of the presets: (fourier_freqs,
    the dense band's top resolution, the grid's desired resolution)."""
    out = set()
    speed = configs.nuscenes_single_speed()
    for cfg in (configs.nuscenes_single_mxu(), speed,
                configs.spectral_obj_variant(speed)):
        m = cfg.model
        mlps = [m.nerf_mlp, m.obj_mlp] + [
            m.prop_mlp_for_level(i) for i in range(len(m.num_prop_samples))]
        for mlp in mlps:
            g = mlp.grid
            if g.encoder == "dense_fourier":
                out.add((g.fourier_freqs,
                         float(jgrid.spec_for(g).desired_resolution),
                         float(g.desired_resolution)))
    return sorted(out)


# (F, lo, hi) -> (entries that differ from the jitted JAX matrix, their
# largest distance in ulps), as measured.
MATRIX_ULPS = {(96, 32.0, 1024.0): (0, 0), (96, 48.0, 512.0): (3, 1),
               (96, 48.0, 2048.0): (0, 0), (256, 48.0, 8192.0): (12, 1),
               (512, 48.0, 8192.0): (15, 15)}


def test_preset_triples():
    assert _preset_triples() == sorted(MATRIX_ULPS)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_splits_and_bits_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(jax_prng.PRNGKey(seed),
                                  np.asarray(jax.random.key_data(key)))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(
            jax_prng.split(jax_prng.PRNGKey(seed), num),
            np.asarray(jax.random.key_data(jax.random.split(key, num))))
    sub = jax.random.split(key)[1]
    psub = jax_prng.split(jax_prng.PRNGKey(seed))[1]
    np.testing.assert_array_equal(
        jax_prng.random_bits(psub, (4, 33)),
        np.asarray(jax.random.bits(sub, (4, 33), jnp.uint32)))
    np.testing.assert_array_equal(
        jax_prng.uniform(psub, (7, 5), -2.0, 3.0),
        np.asarray(jax.random.uniform(sub, (7, 5), jnp.float32, -2.0, 3.0)))


@pytest.mark.parametrize("f", [96, 256, 512])
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax_bit_for_bit(seed, f):
    key = jax.random.split(jax.random.PRNGKey(seed))[0]
    got = jax_prng.normal(jax_prng.split(jax_prng.PRNGKey(seed))[0], (3, f))
    want = np.asarray(jax.jit(lambda k: jax.random.normal(k, (3, f)))(key))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_erfinv_is_xlas():
    rng = np.random.RandomState(0)
    u = np.concatenate([rng.uniform(-1, 1, 300_000),
                        rng.uniform(0.999, 1, 20_000),
                        [-1.0, 1.0, 0.0]]).astype(np.float32)
    got = jax_prng.erfinv_f32(u)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(u)))
    d = _ulps(got, want)
    assert (d > 0).sum() <= 12 and d.max() <= 2
    assert np.isinf(got[-3:-1]).all() and got[-1] == 0


@pytest.mark.parametrize("triple", sorted(MATRIX_ULPS))
def test_frequency_matrix_matches_jitted_jax(triple):
    f, lo, hi = triple
    got = fourier.make_frequency_matrix(7, f, lo, hi)
    want = np.asarray(jax.jit(
        lambda: jfourier.make_frequency_matrix(7, f, lo, hi))())
    assert got.shape == want.shape == (3, f) and got.dtype == np.float32
    d = _ulps(got, want)
    assert ((d > 0).sum(), d.max()) == MATRIX_ULPS[triple]
    # The directions are the JAX draws, bit for bit.
    k1 = jax_prng.split(jax_prng.PRNGKey(7))[0]
    np.testing.assert_array_equal(
        jax_prng.normal(k1, (3, f)),
        np.asarray(jax.random.normal(
            jax.random.split(jax.random.PRNGKey(7))[0], (3, f))))
    # What the differing entries do to the features: at stds 0 the phase
    # moves by 2 pi |df| |x| (the bound, beside the float32 rounding of
    # the phases themselves), at stds 1e-3 those bands are damped to
    # nothing.
    rng = np.random.RandomState(1)
    x01 = rng.uniform(0, 1, (256, 1, 3)).astype(np.float32)
    reach = 2 * np.pi * np.sqrt(3)
    bound = reach * (float(np.abs(got - want).max())
                     + 4 * np.finfo(np.float32).eps * float(hi)) + 1e-6
    for std, tol in ((0.0, bound), (1e-3, 1e-3)):
        stds = np.full((256, 1), std, np.float32)
        feats = [fourier.fourier_encode_pooled(
            torch.from_numpy(x01), torch.from_numpy(stds),
            torch.from_numpy(m)).numpy() for m in (got, want)]
        assert np.abs(feats[0] - feats[1]).max() <= tol, (std, tol)


def test_partitionable_flag_moves_the_jax_matrix():
    """The frequency matrix is not in the JAX package's checkpoints, and
    jax_threefry_partitionable changes it; the port reproduces True."""
    want = fourier.make_frequency_matrix(7, 96, 48.0, 512.0)
    old = jax.config.jax_threefry_partitionable
    try:
        jax.config.update("jax_threefry_partitionable", False)
        other = np.asarray(jax.jit(
            lambda: jfourier.make_frequency_matrix(7, 96, 48.0, 512.0))())
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    assert old is True
    np.testing.assert_allclose(np.abs(other - want).max(), 752.3217,
                               rtol=1e-4)


def _encode_inputs(dtype, seed=2):
    rng = np.random.RandomState(seed)
    # A multisample cloud per frustum (spread ~1e-3, as cast_rays makes
    # them): the pooled Gaussian then keeps the low bands undamped.
    x01 = (rng.uniform(0.1, 0.9, (40, 1, 3))
           + rng.normal(0, 1e-3, (40, 5, 3))).astype(dtype)
    stds = rng.uniform(1e-4, 3e-3, (40, 5)).astype(dtype)
    freqs = fourier.make_frequency_matrix(7, 96, 48.0, 512.0).astype(dtype)
    g = rng.randn(40, 192).astype(dtype)
    return x01, stds, freqs, g


@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fourier_encode_and_gradients_match_jax(pooled, dtype):
    x01, stds, freqs, g = _encode_inputs(dtype)
    jfn = (jfourier.fourier_encode_pooled if pooled
           else jfourier.fourier_encode)
    tfn = fourier.fourier_encode_pooled if pooled else fourier.fourier_encode
    with jax.enable_x64(dtype == np.float64):
        want, vjp = jax.vjp(lambda x, s: jfn(x, s, jnp.asarray(freqs)),
                            jnp.asarray(x01), jnp.asarray(stds))
        want_dx, want_ds = (np.asarray(a) for a in vjp(jnp.asarray(g)))
        want = np.asarray(want)
    x, s = (torch.from_numpy(a).requires_grad_(True) for a in (x01, stds))
    got = tfn(x, s, torch.from_numpy(freqs))
    got.backward(torch.from_numpy(g))
    assert got.dtype == torch.from_numpy(x01).dtype
    if dtype == np.float64:
        tol = dict(rtol=1e-10, atol=1e-12)
        gtol = tol
    else:
        phase = 2 * np.pi * np.sqrt(3) * float(np.abs(freqs).max())
        tol = dict(rtol=0, atol=8 * np.finfo(np.float32).eps * phase)
        gtol = dict(rtol=0, atol=tol["atol"] * phase * np.abs(g).max())
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)
    np.testing.assert_allclose(x.grad.numpy(), want_dx, **gtol)
    np.testing.assert_allclose(s.grad.numpy(), want_ds, **gtol)
    assert np.abs(want_dx).max() > 0 and np.abs(want_ds).max() > 0
