"""JAX's default random numbers in numpy: threefry2x32 under the scheme
`jax_threefry_partitionable=True` (the default of jax 0.9.0), for the few
draws the port must reproduce bit for bit without JAX: the fixed Fourier
frequency matrix of the spectral fields (`ops/fourier.py`), which the JAX
package draws from `PRNGKey(7)` at every init and never stores.

Covers `PRNGKey` (32-bit seeds), `split`, `uniform` and `normal` in
float32. A key is a uint32 array of shape [2]. Under the partitionable
scheme the i-th output (in row-major order) of a draw of any shape hashes
the 64-bit counter i, split into (hi, lo) words, with the key; `split`
takes the two words of each hash as a new key, the 32-bit draws their XOR.

`normal` is sqrt(2) * erfinv(u) for u uniform on [nextafter(-1, 0), 1), and
erfinv is XLA's float32 polynomial (Giles' approximation, as XLA's
`ErfInv` lowers it, over XLA's Cephes log1p), not `scipy.special.erfinv`.
Each float32 step is rounded as XLA's CPU code rounds it (fused
multiply-adds where XLA fuses). `tests/test_torch_fourier.py` holds the
draws and the frequency matrices against `jax.random`.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

# XLA's float32 ErfInv coefficients (w < 5 and w >= 5 branches).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block cipher (20 rounds) of counter words (x0, x1)
    under `key`, elementwise: two uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (JAX's name)
    """`jax.random.PRNGKey(seed)` for a seed that fits 32 bits."""
    if not -2**31 <= seed < 2**32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _counters(shape):
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)).astype(np.uint32).reshape(shape),
            (i & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)`: [num, 2] uint32 keys."""
    b0, b1 = threefry2x32(key, *_counters((num,)))
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits per entry of `shape` (uint32)."""
    b0, b1 = threefry2x32(key, *_counters(tuple(shape)))
    return b0 ^ b1


def _fma(a, b, c) -> np.ndarray:
    """float32 fused multiply-add: a * b is exact in float64, one rounding
    to float32 after the add (a float64 rounding of the sum in between can
    differ from the fused result only in the rare double-rounding case)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def uniform(key: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    f32 = np.float32
    lo, hi = f32(minval), f32(maxval)
    bits = random_bits(key, shape)
    one = np.array(1.0, f32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(f32) - f32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


# Cephes' logf polynomial, as XLA's CPU backend evaluates log in float32.
_LOG_P = tuple(np.float32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
# Cephes' log1p rational approximation for |x| < sqrt(2) - 1 (highest
# degree first), as XLA's elemental emitter evaluates it in float32.
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log_f32(v: np.ndarray) -> np.ndarray:
    """XLA's float32 log on the CPU for positive normal v (Cephes logf:
    v = m 2^e, m in [sqrt(1/2), sqrt(2)), a polynomial in m - 1)."""
    f32 = np.float32
    m, e = np.frexp(np.asarray(v, f32))
    x, e = m.astype(f32), e.astype(f32)
    small = x < f32(0.707106781186547524)
    e = e - small.astype(f32)
    x = (x - f32(1.0)) + np.where(small, x, f32(0.0))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y, y1, y2 = _fma(x, p[0], p[1]), _fma(x, p[3], p[4]), _fma(x, p[6], p[7])
    y, y1, y2 = _fma(y, x, p[2]), _fma(y1, x, p[5]), _fma(y2, x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2) * x3
    y = _fma(f32(-2.12194440e-4), e, y)
    x = _fma(x2, f32(-0.5), x) + y
    return _fma(f32(0.693359375), e, x)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 log1p: the Cephes rational for |x| < sqrt(2) - 1,
    else log(1 + x)."""
    f32 = np.float32
    x = np.asarray(x, f32)
    num = np.zeros_like(x)
    den = np.zeros_like(x)
    for a, b in zip(_LOG1P_NUM, _LOG1P_DEN):
        num = _fma(num, x, f32(a))
        den = _fma(den, x, f32(b))
    x2 = x * x
    small = _fma(f32(-0.5), x2, (x * x2) * (num / den)) + x
    with np.errstate(divide="ignore", invalid="ignore"):
        large = _log_f32(np.maximum(x + f32(1.0), np.finfo(f32).tiny))
    return np.where(np.abs(x) < f32(0.41421356237309504880), small, large)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv: w = -log1p(-x^2); a degree-8 polynomial (fused
    multiply-adds) in w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at
    +-1."""
    f32 = np.float32
    x = np.asarray(x, f32)
    w = -_log1p_f32(x * -x)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(np.maximum(w, f32(0.0)))
                 - f32(3.0)).astype(f32)
    coef = lambda i: np.where(lt, f32(_ERFINV_LT5[i]), f32(_ERFINV_GE5[i]))
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coef(i))
    with np.errstate(invalid="ignore"):
        edge = x * f32(np.inf)
    return np.where(np.abs(x) == f32(1.0), edge, p * x).astype(f32)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """`jax.random.normal(key, shape)` in float32."""
    f32 = np.float32
    lo = np.nextafter(f32(-1.0), f32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (f32(np.sqrt(2)) * erfinv_f32(u)).astype(f32)
