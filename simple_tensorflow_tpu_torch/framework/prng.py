"""JAX's threefry PRNG, bit for bit, without JAX.

Port of the parts of ``jax/_src/prng.py`` and ``jax/_src/random.py`` (JAX
0.9.0, ``jax_threefry_partitionable=True``, 32-bit mode) that the JAX
package's dropout draws from:

- ``key(seed)``: the raw key ``[seed >> 32, seed & 0xFFFFFFFF]`` of an
  int32 seed, i.e. ``[0, seed mod 2**32]`` (``threefry_seed``);
- ``fold_in(key, data)``: ``threefry2x32(key, [0, data])``;
- ``split(key, num)``: ``threefry2x32(key, (0, i))`` for ``i < num``
  (``_threefry_split_foldlike``);
- ``random_bits(key, shape)``: ``y0 ^ y1`` of ``threefry2x32(key, (hi,
  lo))`` over the 64-bit row-major flat index of each element
  (``_threefry_random_bits_partitionable``, ``iota_2x32_shape``);
- ``uniform(key, shape)``: ``bitcast((bits >> 9) | 0x3F800000) - 1`` in
  f32; with bounds, ``max(minval, u * (maxval - minval) + minval)``
  (``_uniform``), whose multiply-add XLA contracts into one fused
  multiply-add (:func:`fma_f32_torch`);
- ``randint(key, shape, lo, hi)``: int32, two draws from ``split(key)``
  combined with JAX's multiplier-mod algorithm in wrapping uint32
  arithmetic;
- ``normal(key, shape, stddev, mean)``: ``jax.random.normal`` in f32
  (``_normal_real``): a uniform on ``(nextafter(-1, 0), 1)`` by the rule
  above, then ``f32(sqrt 2) * erf_inv(u)`` with the single-precision
  ``erf_inv`` polynomial XLA uses (M. Giles' two-branch polynomial in
  ``w = -log1p(-u * u)``; its multiply-adds fused, as XLA contracts them).
  ``torch.erfinv`` rounds differently and is not used. XLA's ``log1p`` is
  its own; the draw here agrees with JAX's to a few ulp (most values bit
  for bit);
- ``truncated_normal(key, shape, stddev, mean)``:
  ``jax.random.truncated_normal(key, -2, 2, shape, float32)`` by the same
  rules on ``(erf(-sqrt 2), erf(sqrt 2))``, clipped inside ``(-2, 2)``;
  within 3 ulp of JAX's, as ``normal``.

The host form works on numpy ``uint32`` arrays and broadcasts a batch of
keys (``(..., 2)``) against the drawn shape, so one call derives every
dropout site's key or seed of a training step. The torch form
(``threefry2x32_torch``, ``uniform_torch``) works on int64 tensors that
hold uint32 values, masked after every add and shift; it needs no
multiply. It is the plain version of the Dropout kernel
(``ops/kernels/dropout.py``).
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
INT32_MAX = 2 ** 31 - 1


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint32)


# the rotation amounts and round constants as uint32 scalars, made once
_ROT = tuple(tuple((np.uint32(r), np.uint32(32 - r)) for r in rots)
             for rots in _ROTATIONS)
_INJECT = tuple(np.uint32(i + 1) for i in range(5))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds over broadcast uint32 arrays: ``(y0,
    y1)`` (``_threefry2x32_lowering``)."""
    k0, k1, x0, x1 = (np.array(a, dtype=np.uint32) for a in
                      np.broadcast_arrays(_u32(k0), _u32(k1), _u32(x0),
                                          _u32(x1)))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    with np.errstate(over="ignore"):
        a = x0 + ks[0]
        b = x1 + ks[1]
        for i in range(5):
            for left, right in _ROT[i % 2]:
                a += b
                b = (b << left) | (b >> right)
                b ^= a
            a += ks[(i + 1) % 3]
            b += ks[(i + 2) % 3]
            b += _INJECT[i]
    return a, b


def key(seed: int) -> np.ndarray:
    """The raw threefry key of an integer seed, as ``jax.random.key``
    builds it in 32-bit mode: the seed wraps to int32, the high word is
    0."""
    return np.array([0, int(seed) & _M32], dtype=np.uint32)


def fold_in(key_, data) -> np.ndarray:
    """``jax.random.fold_in``: keys ``(..., 2)`` and uint32 data
    broadcast to keys ``(..., 2)``."""
    k = _u32(key_)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], 0, _u32(np.asarray(data)
                                                          & _M32))
    return np.stack([y0, y1], axis=-1)


def split(key_, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``(..., num, 2)``."""
    k = _u32(key_)[..., None, :]
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], 0,
                          np.arange(num, dtype=np.uint32))
    return np.stack([y0, y1], axis=-1)


def _flat_index(shape):
    """``iota_2x32_shape``: the high and low words of each element's
    row-major flat index."""
    idx = np.arange(int(np.prod(shape, dtype=np.int64)),
                    dtype=np.uint64).reshape(shape)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(_M32)).astype(np.uint32))


def random_bits(key_, shape) -> np.ndarray:
    """32 random bits per element: ``(..., *shape)`` for keys ``(...,
    2)``."""
    shape = tuple(int(s) for s in shape)
    k = _u32(key_)
    lead = k.shape[:-1]
    hi, lo = _flat_index(shape)
    pad = (slice(None),) * len(lead) + (None,) * len(shape)
    y0, y1 = threefry2x32(k[..., 0][pad], k[..., 1][pad], hi, lo)
    return (y0 ^ y1).reshape(lead + shape)


def uniform(key_, shape) -> np.ndarray:
    """f32 uniform in [0, 1) (``jax.random.uniform`` with its defaults)."""
    bits = random_bits(key_, shape)
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)


def randint(key_, shape, lo: int, hi: int) -> np.ndarray:
    """int32 draws in ``[lo, hi)`` (``jax.random.randint``) for ``lo``,
    ``hi`` within int32."""
    if not -2 ** 31 <= lo <= INT32_MAX or not -2 ** 31 <= hi <= INT32_MAX:
        raise ValueError(f"randint bounds must lie in int32: [{lo}, {hi})")
    keys = split(key_, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = np.uint32((hi - lo) & _M32 if hi > lo else 1)
    with np.errstate(over="ignore"):
        mult = np.uint32(2 ** 16) % span
        mult = (mult * mult) % span
        offset = ((higher % span) * mult + (lower % span)) % span
    return (np.int64(lo) + offset.astype(np.int64)).astype(np.int32)


# ---------------------------------------------------------------------------
# torch form (int64 tensors holding uint32 values)
# ---------------------------------------------------------------------------

def threefry2x32_torch(k0, k1, x0, x1):
    """Threefry-2x32 over int64 tensors of uint32 values and a scalar key
    of two Python ints or int64 scalar tensors: ``(y0, y1)``. Every add and shift is masked to 32
    bits, so no intermediate leaves int64's range."""
    ks = (k0 & _M32, k1 & _M32, (k0 ^ k1 ^ _PARITY) & _M32)
    a = (x0 + ks[0]) & _M32
    b = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = ((b << r) & _M32) | (b >> (32 - r))
            b = a ^ b
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def key_words_torch(key_):
    """The two words of a key given on the host (two Python ints), or of
    a ``(2,)`` int32 tensor holding their bits (two int64 scalar tensors
    of uint32 values, read on its device without a sync)."""
    if isinstance(key_, torch.Tensor):
        k = key_.to(torch.int64) & _M32
        return k[0], k[1]
    k0, k1 = (int(w) for w in _u32(key_))
    return k0, k1


def uniform_torch(key_, shape, device) -> torch.Tensor:
    """:func:`uniform` of one key (:func:`key_words_torch`) as an f32
    tensor on ``device``."""
    k0, k1 = key_words_torch(key_)
    idx = torch.arange(int(np.prod(shape, dtype=np.int64)),
                       dtype=torch.int64, device=device)
    y0, y1 = threefry2x32_torch(k0, k1, idx >> 32, idx & _M32)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32).reshape(
        tuple(shape)) - 1.0


def fma_f32_torch(a, b, c) -> torch.Tensor:
    """``a * b + c`` for f32 tensors with ONE rounding, as XLA's fused
    multiply-add computes it. The product is exact in f64; the f64 sum
    ``s`` is rounded once more, which is wrong only when ``s`` lands on an
    f32 midpoint while the exact sum does not: TwoSum's error term ``err``
    (``s + err`` is the exact sum) says on which side it lies."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - cd
    err = (p - bp) + (cd - (s - bp))
    r = s.float()
    rd = r.double()
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(s > rd, inf, -inf))
    tie = (s == (rd + other.double()) / 2) & (err != 0)
    return torch.where(tie & ((err > 0) == (other > r)), other, r)


# Giles' single-precision erf_inv coefficients, highest power first, for
# w < 5 and w >= 5 (XLA's ``ErfInv32`` and CHLO's ``erf_inv`` lowering)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv_f32_torch(x: torch.Tensor) -> torch.Tensor:
    """``erf_inv`` of f32 ``x`` in (-1, 1) by XLA's polynomial;
    ``+-1 -> +-inf`` (as ``x * FLT_MAX``)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(
            lt, torch.full((), _ERFINV_LT5[i], dtype=torch.float32,
                           device=x.device),
            torch.full((), _ERFINV_GE5[i], dtype=torch.float32,
                       device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma_f32_torch(p, w, coef(i))
    big = torch.full((), torch.finfo(torch.float32).max,
                     dtype=torch.float32, device=x.device)
    return torch.where(x.abs() == 1.0, x * big, p * x)


def normal_torch(key_, shape, device, stddev=1.0, mean=0.0) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32) * stddev + mean``
    (module docstring) as an f32 tensor on ``device``; ``key_`` as for
    :func:`uniform_torch` (a device tensor key draws without a host
    sync). As XLA compiles it: the two constant factors folded into one
    f32 product ``f32(sqrt 2) * f32(stddev)``, then one fused multiply-add
    with ``mean``."""
    u01 = uniform_torch(key_, shape, device)
    lo = torch.full((), float(np.nextafter(np.float32(-1.0),
                                           np.float32(0.0))),
                    dtype=torch.float32, device=device)
    hi = torch.ones((), dtype=torch.float32, device=device)
    u = torch.maximum(lo, fma_f32_torch(u01, hi - lo, lo))
    scale = np.float32(np.sqrt(2.0)) * np.float32(stddev)
    return fma_f32_torch(
        erf_inv_f32_torch(u),
        torch.full((), float(scale), dtype=torch.float32, device=device),
        torch.full((), float(np.float32(mean)), dtype=torch.float32,
                   device=device))


def normal(key_, shape, stddev=1.0, mean=0.0) -> np.ndarray:
    """:func:`normal_torch` of one key on the host, as an f32 array."""
    return normal_torch(key_, shape, "cpu", stddev, mean).numpy()


# erf(-2 / f32(sqrt 2)) and erf(2 / f32(sqrt 2)) in f32: the bounds of the
# uniform that jax.random.truncated_normal(key, -2, 2, ...) draws, as
# XLA's f32 erf computes them on the CPU under JAX 0.9.0 (bits 0xBF745A18
# and 0x3F745A18; also the correctly rounded values of erf(-+sqrt 2)).
TRUNC_ERF_LO = float(np.float32(-0.9544997))
TRUNC_ERF_HI = float(np.float32(0.9544997))
# the clip to the open interval (-2, 2): nextafter(-+2) towards 0 in f32
TRUNC_LO = float(np.nextafter(np.float32(-2.0), np.float32(np.inf)))
TRUNC_HI = float(np.nextafter(np.float32(2.0), np.float32(-np.inf)))


def truncated_normal_torch(key_, shape, device, stddev=1.0,
                           mean=0.0) -> torch.Tensor:
    """``jax.random.truncated_normal(key, -2, 2, shape, float32) * stddev +
    mean`` (``_truncated_normal`` of JAX 0.9.0) as an f32 tensor on
    ``device``: a uniform on ``(erf(-sqrt 2), erf(sqrt 2))`` by the rule of
    :func:`uniform` (one fused multiply-add), ``f32(sqrt 2) * erf_inv(u)``
    rounded, clipped to ``(nextafter(-2, inf), nextafter(2, -inf))``, then
    one fused multiply-add with ``stddev`` and ``mean`` (the clip keeps XLA
    from folding ``sqrt 2 * stddev`` as :func:`normal_torch` does)."""
    def f32(v):
        return torch.full((), float(np.float32(v)), dtype=torch.float32,
                          device=device)

    u01 = uniform_torch(key_, shape, device)
    lo, hi = f32(TRUNC_ERF_LO), f32(TRUNC_ERF_HI)
    u = torch.maximum(lo, fma_f32_torch(u01, hi - lo, lo))
    x = f32(np.sqrt(2.0)) * erf_inv_f32_torch(u)
    x = torch.minimum(torch.maximum(x, f32(TRUNC_LO)), f32(TRUNC_HI))
    return fma_f32_torch(x, f32(stddev), f32(mean))


def truncated_normal(key_, shape, stddev=1.0, mean=0.0) -> np.ndarray:
    """:func:`truncated_normal_torch` of one key on the host, as an f32
    array."""
    return truncated_normal_torch(key_, shape, "cpu", stddev, mean).numpy()
