"""``jax.random``'s key operations and draws on raw Threefry-2x32 keys, in
PyTorch (the subset the JAX package's Brownian paths use).

A key is the raw key data of a JAX ``PRNGKey``: two uint32 words, held here
as an int64 tensor of shape (..., 2); leading axes are independent keys, so
one call serves a batch of lanes. A JAX key (``np.asarray(key)``, uint32
(2,)) passes to the port unchanged, and both packages then draw the same
numbers:

- ``fold_in(key, d)`` and ``split(key, n)`` are one Threefry-2x32 hash of
  the counter pair (0, d) or (0, i) (JAX's ``jax_threefry_partitionable``
  layout, its default since 0.5: a 64-bit iota split into a high and a low
  word, and ``split`` folds like ``fold_in``);
- ``random_bits(key, shape)`` hashes the counters (0, i) of the flattened
  shape and returns the xor of the two output words;
- ``uniform`` sets the top 23 bits as the mantissa of a float32 in [1, 2),
  subtracts 1 and scales to [minval, maxval), as ``jax.random.uniform``;
- ``normal`` is sqrt(2) * erf_inv(u) for u uniform on (-1, 1) (its lower
  end one float32 ulp above -1), with ``erf_inv`` XLA's float32 polynomial
  (Giles), not ``torch.erfinv``'s.

Every operation runs in float32 in the order the JAX package's XLA program
rounds it; ``log1p`` and ``sqrt`` are the device's, so a normal agrees with
``jax.random.normal`` to an ulp or two.
"""

from __future__ import annotations

import math

import torch

from columnflow_torch.solvers.krng import threefry2x32

_M32 = 0xFFFFFFFF
# The lower end of normal's uniform draw: nextafter(-1, 0) in float32.
_NORMAL_LO = -0.99999994039535522461
_SQRT2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))

# XLA's ErfInv for float32 (M. Giles, "Approximating the erfinv function"),
# evaluated by Horner's rule from the first coefficient.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _words(key):
    key = torch.as_tensor(key, dtype=torch.int64)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is (..., 2) uint32 words, got shape {tuple(key.shape)}")
    return key & _M32


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s key data: the high and low words of
    the seed as a 64-bit integer (a 32-bit seed, as JAX without x64 takes
    it, has high word 0)."""
    seed = int(seed)
    if -(1 << 31) <= seed < (1 << 31):
        hi = 0
    else:
        hi = (seed >> 32) & _M32
    return torch.tensor([hi, seed & _M32], dtype=torch.int64, device=device)


def _hash(key, c0, c1):
    """Threefry-2x32 of the counter pair (c0, c1) under each key: the two
    output words stacked on a last axis."""
    key = _words(key)
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], c0, c1)
    return torch.stack([o0, o1], dim=-1)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``: a key per ``data`` (an int or an integer
    tensor broadcasting against the key's leading axes; negative values
    wrap to uint32 as JAX's cast does)."""
    key = _words(key)
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    return _hash(key, 0, data)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., num, 2) keys."""
    key = _words(key)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    return _hash(key[..., None, :], 0, i)


def random_bits(key, shape=()) -> torch.Tensor:
    """``jax.random.bits`` (uint32) for each key: (*key leading axes,
    *shape) uint32 values in int64."""
    key = _words(key)
    shape = tuple(shape)
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    o = _hash(key.reshape(lead + (1,) * 1 + (2,)), 0, i)
    return (o[..., 0] ^ o[..., 1]).reshape(lead + shape)


def _bits_to_unit(bits):
    """uint32 bits -> float32 in [0, 1): the top 23 bits as the mantissa of
    a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, shape=(), minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (float32) for each key."""
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    span = float(hi - lo)
    lo = float(lo)
    floats = _bits_to_unit(random_bits(key, shape))
    return torch.clamp_min(floats * span + lo, lo)


def erf_inv(x) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: w = -log1p(-x^2); a degree-8 polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3 (otherwise); times x; +-inf at +-1."""
    x = torch.as_tensor(x, dtype=torch.float32)
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, c_lt, c_ge) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key, shape=()) -> torch.Tensor:
    """``jax.random.normal`` (float32) for each key."""
    return _SQRT2 * erf_inv(uniform(key, shape, _NORMAL_LO, 1.0))


def float_bits(t) -> torch.Tensor:
    """The bit pattern of float32 times as int64 (``lax.bitcast_convert_type``
    to int32, then the uint32 cast of ``fold_in``)."""
    t = torch.as_tensor(t, dtype=torch.float32)
    return t.contiguous().view(torch.int32).to(torch.int64) & _M32
