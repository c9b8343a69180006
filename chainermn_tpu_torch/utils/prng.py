"""Counter-keyed randomness in torch integer ops: the port's own copy of
the threefry2x32 draws that the JAX package's sampling uses from
``jax.random`` (``PRNGKey``, ``fold_in``, the random bits, ``uniform``,
``gumbel`` and ``categorical``), bit for bit as jax 0.9 computes them with
``jax_threefry_partitionable`` on and 64-bit types off.

A key is its data: a ``[..., 2]`` int64 tensor holding two unsigned 32-bit
words. There is no ``torch.Generator`` and no hidden state, so a key is a
pure function of the seeds folded into it and runs on any device. torch
has little uint32 arithmetic on CUDA, so every word lives in int64 and is
masked back to 32 bits after each add, shift and rotate.

Layout, as in ``jax/_src/prng.py`` and ``jax/_src/random.py``:

- ``PRNGKey(seed)``: ``[seed >> 32, seed & 0xFFFFFFFF]`` of the seed as a
  32-bit integer, which leaves ``[0, seed mod 2**32]``;
- ``fold_in(key, d)``: threefry2x32 of the counter pair ``(0, d)``;
- the bits of shape ``S``: threefry2x32 of the 64-bit iota over ``S``
  split into its high and low words, the two output words XORed;
- ``uniform``: the top mantissa bits under the exponent of 1.0, minus
  1.0, scaled into ``[minval, maxval)`` by one multiply-add and clamped
  below at ``minval`` (bf16 draws 8 bits and keeps their top 7);
- ``split(key, num)``: threefry2x32 of the 64-bit iota over ``num``
  split into its high and low words, the two output words a new key;
- ``normal``: ``sqrt(2) * erfinv(u)`` with ``u`` uniform over
  ``(-1, 1)``, ``erfinv`` by XLA's single-precision polynomial (Giles);
  rounded in another order, so a few ulps from jax's, not bit for bit;
- ``gumbel``: ``-log(-log(u))`` with ``u`` uniform over ``[tiny, 1)``;
- ``categorical``: ``argmax(gumbel + logits)`` over the last axis.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x):
    return x & _MASK


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the word pairs ``(x1, x2)``
    under the key ``(k1, k2)``: int64 tensors of 32-bit words that
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = _u32(x1 + ks[0])
    x2 = _u32(x2 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = _u32(x1 + x2)
            x2 = _rotl(x2, r) ^ x1
        x1 = _u32(x1 + ks[(i + 1) % 3])
        x2 = _u32(x2 + ks[(i + 2) % 3] + i + 1)
    return x1, x2


def _as_key(key, device=None):
    if not isinstance(key, torch.Tensor):  # key words: uint32 array, list
        key = torch.from_numpy(np.asarray(key).astype(np.int64))
    key = key.to(device) if device is not None else key
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is [..., 2] words, got {tuple(key.shape)}")
    return key.to(torch.int64) & _MASK


def PRNGKey(seed: int, device=None):
    """The key of an integer seed: ``[0, seed mod 2**32]`` (jax's
    ``PRNGKey`` with 64-bit types off, where the seed is first taken as a
    32-bit integer)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key, data):
    """A new key from ``key`` and 32-bit ``data`` (an int or an integer
    tensor, taken modulo 2**32): the hash of the counter pair ``(0,
    data)``. ``key`` ``[..., 2]`` and ``data`` broadcast, so one call
    folds a row of data into a row of keys."""
    key = _as_key(key)
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y1, y2], dim=-1)


def split(key, num: int = 2):
    """``num`` new keys from ``key`` ``[2]``: ``[num, 2]`` (jax's
    ``random.split`` with ``jax_threefry_partitionable`` on)."""
    key = _as_key(key)
    iota = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[0], key[1], iota >> 32, _u32(iota))
    return torch.stack([y1, y2], dim=-1)


def random_bits(key, shape):
    """32 random bits per entry of ``shape`` for each key of ``key``
    ``[..., 2]``: ``[..., *shape]`` int64 words. The counters are the
    64-bit iota over ``shape`` (its high and low words), hashed under the
    key; the entry is the XOR of the two output words."""
    key = _as_key(key)
    n = 1
    for s in shape:
        n *= int(s)
    iota = torch.arange(n, dtype=torch.int64, device=key.device)
    hi, lo = (iota >> 32).reshape(shape), _u32(iota).reshape(shape)
    lead = key.shape[:-1]
    view = lead + (1,) * len(shape)
    y1, y2 = threefry2x32(key[..., 0].reshape(view),
                          key[..., 1].reshape(view), hi, lo)
    return y1 ^ y2


_FLOATS = {torch.float32: (32, 23), torch.bfloat16: (16, 7)}


def uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0):
    """Uniform draws in ``[minval, maxval)`` of ``dtype`` (float32 or
    bfloat16), ``[..., *shape]`` for a key of ``[..., 2]``: the
    ``nbits - nmant`` top bits of each draw dropped below the exponent of
    1.0, minus 1.0."""
    if dtype not in _FLOATS:
        raise TypeError(f"uniform takes float32 or bfloat16, got {dtype}")
    nbits, nmant = _FLOATS[dtype]
    bits = random_bits(key, shape)
    rng_bits = 8 if nmant < 8 else nbits
    bits = bits & ((1 << rng_bits) - 1)  # the low rng_bits of the draw
    one = 0x3F800000 if nbits == 32 else 0x3F80
    fbits = (bits >> (rng_bits - nmant)) | one
    if nbits == 32:  # the sign bit is clear: the words fit int32/int16
        floats = fbits.to(torch.int32).view(torch.float32)
    else:
        floats = fbits.to(torch.int16).view(torch.bfloat16)
    floats = floats - torch.ones((), dtype=dtype, device=floats.device)
    lo = torch.tensor(minval, dtype=dtype, device=floats.device)
    hi = torch.tensor(maxval, dtype=dtype, device=floats.device)
    # XLA fuses the scale and shift into one multiply-add (one rounding):
    # the product is exact in float64, so the sum rounds once there
    span = (hi - lo).double()
    scaled = (floats.double() * span + lo.double()).to(dtype)
    return torch.maximum(lo, scaled)


#: XLA's ``ErfInv`` for float32 (M. Giles' approximation): the
#: polynomial in ``w - 2.5`` where ``w = -log1p(-x * x) < 5``, else in
#: ``sqrt(w) - 3``
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x):
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = torch.where(small, a, b) + p * w
    return p * x


def normal(key, shape, dtype=torch.float32):
    """Standard normal float32 draws: ``sqrt(2) * erfinv(u)``, ``u``
    uniform over ``[nextafter(-1, 0), 1)`` (jax's ``random.normal``)."""
    if dtype != torch.float32:
        raise TypeError(f"normal takes float32, got {dtype}")
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, dtype, minval=lo, maxval=1.0)
    return _erfinv32(u) * torch.tensor(np.sqrt(2.0), dtype=dtype)


def gumbel(key, shape, dtype=torch.float32):
    """Gumbel draws ``-log(-log(u))``, ``u`` uniform over ``[tiny, 1)``
    (jax's ``mode='low'``, its default)."""
    tiny = torch.finfo(dtype).tiny
    u = uniform(key, shape, dtype, minval=tiny, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key, logits):
    """One draw per row of ``logits`` ``[..., V]`` under its key ``[...,
    2]``: ``argmax(gumbel + logits)`` (the first index on a tie), the
    Gumbel noise in the logits' dtype. Returns int64 ``[...]``."""
    g = gumbel(key, (logits.shape[-1],), logits.dtype)
    return torch.argmax(g + logits, dim=-1)


__all__ = ["PRNGKey", "categorical", "fold_in", "gumbel", "normal",
           "random_bits", "split", "threefry2x32", "uniform"]
