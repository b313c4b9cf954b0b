"""The JAX package's random draws, reproduced bit for bit in torch.

The JAX package derives every draw from threefry2x32 keys: the initial
parameters from PRNGKey(seed), a training step's ray jitter and the
sparsity prior's points from fold_in(PRNGKey(seed + 1), step), a grid
refresh's draws from PRNGKey(step). This module is that PRNG (jax.random
with its default threefry2x32 implementation and partitionable bits).
Keys are (k1, k2) pairs of uint32 values held as Python ints, and
`split` / `fold_in` hash them in plain Python. A draw is hashed on the
host in numpy uint32 arithmetic when no device is given (a training
step's draws, copied to the card with its batch), and on the given
device in int64 torch arithmetic masked to 32 bits otherwise (the draws
of millions of values: a grid refresh's, the initial tables).
`uniform` / `randint` give the same bits as jax.random's for the same
key and shape either way. So one seed gives
the port the reference's draws, and the same training trajectory up to
float rounding.

`normal` draws jax.random.normal's uniforms but maps them through
torch.erfinv, whose float32 rounding may differ from XLA's in the last
bit (its only user, the appearance embedding, is not ported yet).
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# (rotation set, key word added to x0, key word added to x1) of the five
# four-round blocks; x1 also gets the block's index
_SCHEDULE = ((0, 1, 2), (1, 2, 0), (0, 0, 1), (1, 1, 2), (0, 2, 0))


def _rotl(x, d: int):
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the count words x0, x1 under key
    (k1, k2): Python ints, numpy uint32 arrays or int64 torch tensors of
    uint32 values."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i, (rot, a, b) in enumerate(_SCHEDULE, 1):
        for r in _ROTATIONS[rot]:
            x0 = (x0 + x1) & _MASK
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[a]) & _MASK
        x1 = (x1 + ks[b] + i) & _MASK
    return x0, x1


def prng_key(seed: int):
    """jax.random.PRNGKey(seed) for a seed below 2^32."""
    return (0, seed & _MASK)


def split(key, num: int = 2):
    """jax.random.split(key, num) as a list of keys."""
    return [threefry2x32(key, 0, i) for i in range(num)]


def fold_in(key, data: int):
    """jax.random.fold_in(key, data)."""
    return threefry2x32(key, 0, data & _MASK)


def _bits(key, n: int, device):
    """jax.random.bits(key, (n,)): for device None a numpy uint32 array,
    else an int64 tensor of uint32 values on the device."""
    if device is None:
        i = np.arange(n, dtype=np.uint32)
        b1, b2 = threefry2x32(key, np.zeros_like(i), i)
    else:
        i = torch.arange(n, dtype=torch.int64, device=device)
        b1, b2 = threefry2x32(key, i >> 32, i & _MASK)
    return b1 ^ b2


def random_bits(key, shape, device=None):
    """jax.random.bits(key, shape) (uint32 values in an int64 tensor)."""
    bits = _bits(key, math.prod(shape), device)
    if isinstance(bits, np.ndarray):
        bits = torch.from_numpy(bits.astype(np.int64))
    return bits.reshape(shape)


def uniform(key, shape, minval=0.0, maxval=1.0, device=None):
    """jax.random.uniform(key, shape, float32, minval, maxval): the top 23
    bits as the mantissa of a float in [1, 2), less 1, then
    f * (maxval - minval) + minval rounded once (as XLA's CPU code
    contracts it into a fused multiply-add; f64 holds the product
    exactly), floored at minval. A CPU tensor for device None."""
    bits = _bits(key, math.prod(shape), device)
    if isinstance(bits, np.ndarray):
        f = ((bits >> 9) | 0x3F800000).view(np.float32) - np.float32(1)
        lo, hi = np.float32(minval), np.float32(maxval)
        out = (f.astype(np.float64) * np.float64(hi - lo)
               + np.float64(lo)).astype(np.float32)
        return torch.from_numpy(np.maximum(out, lo).reshape(shape))
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) \
        - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    out = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(out, lo).reshape(shape)


def randint(key, shape, minval: int, maxval: int, device=None):
    """jax.random.randint(key, shape, minval, maxval, int32), for a span
    maxval - minval below 2^31: two words of bits folded into [minval,
    maxval) by the span's modulus, in uint32 arithmetic."""
    k1, k2 = split(key)
    n = math.prod(shape)
    hi_bits, lo_bits = _bits(k1, n, device), _bits(k2, n, device)
    span = (maxval - minval) & _MASK
    mult = ((2 ** 16 % span) ** 2 & _MASK) % span
    off = (((hi_bits % span) * mult + lo_bits % span) & _MASK) % span
    if isinstance(off, np.ndarray):
        off = torch.from_numpy(off.astype(np.int64))
    return (minval + off).to(torch.int32).reshape(shape)


def normal(key, shape, device=None):
    """jax.random.normal's construction, sqrt(2) erfinv(u) with u uniform
    in (-1, 1), through torch.erfinv (see the module note)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return math.sqrt(2.0) * torch.erfinv(u)
