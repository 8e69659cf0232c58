"""Counter-based random bits that equal `jax.random`'s (threefry2x32).

The reference draws CQ's stochastic-rounding noise from `jax.random` with
`jax_threefry_partitionable=True` (its default), keyed by a pure function
of (seed 17, step, leaf index) (`repro/launch/train.py`,
`repro/optim/momentum.py`).  This module reproduces `PRNGKey`, `fold_in`
and float32 `uniform` bit for bit, so the port's training trajectory can be
held against the reference's; a `torch.Generator` would draw other bits.

A key is a pair of Python ints (k0, k1), each a uint32.  The hash runs on
int32 tensors holding the uint32 bit patterns: additions wrap modulo 2^32
as uint32 additions do, xor and left shifts act on the bits alike, and a
logical right shift is an arithmetic one masked to the kept bits
(PyTorch's uint32 has no shifts or xor on CUDA).  With partitionable
bits, element i of a draw depends only on the key and its flat index i, so
`uniform_flat` generates any slice of the flat index range on its own (the
optimizer draws a large leaf in chunks).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _s32(v: int) -> int:
    """The int32 with the bit pattern of uint32 v."""
    v &= _M32
    return v - (1 << 32) if v >= 1 << 31 else v


def _rotl(x: Tensor, r: int) -> Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def threefry2x32(key: tuple[int, int], x0: Tensor, x1: Tensor):
    """The Threefry-2x32 hash (20 rounds) of the count pair (x0, x1),
    int32 tensors holding uint32 bit patterns.  Returns the hashed pair."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = x0 + _s32(ks[0])
    x1 = x1 + _s32(ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + _s32(ks[(i + 1) % 3])
        x1 = x1 + _s32(ks[(i + 2) % 3] + i + 1)
    return x0, x1


def _hash_scalars(key, a: int, b: int) -> tuple[int, int]:
    t = torch.tensor([_s32(a), _s32(b)], dtype=torch.int32)
    y0, y1 = threefry2x32(key, t[:1], t[1:])
    return int(y0[0]) & _M32, int(y1[0]) & _M32


def prng_key(seed: int) -> tuple[int, int]:
    """jax.random.PRNGKey(seed): the 64-bit seed as (hi, lo) words."""
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """jax.random.fold_in(key, data) for a uint32 `data`."""
    return _hash_scalars(key, 0, int(data) & _M32)


def uniform_flat(key: tuple[int, int], start: int, count: int,
                 device="cpu") -> Tensor:
    """Elements [start, start + count) of the flattened float32
    `jax.random.uniform(key, shape)` for any shape holding them: 32 bits
    per element (hi ^ lo of the hashed 64-bit index), the top 23 as the
    mantissa of a float in [1, 2), minus 1."""
    idx = torch.arange(start, start + count, dtype=torch.int64,
                       device=device)
    hi = (idx >> 32).to(torch.int32)
    lo = (idx & _M32).to(torch.int32)          # two's-complement wrap
    y0, y1 = threefry2x32(key, hi, lo)
    bits = (((y0 ^ y1) >> 9) & 0x7FFFFF) | 0x3F800000
    return bits.view(torch.float32) - 1.0


def uniform(key: tuple[int, int], shape, device="cpu") -> Tensor:
    """jax.random.uniform(key, shape, float32) in [0, 1)."""
    n = 1
    for s in shape:
        n *= int(s)
    return uniform_flat(key, 0, n, device).reshape(tuple(shape))


def gumbel(key: tuple[int, int], shape, device="cpu") -> Tensor:
    """jax.random.gumbel(key, shape, float32) (its default mode, which
    `jax.random.categorical` draws): -log(-log(u)) of the uniform u on
    [tiny, 1), u = max(tiny, f * (1 - tiny) + tiny) for the uniform bits'
    float f, as `jax.random.uniform(minval=tiny, maxval=1)` forms it.  The
    logs are PyTorch's fp32 logs (XLA's may differ in the last place)."""
    tiny = torch.finfo(torch.float32).tiny
    f = uniform(key, shape, device)
    u = torch.clamp_min(f * torch.tensor(1.0 - tiny, dtype=torch.float32)
                        + tiny, tiny)
    return -torch.log(-torch.log(u))
