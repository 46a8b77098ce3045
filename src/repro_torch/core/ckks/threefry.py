"""JAX's threefry2x32 key stream, bit for bit, in plain PyTorch.

A seeded ciphertext carries only (a_seed, c0): its public c1 = a is
regenerated by whoever receives it.  A JAX client draws `a` with
`jax.random.randint` over threefry2x32, so a receiver that must expand a
JAX blob needs the same words.  This module reproduces JAX's `PRNGKey`,
`fold_in`, `split`, 32-bit `random_bits` and unsigned `randint` exactly,
in both layouts of the `jax_threefry_partitionable` flag:

  * partitionable (True, jax 0.9's default): element i of a draw hashes the
    64-bit counter (0, i), and 32-bit bits are the XOR of both output words;
    `split` hashes counters (0, j) and keeps both words as key j;
  * original (False): a draw of n words hashes the counter pairs
    (i, i + ceil(n/2)) and concatenates the two output halves.

Keys are int64 tensors of shape [..., 2] holding the two u32 words; every
function takes a batch of keys along the leading axes and returns its
results with those axes in front.  The arithmetic is exact integer work on
int64 masked to 32 bits (torch's CPU uint32 lacks `+ >> %`).  JAX computes
all of this outside any Pallas kernel, and so does the port: these are
plain torch ops on whatever device the keys are on.

Only the public `a` stream needs this.  The port's secret noise comes from a
`torch.Generator` and never crosses the wire.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` with 64-bit mode off (JAX's default).

    JAX converts the seed to a C long and keeps only its low 32 bits:
    PRNGKey(2**40 + 3) == [0, 3] and PRNGKey(-1) == [0, 2**32 - 1].  Seeds
    outside [-2**63, 2**63) raise OverflowError, as in JAX."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"PRNG seed {seed} does not fit a 64-bit signed "
                            "integer (JAX raises for it too)")
    return torch.tensor([0, seed & M32], dtype=torch.int64, device=device)


def raw_key(seed: int, device="cpu") -> torch.Tensor:
    """A full u64 seed as the raw key words [seed >> 32, seed & 0xFFFFFFFF]
    (the JAX package's transcipher `_pad_base_key`).  Unlike `prng_key` it
    keeps the high word and takes every seed in [0, 2**64): transcipher
    keystream seeds are uniform over 64 bits."""
    seed = int(seed)
    if not 0 <= seed < (1 << 64):
        raise ValueError(f"raw key seed {seed} is not a u64")
    return torch.tensor([seed >> 32, seed & M32], dtype=torch.int64,
                        device=device)


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block function (20 rounds) on broadcastable int64
    tensors of u32 words.  Returns the two output words."""
    shape = torch.broadcast_shapes(k1.shape, k2.shape, x1.shape, x2.shape)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + k1).expand(shape) & M32
    x2 = (x2 + k2).expand(shape) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 += x2
            x1 &= M32
            rot = x2 << r
            x2 >>= 32 - r
            x2 |= rot
            x2 &= M32
            x2 ^= x1
            del rot
        x1 += ks[(i + 1) % 3]
        x1 &= M32
        x2 += ks[(i + 2) % 3] + (i + 1)
        x2 &= M32
    return x1, x2


def _words(keys, ndim: int):
    """Key words [...] reshaped to broadcast against `ndim` trailing axes."""
    pad = (1,) * ndim
    return (keys[..., 0].reshape(keys.shape[:-1] + pad),
            keys[..., 1].reshape(keys.shape[:-1] + pad))


def _hash_iota(keys, n: int):
    """JAX's `threefry_2x32(key, iota(n))` (the original layout's hash of a
    flat counter array): pairs (i, i + ceil(n/2)), the last one padded with
    a zero counter when n is odd, outputs concatenated.  -> [..., n]."""
    if n >= M32:
        raise NotImplementedError("draws of 2**32 - 1 words or more")
    half = (n + 1) // 2
    dev = keys.device
    lo = torch.arange(half, dtype=torch.int64, device=dev)
    hi = torch.arange(half, 2 * half, dtype=torch.int64, device=dev)
    if n % 2:
        hi[-1] = 0
    k1, k2 = _words(keys, 1)
    y1, y2 = threefry2x32(k1, k2, lo, hi)
    return torch.cat([y1, y2], dim=-1)[..., :n]


def fold_in(keys, data, partitionable: bool = True):
    """`jax.random.fold_in(key, data)`: keys [..., 2], data a u32 int or an
    int64 tensor broadcastable against keys[..., 0] (a tensor is taken mod
    2**32, as JAX's traced conversion to uint32 does).  The same in both
    layouts; `partitionable` is accepted for a uniform signature."""
    del partitionable
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & M32
    else:
        data = int(data)
        if not 0 <= data <= M32:
            raise OverflowError(f"fold_in data {data} is out of bounds for "
                                "uint32")
        data = torch.tensor(data, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def split(keys, num: int = 2, partitionable: bool = True):
    """`jax.random.split(key, num)`: keys [..., 2] -> [..., num, 2]."""
    if partitionable:
        k1, k2 = _words(keys, 1)
        j = torch.arange(num, dtype=torch.int64, device=keys.device)
        y1, y2 = threefry2x32(k1, k2, torch.zeros_like(j), j)
        return torch.stack([y1, y2], dim=-1)
    return _hash_iota(keys, 2 * num).reshape(keys.shape[:-1] + (num, 2))


def random_bits(keys, shape, partitionable: bool = True):
    """32-bit `jax.random.bits`-style words: keys [..., 2] -> int64
    [..., *shape] of u32 values."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    batch = keys.shape[:-1]
    if not partitionable:
        return _hash_iota(keys, n).reshape(batch + shape)
    if n > M32:
        raise NotImplementedError("draws of more than 2**32 words")
    k1, k2 = _words(keys, len(shape))
    j = torch.arange(n, dtype=torch.int64, device=keys.device).reshape(shape)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(j), j)
    y1 ^= y2
    return y1


def randint_u32(keys, shape, maxval, partitionable: bool = True):
    """`jax.random.randint(key, shape, 0, maxval, dtype=jnp.uint32)`.

    keys: [..., 2]; maxval: an int or an int64 tensor of u32 values
    broadcastable to `shape` (the per-limb prime column [L, 1] draws every
    limb's residues in one call).  Returns int64 [..., *shape] in
    [0, maxval).  JAX's algorithm: two independent 32-bit draws hi and lo
    from split(key), and (hi % span * (2**32 % span) + lo % span) % span in
    wrapping u32 arithmetic; a span of 0 becomes 1."""
    shape = tuple(int(d) for d in shape)
    span = torch.as_tensor(maxval, dtype=torch.int64, device=keys.device)
    if bool(((span < 0) | (span > M32)).any()):
        raise ValueError("randint_u32: maxval must hold u32 values")
    span = torch.where(span <= 0, torch.ones_like(span), span)
    mult = (1 << 16) % span
    mult = (mult * mult & M32) % span
    k = split(keys, 2, partitionable)
    hi = random_bits(k[..., 0, :], shape, partitionable)
    lo = random_bits(k[..., 1, :], shape, partitionable)
    hi %= span
    hi *= mult
    hi &= M32
    lo %= span
    hi += lo
    del lo
    hi &= M32
    hi %= span
    return hi
