"""The public `a` rows of a seeded ciphertext, from their seed.

A seeded ciphertext's c1 = a is JAX's `randint(fold_in(PRNGKey(a_seed),
chunk), (L, N), 0, q_l)` in the partitionable threefry layout.  Written
from the Threefry-2x32 definition (Salmon et al., SC 2011: 20 rounds,
rotations 13 15 26 6 / 17 29 16 24, key parity 0x1BD11BDA) and JAX's
documented `fold_in`, `split`, `bits` and `randint`; exact int64 torch.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _block(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def fold_in(key, data):
    """key [..., 2] int64, data int64 broadcastable to key[..., 0]."""
    y0, y1 = _block(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def _bits(key, count: int):
    """32-bit words [..., count]: counters (0, j), both outputs xored."""
    j = torch.arange(count, dtype=torch.int64, device=key.device)
    y0, y1 = _block(key[..., 0, None], key[..., 1, None],
                    torch.zeros_like(j), j)
    return y0 ^ y1


def a_rows(a_seed: int, chunk_ids, primes, n_poly: int):
    """int64[len(chunk_ids), L, N]: row r is the `a` of chunk chunk_ids[r]
    under a_seed, limb l uniform in [0, q_l)."""
    dev = chunk_ids.device
    base = torch.tensor([0, int(a_seed) & M32], dtype=torch.int64,
                        device=dev)
    keys = fold_in(base, chunk_ids.to(torch.int64) & M32)       # [R, 2]
    j = torch.arange(2, dtype=torch.int64, device=dev)
    s0, s1 = _block(keys[:, 0, None], keys[:, 1, None],
                    torch.zeros_like(j), j)                      # [R, 2]
    l = len(primes)
    hi = _bits(torch.stack([s0[:, 0], s1[:, 0]], -1), l * n_poly)
    lo = _bits(torch.stack([s0[:, 1], s1[:, 1]], -1), l * n_poly)
    hi = hi.view(-1, l, n_poly)
    lo = lo.view(-1, l, n_poly)
    span = torch.tensor(primes, dtype=torch.int64, device=dev)[:, None]
    mult = (1 << 16) % span
    mult = (mult * mult & M32) % span
    out = ((hi % span) * mult & M32) + lo % span
    return (out & M32) % span
