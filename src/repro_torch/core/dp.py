"""Laplace noise for the plaintext part of a partially encrypted update
(the optional DP step of Algorithm 1, paper §3)."""
from __future__ import annotations

import torch


def laplace_noise_vec(vec, gen: torch.Generator, b: float):
    """vec + Laplace(0, b) noise drawn from `gen` (inverse CDF of a uniform
    in (-1, 1), the JAX sampler's construction; not its bits)."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=vec.dtype),
                         torch.tensor(0.0, dtype=vec.dtype)).item()
    u = torch.empty_like(vec).uniform_(lo, 1.0, generator=gen)
    return vec - b * torch.sign(u) * torch.log1p(-u.abs())
