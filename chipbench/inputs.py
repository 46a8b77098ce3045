"""Every input a run feeds the program, made from `--seed` alone.

The harness hands these to the program and the reference makes the same
ones again after the window, so both sides see the same numbers.  Each
input has its own generator, seeded from (seed, tag, ...) through a hash,
so that rounds and clients never share a stream and a seed above 2**32 is
as good as a small one.  Tensors are drawn on the given device, in a few
large calls.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by `tags` under `seed`."""
    h = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tags))
    return g


def leaves(cfg: dict) -> list:
    """(path, shape, mean, std) of each parameter leaf, in the order the
    configuration lists them (sorted keys, as a pytree flatten gives)."""
    return [(lf["path"], tuple(lf["shape"]), float(lf["mean"]),
             float(lf["std"])) for lf in cfg["leaves"]]


def n_params(cfg: dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in leaves(cfg))


def base_vector(cfg: dict, seed: int, device):
    """The global model before the round, float32[P]: each leaf
    normal(mean, std)."""
    vec = torch.randn(n_params(cfg), generator=generator(device, seed,
                                                         "base"),
                      device=device)
    off = 0
    for _, shape, mean, std in leaves(cfg):
        n = math.prod(shape)
        seg = vec[off:off + n]
        seg.mul_(std).add_(mean)
        off += n
    return vec


def client_vector(base, seed: int, rnd, client: int, offset_std: float):
    """Client `client`'s local model in round `rnd`: the global model plus
    its own normal(0, offset_std) update."""
    off = torch.randn(base.shape, generator=generator(
        base.device, seed, "client", rnd, client), device=base.device)
    return off.mul_(offset_std).add_(base)


def sensitivity(cfg: dict, seed: int, device):
    """The agreed sensitivity map float32[P] the top-p mask is taken from."""
    return torch.rand(n_params(cfg), generator=generator(device, seed,
                                                         "sensitivity"),
                      device=device)


def tree(cfg: dict, vec):
    """Nested dict of views of the flat vector, one per leaf path."""
    out, off = {}, 0
    for path, shape, _, _ in leaves(cfg):
        n = math.prod(shape)
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = vec[off:off + n].view(shape)
        off += n
    return out


def key_samples(n_poly: int, primes, sigma: float, seed: int, device):
    """(s, a, e): the ternary secret int32[N], the public uniform residues
    int32[L, N] (NTT domain) and the rounded gaussian int32[N] of keygen."""
    g = generator(device, seed, "keys")
    s = torch.randint(0, 3, (n_poly,), generator=g, device=device,
                      dtype=torch.int32) - 1
    a = torch.stack([torch.randint(0, int(q), (n_poly,), generator=g,
                                   device=device, dtype=torch.int32)
                     for q in primes])
    e = torch.round(float(sigma) * torch.randn(
        (n_poly,), generator=g, device=device)).to(torch.int32)
    return s, a, e


def n_samples(seed: int, tag, count: int, lo: int, hi: int) -> list:
    """Local sample counts, uniform in [lo, hi]: the FedAvg weights are
    n_i / sum(n)."""
    rng = np.random.Generator(np.random.PCG64(sub_seed(seed, "n", tag)))
    return [int(x) for x in rng.integers(lo, hi + 1, size=count)]


def fedavg_weights(ns) -> list:
    w = np.asarray(ns, dtype=np.float64)
    return [float(x) for x in w / w.sum()]


def a_seed(seed: int, *tags) -> int:
    """A client's public-`a` seed: 31 bits, unique per (client, round)."""
    return sub_seed(seed, "a_seed", *tags) >> 32
