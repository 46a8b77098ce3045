"""Negacyclic NTT / inverse NTT over all RNS limbs, one CUDA launch each.

Wrappers over `csrc/ntt.cu` (which replaces the JAX package's Pallas
`ntt_fwd_fused` / `ntt_inv_fused`).  On a CUDA tensor a wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version in `ref.py`.
Each wrapper counts its kernel launches in its `launches` attribute.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref

MAX_LOG_N = 14   # N = 16384 needs 64 KiB of shared memory a block


def _check(name, x, tables):
    if x.dim() < 2:
        raise ValueError(f"{name}: expected [..., L, N], got {tuple(x.shape)}")
    l, n = x.shape[-2], x.shape[-1]
    _build.require_cuda(name, x)
    _build.check_int32(f"{name} x", x, x.device)
    for tname, t in tables.items():
        _build.check_int32(f"{name} {tname}", t, x.device)
        if t.shape[0] != l or (t.dim() == 2 and t.shape[1] != n):
            raise ValueError(f"{name}: table {tname} {tuple(t.shape)} does "
                             f"not match x {tuple(x.shape)}")
    log_n = _build.log2_exact(n, f"{name}: N")
    if log_n > MAX_LOG_N:
        raise ValueError(f"{name}: N={n} exceeds the kernel's shared-memory "
                         f"row limit 2**{MAX_LOG_N}")
    return l, log_n


def ntt_fwd_fused(x, psi_rev_mont, qs, qinv_negs):
    """int32[..., L, N] natural order -> bit-reversed NTT domain.
    psi_rev_mont: int32[L, N]; qs, qinv_negs: int32[L]."""
    if x.device.type == "cpu":
        return _ref.ntt_fwd_fused(x, psi_rev_mont, qs, qinv_negs)
    l, log_n = _check("ntt_fwd", x, {"psi_rev_mont": psi_rev_mont, "qs": qs,
                                     "qinv_negs": qinv_negs})
    out = torch.empty_like(x)
    rows = x.numel() >> log_n
    if rows:
        _build.launch("ntt", "ntt_fwd_launch", out, x, psi_rev_mont, qs,
                      qinv_negs, rows, l, log_n)
        ntt_fwd_fused.launches += 1
    return out


def ntt_inv_fused(x, psi_inv_rev_mont, n_inv_monts, qs, qinv_negs):
    """int32[..., L, N] bit-reversed NTT domain -> natural order."""
    if x.device.type == "cpu":
        return _ref.ntt_inv_fused(x, psi_inv_rev_mont, n_inv_monts, qs,
                                  qinv_negs)
    l, log_n = _check("ntt_inv", x, {"psi_inv_rev_mont": psi_inv_rev_mont,
                                     "n_inv_monts": n_inv_monts, "qs": qs,
                                     "qinv_negs": qinv_negs})
    out = torch.empty_like(x)
    rows = x.numel() >> log_n
    if rows:
        _build.launch("ntt", "ntt_inv_launch", out, x, psi_inv_rev_mont, qs,
                      qinv_negs, n_inv_monts, rows, l, log_n)
        ntt_inv_fused.launches += 1
    return out


ntt_fwd_fused.launches = 0
ntt_inv_fused.launches = 0
