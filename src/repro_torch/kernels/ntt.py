"""Negacyclic NTT / inverse NTT over all RNS limbs, one CUDA launch each.

Wrappers over `csrc/ntt.cu` (the flat kernels, which replace the JAX
package's Pallas `ntt_fwd_fused` / `ntt_inv_fused`) and `csrc/ntt4.cu` (the
4-step kernels, which replace `ntt4_fwd_fused` / `ntt4_inv_fused`; N = n1 *
n2 is read off the tables).  Both run the register passes of
`csrc/ntt_pass.cuh`, one thread block a (row, limb) pair.  The 4-step
wrappers still take the JAX package's `radix` and `block_b`: they are
checked, `radix` groups the plain version's stages, and neither changes
the kernel's launch or any bit.  On a CUDA tensor a wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version in `ref.py`.
Each wrapper counts its kernel launches in its `launches` attribute.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref

MAX_LOG_N = 14   # ntt_pass.cuh's kMaxLogN
MAX_SMEM_BYTES = 232_448   # the most shared memory an H100 block can use
MAX_BLOCK_B = 8   # the largest block_b a 4-step config may name; the
                  # kernel runs one (row, limb) pair a block whatever it says


def _slot(e: int) -> int:
    return e + e // 32


def smem_bytes(n: int, split: tuple[int, int] | None = None) -> int:
    """Shared memory of one block of the flat NTT kernels at N = n (split
    None) or of the 4-step kernels at split (n1, n2): the row in
    ntt_pass.cuh's padded layout, a pad word after every 32 (33,788 bytes
    at N = 8192; none at N <= 32, where one register pass needs no
    exchange), and for the 4-step the block's copy of psi1 and psi2 in the
    same layout, psi2 from n1 rounded up to 32 words (ntt4.cu's
    table_words: 1,184 bytes at 32 x 256)."""
    row = 0 if n <= 32 else 4 * (_slot(n - 1) + 1)
    if split is None:
        return row
    n1, n2 = split
    return row + 4 * (_slot(-(-n1 // 32) * 32 + n2 - 1) + 1)


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


def _check4(name, x, tables, psi1, psi2, radix, block_b):
    """_check of x and the [L] / [L, N] tables, plus the sub-transform
    tables psi1 [L, n1] and psi2 [L, n2] with n1 * n2 = N, the radix and
    block_b a config names; returns (l, log_n, log_n1)."""
    l, log_n = _check(name, x, tables)
    n = x.shape[-1]
    n1, n2 = psi1.shape[-1], psi2.shape[-1]
    if n1 * n2 != n:
        raise ValueError(f"{name}: split {n1} x {n2} of the tables does not "
                         f"give N={n}")
    for tname, t, cols in (("psi1", psi1, n1), ("psi2", psi2, n2)):
        _build.check_int32(f"{name} {tname}", t, x.device)
        if tuple(t.shape) != (l, cols):
            raise ValueError(f"{name}: table {tname} {tuple(t.shape)} does "
                             f"not match x {tuple(x.shape)}")
    log_n1 = _build.log2_exact(n1, f"{name}: n1")
    _build.log2_exact(n2, f"{name}: n2")
    if smem_bytes(n, (n1, n2)) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: split {n1} x {n2} needs "
                         f"{smem_bytes(n, (n1, n2))} bytes of shared "
                         f"memory, over {MAX_SMEM_BYTES}")
    if radix not in (2, 4):
        raise ValueError(f"{name}: radix must be 2 or 4, got {radix}")
    if not 1 <= block_b <= MAX_BLOCK_B:
        raise ValueError(f"{name}: block_b must be in [1, {MAX_BLOCK_B}], "
                         f"got {block_b}")
    return l, log_n, log_n1


def ntt4_fwd_fused(x, psi1_mont, psi2_mont, corr_mont, qs, qinv_negs, *,
                   radix: int = 2, block_b: int = 1):
    """4-step forward NTT, bit-identical to ntt_fwd_fused: int32[..., L, N]
    natural order -> bit-reversed.  psi1_mont int32[L, n1], psi2_mont
    int32[L, n2], corr_mont int32[L, N]; radix and block_b as the module
    docstring says."""
    if x.device.type == "cpu":
        return _ref.ntt4_fwd_fused(x, psi1_mont, psi2_mont, corr_mont, qs,
                                   qinv_negs, radix)
    l, log_n, log_n1 = _check4(
        "ntt4_fwd", x, {"corr_mont": corr_mont, "qs": qs,
                        "qinv_negs": qinv_negs}, psi1_mont, psi2_mont, radix,
        block_b)
    out = torch.empty_like(x)
    rows = x.numel() >> log_n
    if rows:
        _build.launch("ntt4", "ntt4_fwd_launch", out, x, psi1_mont,
                      psi2_mont, corr_mont, qs, qinv_negs, rows, l, log_n,
                      log_n1)
        ntt4_fwd_fused.launches += 1
    return out


def ntt4_inv_fused(x, psi1_inv_mont, psi2_inv_mont, corr_inv_mont,
                   n_inv_monts, qs, qinv_negs, *, radix: int = 2,
                   block_b: int = 1):
    """4-step inverse NTT, bit-identical to ntt_inv_fused: int32[..., L, N]
    bit-reversed -> natural order, one combined N^{-1} R scale."""
    if x.device.type == "cpu":
        return _ref.ntt4_inv_fused(x, psi1_inv_mont, psi2_inv_mont,
                                   corr_inv_mont, n_inv_monts, qs, qinv_negs,
                                   radix)
    l, log_n, log_n1 = _check4(
        "ntt4_inv", x, {"corr_inv_mont": corr_inv_mont,
                        "n_inv_monts": n_inv_monts, "qs": qs,
                        "qinv_negs": qinv_negs}, psi1_inv_mont,
        psi2_inv_mont, radix, block_b)
    out = torch.empty_like(x)
    rows = x.numel() >> log_n
    if rows:
        _build.launch("ntt4", "ntt4_inv_launch", out, x, psi1_inv_mont,
                      psi2_inv_mont, corr_inv_mont, qs, qinv_negs,
                      n_inv_monts, rows, l, log_n, log_n1)
        ntt4_inv_fused.launches += 1
    return out


ntt_fwd_fused.launches = 0
ntt_inv_fused.launches = 0
ntt4_fwd_fused.launches = 0
ntt4_inv_fused.launches = 0
