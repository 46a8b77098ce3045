"""Per-limb modular lift of full-range u32 words, one CUDA launch.

`mod_lift`: out[..., l, :] = x[..., :] mod q_l -- the transcipher server's
first unmask step (core/ckks/transcipher.py): masked coefficients arrive as
full-range u32 words with no limb axis and become per-limb residues before
the forward NTT.

Wrapper over `csrc/lift.cu` (which replaces the JAX package's Pallas
`mod_lift_fused`).  Words are int32 tensors holding the u32 bits.  On a
CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor it
runs the plain version in `ref.py`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref


def mod_lift_fused(x, qs):
    """x: int32[..., N] (u32 bits of full-range words); qs: int32[L].
    Returns int32[..., L, N] with out[..., l, :] = x mod q_l."""
    if x.device.type == "cpu":
        return _ref.mod_lift_fused(x, qs)
    _build.require_cuda("mod_lift", x)
    if x.dim() < 1:
        raise ValueError("mod_lift: expected [..., N] words, got a scalar")
    n = x.shape[-1]
    log_n = _build.log2_exact(n, "mod_lift: N")
    if log_n < 2:
        raise ValueError(f"mod_lift: N={n} is below the kernel's 4-word "
                         "vectors")
    _build.check_int32("mod_lift x", x, x.device)
    _build.check_int32("mod_lift qs", qs, x.device)
    if qs.dim() != 1:
        raise ValueError(f"mod_lift: qs {tuple(qs.shape)} is not [L]")
    if x.data_ptr() % 16:
        raise ValueError("mod_lift: x must be 16-byte aligned")
    l = qs.shape[0]
    out = torch.empty(x.shape[:-1] + (l, n), dtype=torch.int32,
                      device=x.device)
    rows = x.numel() >> log_n
    if rows and l:
        _build.launch("lift", "mod_lift_launch", out, x, qs, rows, l, log_n)
        mod_lift_fused.launches += 1
    return out


mod_lift_fused.launches = 0
