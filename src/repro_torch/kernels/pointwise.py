"""Fused modular multiply-add over all RNS limbs, one CUDA launch.

`mul_add`:  out = x (*) y_mont + z  — the encrypt/decrypt workhorse:
    encrypt: c0 = pk0 (*) u + (e0 + m),  c1 = pk1 (*) u + e1
    decrypt: m~ = c1 (*) s + c0

Wrapper over `csrc/pointwise.cu` (which replaces the JAX package's Pallas
`mul_add_fused`).  Operands are passed as strided views: y and z broadcast
against x with a zero batch stride and are never materialized, and x or z
may be the interleaved c0/c1 views of a ciphertext.  On a CPU tensor the
wrapper runs the plain version in `ref.py`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref


def _rows(name, t, shape):
    """`t` broadcast to `shape` [..., L, N] as a [B, L, N] strided view,
    without a copy; raises where no such view exists."""
    t = t.expand(shape)
    if t.dim() == 2:
        return t.unsqueeze(0)
    try:
        return t.view(-1, shape[-2], shape[-1])
    except RuntimeError as e:
        raise ValueError(f"mul_add: {name} {tuple(t.shape)} with strides "
                         f"{t.stride()} has no [B, L, N] view") from e


def mul_add_fused(x, y_mont, z, qs, qinv_negs):
    """out = x (*) y_mont + z mod q_l over int32[..., L, N].

    y_mont and z broadcast to x's shape; qs, qinv_negs: int32[L].  Returns a
    new contiguous tensor of x's shape."""
    if x.device.type == "cpu":
        return _ref.mul_add_fused(x, y_mont, z, qs, qinv_negs)
    _build.require_cuda("mul_add", x)
    if x.dim() < 2:
        raise ValueError(f"mul_add: expected [..., L, N], got "
                         f"{tuple(x.shape)}")
    shape = x.shape
    l, n = shape[-2], shape[-1]
    log_n = _build.log2_exact(n, "mul_add: N")
    ops = {}
    for name, t in (("x", x), ("y_mont", y_mont), ("z", z)):
        _build.check_int32(f"mul_add {name}", t, x.device, contiguous=False)
        ops[name] = _rows(name, t, shape)
    for name, t in (("qs", qs), ("qinv_negs", qinv_negs)):
        _build.check_int32(f"mul_add {name}", t, x.device)
        if t.shape != (l,):
            raise ValueError(f"mul_add: {name} {tuple(t.shape)} != ({l},)")
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    total = out.numel()
    if total >> log_n >= 1 << 32:
        raise ValueError("mul_add: more than 2**32 rows")
    if total:
        args = []
        for name in ("x", "y_mont", "z"):
            t = ops[name]
            args += [t, t.stride(0), t.stride(1)]
        _build.launch("pointwise", "mul_add_launch", out, *args, qs,
                      qinv_negs, total, l, log_n)
        mul_add_fused.launches += 1
    return out


mul_add_fused.launches = 0
