"""Fused encrypted FedAvg aggregation over all RNS limbs, one CUDA launch.

The server hot loop of the paper is  sum_i alpha_i * [[W_i]]  over client
ciphertexts.  Wrappers over `csrc/he_agg.cu`, which replaces the JAX
package's Pallas `he_weighted_sum_fused` (in-memory aggregation),
`he_weighted_accum_fused` (the sharded engine's fold, acc + w (*) ct) and
`he_weighted_accum_chunks_fused` (the streaming ingest's flush,
acc[k] + w[k] (*) ct[k]).  Each element is read once and written once.  The
kernels read their tensors in their own layout, with the limb axis either
at -2 (the ops layout [..., L, N]) or at -3 (ciphertexts [..., L, 2, N]),
so no relayout copy is made.  On a CPU tensor a wrapper runs the plain
version in `ref.py`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref


def he_weighted_sum_fused(cts, w_mont, qs, qinv_negs, limb_axis: int = -2):
    """sum_i w_i (*) ct_i mod q_l over the leading client axis.

    cts: int32[C, ..., L, ...] with the limb axis at `limb_axis` (-2 or -3);
    w_mont: int32[C, L]; qs, qinv_negs: int32[L].  Returns int32 of shape
    cts.shape[1:]."""
    if cts.device.type == "cpu":
        return _ref.he_weighted_sum_fused(cts, w_mont, qs, qinv_negs,
                                          limb_axis)
    _build.require_cuda("weighted_sum", cts)
    if limb_axis not in (-2, -3) or cts.dim() < 1 - limb_axis:
        raise ValueError(f"weighted_sum: limb_axis {limb_axis} does not fit "
                         f"cts {tuple(cts.shape)}")
    c, l = cts.shape[0], cts.shape[limb_axis]
    inner = math.prod(cts.shape[limb_axis + 1:])
    log_inner = _build.log2_exact(inner, "weighted_sum: elements per limb")
    _build.check_int32("weighted_sum cts", cts, cts.device)
    _build.check_int32("weighted_sum w_mont", w_mont, cts.device)
    if tuple(w_mont.shape) != (c, l):
        raise ValueError(f"weighted_sum: w_mont {tuple(w_mont.shape)} != "
                         f"({c}, {l})")
    for name, t in (("qs", qs), ("qinv_negs", qinv_negs)):
        _build.check_int32(f"weighted_sum {name}", t, cts.device)
        if t.shape != (l,):
            raise ValueError(f"weighted_sum: {name} {tuple(t.shape)} != "
                             f"({l},)")
    out = torch.empty(cts.shape[1:], dtype=torch.int32, device=cts.device)
    per_client = out.numel()
    if per_client >> log_inner >= 1 << 32:
        raise ValueError("weighted_sum: more than 2**32 limb rows")
    if per_client and c:
        _build.launch("he_agg", "weighted_sum_launch", out, cts, w_mont, qs,
                      qinv_negs, per_client, c, l, log_inner)
        he_weighted_sum_fused.launches += 1
    return out


he_weighted_sum_fused.launches = 0


def he_weighted_accum_chunks_fused(acc, cts, w_mont, qs, qinv_negs,
                                   limb_axis: int = -2, out=None):
    """acc[k] + w[k] (*) ct[k] mod q_l for every row k, one launch.

    acc, cts: int32[K, ..., L, ...] of one shape with the limb axis at
    `limb_axis` (-2 or -3); w_mont: int32[K, L] per-row weights; qs,
    qinv_negs: int32[L].  `out` (default: a new tensor) may be `acc`
    itself, which updates the accumulator in place.  Returns `out`."""
    if cts.device.type == "cpu":
        res = _ref.he_weighted_accum_chunks_fused(acc, cts, w_mont, qs,
                                                  qinv_negs, limb_axis)
        return res if out is None else out.copy_(res)
    _build.require_cuda("weighted_accum_chunks", cts)
    if limb_axis not in (-2, -3) or cts.dim() < 1 - limb_axis:
        raise ValueError(f"weighted_accum_chunks: limb_axis {limb_axis} "
                         f"does not fit cts {tuple(cts.shape)}")
    k, l = cts.shape[0], cts.shape[limb_axis]
    inner = math.prod(cts.shape[limb_axis + 1:])
    log_inner = _build.log2_exact(inner,
                                  "weighted_accum_chunks: elements per limb")
    out = torch.empty_like(cts) if out is None else out
    for name, t in (("cts", cts), ("acc", acc), ("out", out)):
        _build.check_int32(f"weighted_accum_chunks {name}", t, cts.device)
        if t.shape != cts.shape:
            raise ValueError(f"weighted_accum_chunks: {name} "
                             f"{tuple(t.shape)} != cts {tuple(cts.shape)}")
    _build.check_int32("weighted_accum_chunks w_mont", w_mont, cts.device)
    if tuple(w_mont.shape) != (k, l):
        raise ValueError(f"weighted_accum_chunks: w_mont "
                         f"{tuple(w_mont.shape)} != ({k}, {l})")
    for name, t in (("qs", qs), ("qinv_negs", qinv_negs)):
        _build.check_int32(f"weighted_accum_chunks {name}", t, cts.device)
        if t.shape != (l,):
            raise ValueError(f"weighted_accum_chunks: {name} "
                             f"{tuple(t.shape)} != ({l},)")
    total = cts.numel()
    if total >> log_inner >= 1 << 32:
        raise ValueError("weighted_accum_chunks: more than 2**32 limb rows")
    if total:
        row_steps = (total >> log_inner) // k
        _build.launch("he_agg", "weighted_accum_chunks_launch", out, acc,
                      cts, w_mont, qs, qinv_negs, total, l, log_inner,
                      row_steps)
        he_weighted_accum_chunks_fused.launches += 1
    return out


he_weighted_accum_chunks_fused.launches = 0


def he_weighted_accum_fused(acc, ct, w_mont, qs, qinv_negs,
                            limb_axis: int = -2, out=None):
    """acc + w (*) ct mod q_l with one weight per limb, one launch.

    ct: int32[..., L, ...] with the limb axis at `limb_axis` (-2 or -3);
    acc broadcasts to ct's shape as JAX's broadcast_to does (a full
    accumulator, or one row repeated over ct's leading axes, read in place
    and never expanded); w_mont, qs, qinv_negs: int32[L].  `out` (default:
    a new tensor of ct's shape) may be a full `acc` itself, which folds in
    place.  Returns `out`."""
    if ct.device.type == "cpu":
        res = _ref.he_weighted_accum_fused(acc, ct, w_mont, qs, qinv_negs,
                                           limb_axis)
        return res if out is None else out.copy_(res)
    _build.require_cuda("weighted_accum", ct)
    if limb_axis not in (-2, -3) or ct.dim() < 1 - limb_axis:
        raise ValueError(f"weighted_accum: limb_axis {limb_axis} does not "
                         f"fit ct {tuple(ct.shape)}")
    l = ct.shape[limb_axis]
    inner = math.prod(ct.shape[limb_axis + 1:])
    log_inner = _build.log2_exact(inner, "weighted_accum: elements per limb")
    acc_shape = tuple(acc.shape)
    while acc_shape and acc_shape[0] == 1 and len(acc_shape) > 1:
        acc_shape = acc_shape[1:]
    if acc_shape != tuple(ct.shape[ct.dim() - len(acc_shape):]):
        raise ValueError(f"weighted_accum: acc {tuple(acc.shape)} is not a "
                         f"trailing broadcast of ct {tuple(ct.shape)}")
    out = torch.empty_like(ct) if out is None else out
    for name, t in (("ct", ct), ("acc", acc), ("out", out)):
        _build.check_int32(f"weighted_accum {name}", t, ct.device)
    if out.shape != ct.shape:
        raise ValueError(f"weighted_accum: out {tuple(out.shape)} != ct "
                         f"{tuple(ct.shape)}")
    for name, t in (("w_mont", w_mont), ("qs", qs), ("qinv_negs", qinv_negs)):
        _build.check_int32(f"weighted_accum {name}", t, ct.device)
        if t.shape != (l,):
            raise ValueError(f"weighted_accum: {name} {tuple(t.shape)} != "
                             f"({l},)")
    total = ct.numel()
    if total >> log_inner >= 1 << 32 or acc.numel() >= 1 << 32:
        raise ValueError("weighted_accum: more than 2**32 limb rows or "
                         "accumulator elements")
    if total:
        _build.launch("he_agg", "weighted_accum_launch", out, acc, ct, w_mont,
                      qs, qinv_negs, acc.numel(), total // acc.numel(), l,
                      log_inner)
        he_weighted_accum_fused.launches += 1
    return out


he_weighted_accum_fused.launches = 0
