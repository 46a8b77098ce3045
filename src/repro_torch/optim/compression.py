"""DoubleSqueeze gradient compression with error feedback (Tang et al.,
2019).

The paper (Figure 8, Table 5) stacks DoubleSqueeze top-k compression in
front of HE to shrink the encrypted volume: only the top-k update entries
are shipped (and encrypted); the compression error is fed back into the
next round on both worker and server sides.

Selection is `torch.topk` on |value|.  Among equal magnitudes it may keep
other indices than the JAX package's `jax.lax.top_k`; the kept magnitudes
and the error-feedback identity are the same.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.ckks.params import resolve_device


@dataclasses.dataclass
class DoubleSqueezeState:
    error: torch.Tensor      # f32[P] residual carried between rounds


def double_squeeze_init(n_params: int, device=None) -> DoubleSqueezeState:
    """Zero residual on `device` (CUDA unless the caller names another)."""
    return DoubleSqueezeState(error=torch.zeros(
        (n_params,), dtype=torch.float32, device=resolve_device(device)))


def topk_sparsify(vec, k: int):
    """Keep the k largest-|.| entries. Returns (values f32[k], idx int64[k],
    dense_compressed f32[P])."""
    _, idx = torch.topk(vec.abs(), k)
    vals = vec[idx]
    dense = torch.zeros_like(vec).index_copy(0, idx, vals)
    return vals, idx, dense


def double_squeeze_compress(vec, state: DoubleSqueezeState, k: int):
    """One error-compensated compression pass.

    corrected = vec + error;  compressed = top_k(corrected);
    new_error = corrected - compressed.
    Returns (compressed_dense f32[P], (values, idx), new_state).
    """
    corrected = vec + state.error
    vals, idx, dense = topk_sparsify(corrected, k)
    return dense, (vals, idx), DoubleSqueezeState(error=corrected - dense)
