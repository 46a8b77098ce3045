"""Public HE ops over int32[..., L, N] residues, with the JAX package's names
and layouts.

RNS limbs are a batch dimension: every op consumes the whole [..., L, N]
tensor in one call.  Per-limb constants come from the context's device
tables (`CkksContext.device_tables`), sliced to the input's limb count, so
limb-dropped ciphertexts work unchanged.

The seven ops with a kernel (`ntt_fwd`, `ntt_inv`, `mul_add`,
`weighted_sum`, `weighted_accum`, `weighted_accum_chunks`, `mod_lift`) go
to their wrappers, which launch the CUDA kernel for a CUDA tensor and run
the plain version for a CPU tensor: the device decides,
there is no backend switch.  `ntt_fwd` and `ntt_inv` first resolve their
launch geometry through the tuning cache (`kernels/tune.py`) by the
dispatch's (op, N, L, B, device type): a miss runs the flat kernel, an
"ntt4" entry the 4-step kernel at the entry's split, radix and block_b,
with the same bits either way.  The limb-wise helpers (`mod_add`,
`mod_sub`, `mod_neg`, `to_mont`, `from_mont`, `mont_mul`) have no kernel of
their own and are plain torch ops.  The selection mask's split and merge
(`kernels/mask.py`) are called from `core/packing.py`, not from here;
`KERNELS` lists them so that `launch_counts()` counts them too, as it
lists the Mamba-2 SSD's forward and backward (`kernels/ssd.py`, called
from `models/mamba2.py`).

While obs is enabled (`obs.configure(enabled=True)`), every op with a kernel
goes through `obs.timed_kernel`: synchronized before and after, timed,
counted in `kernel_op_launches_total` and traced as an `he.<op>` span (the
NTTs with the tuner's resolved config).  Disabled, the call is the bare op.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch import obs as _obs
from repro_torch.core.ckks import params as _params
from repro_torch.kernels import he_agg as _he_agg
from repro_torch.kernels import lift as _lift
from repro_torch.kernels import mask as _mask
from repro_torch.kernels import ntt as _ntt
from repro_torch.kernels import pointwise as _pointwise
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import tune as _tune

# op name -> the wrapper whose `launches` counts its kernel
KERNELS = {
    "ntt_fwd": _ntt.ntt_fwd_fused,
    "ntt_inv": _ntt.ntt_inv_fused,
    "ntt4_fwd": _ntt.ntt4_fwd_fused,
    "ntt4_inv": _ntt.ntt4_inv_fused,
    "mul_add": _pointwise.mul_add_fused,
    "weighted_sum": _he_agg.he_weighted_sum_fused,
    "weighted_accum": _he_agg.he_weighted_accum_fused,
    "weighted_accum_chunks": _he_agg.he_weighted_accum_chunks_fused,
    "mod_lift": _lift.mod_lift_fused,
    "mask_split": _mask.mask_split,
    "mask_merge": _mask.mask_merge,
    "ssd_fwd": _ssd.ssd_fwd,
    "ssd_bwd": _ssd.ssd_bwd,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per op since the last reset."""
    return {op: fn.launches for op, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _tables(ctx, l: int):
    """ctx's device tables sliced to the first l limbs."""
    return ctx.device_tables.take(l)


def _qcol(t):
    return t.qs[:, None]


# ---------------------------------------------------------------------------
# every kernel under an explicit (backend, config): the tuner's entry
# ---------------------------------------------------------------------------


def _ntt_fwd_flat(t, cfg, x):
    return _ntt.ntt_fwd_fused(x, t.psi_rev_mont, t.qs, t.qinv_negs)


def _ntt_fwd_ntt4(t, cfg, x):
    return _ntt.ntt4_fwd_fused(x, t.ntt4_psi1_mont, t.ntt4_psi2_mont,
                               t.ntt4_corr_mont, t.qs, t.qinv_negs,
                               radix=cfg.radix, block_b=cfg.block_b)


def _ntt_inv_flat(t, cfg, x):
    return _ntt.ntt_inv_fused(x, t.psi_inv_rev_mont, t.n_inv_monts, t.qs,
                              t.qinv_negs)


def _ntt_inv_ntt4(t, cfg, x):
    return _ntt.ntt4_inv_fused(x, t.ntt4_psi1_inv_mont, t.ntt4_psi2_inv_mont,
                               t.ntt4_corr_inv_mont, t.n_inv_monts, t.qs,
                               t.qinv_negs, radix=cfg.radix,
                               block_b=cfg.block_b)


_IMPL = {
    ("ntt_fwd", "flat"): _ntt_fwd_flat,
    ("ntt_fwd", "ntt4"): _ntt_fwd_ntt4,
    ("ntt_inv", "flat"): _ntt_inv_flat,
    ("ntt_inv", "ntt4"): _ntt_inv_ntt4,
}


def run_config(op, backend, cfg, tables, x):
    """Run one NTT op under an explicit (backend, KernelConfig) on x, with
    device tables of x's limb count whose 4-step tables are at the
    config's split (`CkksContext.split_device_tables`): the tuner's
    measurement entry and the dispatch's."""
    impl = _IMPL.get((op, backend))
    if impl is None:
        raise ValueError(f"{op} has no {backend!r} kernel")
    if backend == "ntt4":
        n1 = (cfg.ntt4_split or _params.ntt4_split(x.shape[-1]))[0]
        if tables.ntt4_psi1_mont.shape[-1] != n1:
            raise ValueError(f"{op}: tables are not at the split of {cfg}")
    return impl(tables, cfg, x)


# ---------------------------------------------------------------------------
# ops with a kernel
# ---------------------------------------------------------------------------


def _hooked(fn):
    """The op as it is while obs is disabled, through obs.timed_kernel while
    it is enabled."""
    @functools.wraps(fn)
    def op(*args, **kwargs):
        if not _obs.kernel_hooks_enabled():
            return fn(*args, **kwargs)
        return _obs.timed_kernel(fn.__name__,
                                 functools.partial(fn, **kwargs), *args)
    return op


def _dispatch_ntt(op, x, ctx):
    """One NTT dispatch through the tuning cache."""
    l = x.shape[-2]
    backend, cfg = _tune.resolve(op, x.shape[-1], l,
                                 math.prod(x.shape[:-2]), x.device.type)
    t = ctx.split_device_tables(cfg.ntt4_split if backend == "ntt4"
                                else None).take(l)
    if not _obs.kernel_hooks_enabled():
        return run_config(op, backend, cfg, t, x)
    return _obs.timed_kernel(op, functools.partial(run_config, op, backend,
                                                   cfg, t), x, config=cfg)


def ntt_fwd(x, ctx):
    """Forward negacyclic NTT: int32[..., L, N] natural order ->
    bit-reversed NTT domain, every limb in one launch."""
    return _dispatch_ntt("ntt_fwd", x, ctx)


def ntt_inv(x, ctx):
    """Inverse negacyclic NTT: bit-reversed NTT domain -> natural order."""
    return _dispatch_ntt("ntt_inv", x, ctx)


@_hooked
def mul_add(x, y_mont, z, ctx):
    """Fused x (*) y_mont + z.  y_mont (Montgomery form) and z broadcast to
    x's shape [..., L, N] without being copied."""
    t = _tables(ctx, x.shape[-2])
    return _pointwise.mul_add_fused(x, y_mont, z, t.qs, t.qinv_negs)


@_hooked
def weighted_sum(cts, w_mont, ctx, limb_axis: int = -2):
    """FedAvg aggregation: sum_i w_i (*) ct_i over the leading axis.

    cts: int32[C, ..., L, N] (or, with limb_axis=-3, ciphertext data
    int32[C, ..., L, 2, N]); w_mont: int32[C, L'] Montgomery weights with
    L' >= L, on cts's device.  Returns cts.shape[1:]."""
    l = cts.shape[limb_axis]
    t = _tables(ctx, l)
    return _he_agg.he_weighted_sum_fused(cts, w_mont[:, :l].contiguous(),
                                         t.qs, t.qinv_negs, limb_axis)


@_hooked
def weighted_accum(acc, ct, w_mont, ctx, limb_axis: int = -2, out=None):
    """Streaming fold acc + w (*) ct in one launch: one client folded into a
    running sum, bit-identical to weighted_sum applied in arrival order.

    ct: int32[..., L, N] (or, with limb_axis=-3, ciphertext data
    int32[..., L, 2, N]); acc broadcasts to ct's shape; w_mont: int32[L']
    Montgomery weight with L' >= L.  `out` may be a full `acc` (in-place
    fold)."""
    l = ct.shape[limb_axis]
    t = _tables(ctx, l)
    return _he_agg.he_weighted_accum_fused(acc, ct, w_mont[:l].contiguous(),
                                           t.qs, t.qinv_negs, limb_axis,
                                           out=out)


@_hooked
def weighted_accum_chunks(acc, cts, w_mont, ctx, limb_axis: int = -2,
                          out=None):
    """Batched streaming flush: acc[k] + w[k] (*) ct[k] for every ready row
    k in one launch.

    acc, cts: int32[K, ..., L, N] (or, with limb_axis=-3, ciphertext rows
    int32[K, ..., L, 2, N]); w_mont: int32[K, L'] per-row Montgomery
    weights with L' >= L.  Bit-identical to folding the rows one at a time.
    `out` may be `acc` (in-place update)."""
    l = cts.shape[limb_axis]
    t = _tables(ctx, l)
    return _he_agg.he_weighted_accum_chunks_fused(
        acc, cts, w_mont[:, :l].contiguous(), t.qs, t.qinv_negs, limb_axis,
        out=out)


@_hooked
def mod_lift(x, n_limbs, ctx):
    """Per-limb lift of full-range words: int32[..., N] (u32 bits, no limb
    axis: transcipher-masked coefficients or keystream pads) ->
    int32[..., L, N] with out[..., l, :] = x mod q_l, L = n_limbs, in one
    launch.  Feeds ntt_fwd in the transcipher unmask."""
    return _lift.mod_lift_fused(x, _tables(ctx, n_limbs).qs)


# ---------------------------------------------------------------------------
# limb-wise helpers with no kernel (plain torch ops)
# ---------------------------------------------------------------------------


def mod_add(a, b, ctx):
    return _ref.mod_add(a, b, _qcol(_tables(ctx, a.shape[-2])))


def mod_sub(a, b, ctx):
    return _ref.mod_sub(a, b, _qcol(_tables(ctx, a.shape[-2])))


def mod_neg(a, ctx):
    return _ref.mod_neg(a, _qcol(_tables(ctx, a.shape[-2])))


def to_mont(a, ctx):
    t = _tables(ctx, a.shape[-2])
    return _ref.mont_mul(a, t.r2s[:, None], _qcol(t), t.qinv_negs[:, None])


def from_mont(a, ctx):
    t = _tables(ctx, a.shape[-2])
    return _ref.mont_mul(a, torch.ones_like(a), _qcol(t), t.qinv_negs[:, None])


def mont_mul(a, b_mont, ctx):
    t = _tables(ctx, a.shape[-2])
    return _ref.mont_mul(a, b_mont, _qcol(t), t.qinv_negs[:, None])
