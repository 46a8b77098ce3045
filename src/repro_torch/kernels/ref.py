"""Plain PyTorch versions of the port's kernels.

Residues are `torch.int32` tensors holding values in [0, q) with q < 2**30,
so each int32 value equals the u32 value the JAX package carries.  The one
full-range constant, -q^{-1} mod 2**32, arrives as an int32 with the u32's
bits and is widened with `& 0xFFFFFFFF`.

Montgomery products are computed in int64: t = a*b < 2**60, m = t*(-q^{-1})
mod 2**32 through a 16-bit split of the constant (each partial product stays
below 2**48), and t + m*q < 2**63.  Every result is reduced to its canonical
value in [0, q), so it equals the JAX package's 16-bit-split `ref.mont_mul`
bit for bit.  The CUDA kernels compute the same values with 64-bit unsigned
products (kernels/csrc/mont.cuh); these versions are what the wrappers run on
CPU tensors and what the kernels are held against on the card.

Conventions follow the JAX package: data polynomials in normal form,
operators (keys, weights, twiddles) in Montgomery form, NTT domain
bit-reversed.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _u32(x):
    """int32 bits -> the u32 value as int64."""
    return x.to(torch.int64) & _M32


# ---------------------------------------------------------------------------
# Montgomery core
# ---------------------------------------------------------------------------


def mont_mul(a, b, q, qinv_neg):
    """REDC(a*b) = a*b*R^{-1} mod q, element-wise, int32 in and out.
    a, b < q < 2**30; q and qinv_neg broadcast against them."""
    q64 = q.to(torch.int64)
    qi = _u32(qinv_neg)
    t = a.to(torch.int64) * b.to(torch.int64)
    t_lo = t & _M32
    m = (t_lo * (qi & _M16) + (((t_lo * (qi >> 16)) & _M16) << 16)) & _M32
    r = (t + m * q64) >> 32
    return torch.where(r >= q64, r - q64, r).to(torch.int32)


def mod_add(a, b, q):
    s = a + b                     # < 2**31, no wrap in int32
    return torch.where(s >= q, s - q, s)


def mod_sub(a, b, q):
    return torch.where(a >= b, a - b, a + q - b)


def mod_neg(a, q):
    return torch.where(a == 0, a, q - a)


def mod_reduce_centered(v, q):
    """Signed integers -> residues in [0, q) (the encode helper)."""
    r = (v.abs() % q).to(torch.int32)
    return torch.where(v < 0, mod_neg(r, q), r)


def _col(v):
    """[L] -> [L, 1] so it broadcasts over [..., L, N]."""
    return v[:, None]


# ---------------------------------------------------------------------------
# limb-fused versions: the whole [..., L, N] tensor at once
# ---------------------------------------------------------------------------


def ntt_fwd_fused(x, psi_rev_mont, qs, qinv_negs):
    """Forward negacyclic NTT over all limbs: [..., L, N] natural order ->
    bit-reversed.  Cooley-Tukey butterflies, twiddle psi_rev[m + i] for
    group i of stage m (the JAX package's recurrence)."""
    l, n = x.shape[-2], x.shape[-1]
    batch = x.shape[:-2]
    x = x.reshape(-1, l, n)
    q = qs[None, :, None, None]
    qi = qinv_negs[None, :, None, None]
    m, t = 1, n
    while m < n:
        t //= 2
        xs = x.reshape(-1, l, m, 2, t)
        u = xs[:, :, :, 0, :]
        s = psi_rev_mont[:, m:2 * m][None, :, :, None]
        v = mont_mul(xs[:, :, :, 1, :], s, q, qi)
        x = torch.stack([mod_add(u, v, q), mod_sub(u, v, q)],
                        dim=3).reshape(-1, l, n)
        m *= 2
    return x.reshape(batch + (l, n))


def ntt_inv_fused(x, psi_inv_rev_mont, n_inv_monts, qs, qinv_negs):
    """Inverse negacyclic NTT over all limbs: bit-reversed -> natural.
    Gentleman-Sande butterflies with psi_inv_rev[h + i], then N^{-1}."""
    l, n = x.shape[-2], x.shape[-1]
    batch = x.shape[:-2]
    x = x.reshape(-1, l, n)
    q = qs[None, :, None, None]
    qi = qinv_negs[None, :, None, None]
    t, m = 1, n
    while m > 1:
        h = m // 2
        xs = x.reshape(-1, l, h, 2, t)
        u = xs[:, :, :, 0, :]
        v = xs[:, :, :, 1, :]
        s = psi_inv_rev_mont[:, h:2 * h][None, :, :, None]
        lo = mod_add(u, v, q)
        hi = mont_mul(mod_sub(u, v, q), s, q, qi)
        x = torch.stack([lo, hi], dim=3).reshape(-1, l, n)
        t *= 2
        m = h
    x = mont_mul(x, _col(n_inv_monts), _col(qs), _col(qinv_negs))
    return x.reshape(batch + (l, n))


# ---------------------------------------------------------------------------
# 4-step NTT: N = n1 * n2, bit-identical to the flat NTT
# ---------------------------------------------------------------------------
#
# With j = j2 + n2*j1 and k = k1 + n1*k2 the negacyclic NTT is a length-n1
# LN NTT down each column (root psi^n2), an elementwise correction (one
# Montgomery table), and a length-n2 LN NTT along each row (root psi^n1).
# Both keep the LN bit-reversed convention, and bitrev(k1 + n1*k2) =
# bitrev(k1)*n2 + bitrev(k2), so the [bitrev(k1)][bitrev(k2)] result,
# flattened, is the flat NTT's output.  The steps follow the JAX package's
# `_ntt4_fwd_body` / `_ntt4_inv_body` one for one.


def _ln_fwd_axis1(x, psi, q, qi, radix: int = 2):
    """LN forward butterflies along the `len` axis of x[b, L, len, spec];
    psi: [L, len]; q, qi broadcast as [1, L, 1, 1].  The recurrence of the
    flat forward NTT.  radix=4 fuses each pair of consecutive stages into
    one pass (a trailing radix-2 stage remains when log2(len) is odd): the
    same products and sums on the same elements, so the same bits."""
    b, l, ln, spec = x.shape
    m, t = 1, ln
    while m < ln:
        if radix == 4 and m * 4 <= ln:
            t //= 4
            xs = x.reshape(b, l, m, 2, 2, t, spec)
            s1 = psi[:, m:2 * m][None, :, :, None, None, None]
            u = xs[:, :, :, 0]                     # [b, L, m, 2, t, spec]
            v = mont_mul(xs[:, :, :, 1], s1, q[..., None, None],
                         qi[..., None, None])
            y0 = mod_add(u, v, q[..., None, None])
            y1 = mod_sub(u, v, q[..., None, None])
            s20 = psi[:, 2 * m:4 * m:2][None, :, :, None, None]
            s21 = psi[:, 2 * m + 1:4 * m:2][None, :, :, None, None]
            qq, qqi = q[..., None], qi[..., None]
            v0 = mont_mul(y0[:, :, :, 1], s20, qq, qqi)
            v1 = mont_mul(y1[:, :, :, 1], s21, qq, qqi)
            x = torch.stack([mod_add(y0[:, :, :, 0], v0, qq),
                             mod_sub(y0[:, :, :, 0], v0, qq),
                             mod_add(y1[:, :, :, 0], v1, qq),
                             mod_sub(y1[:, :, :, 0], v1, qq)],
                            dim=3).reshape(b, l, ln, spec)
            m *= 4
            continue
        t //= 2
        xs = x.reshape(b, l, m, 2, t, spec)
        u = xs[:, :, :, 0]
        s = psi[:, m:2 * m][None, :, :, None, None]
        qq, qqi = q[..., None], qi[..., None]
        v = mont_mul(xs[:, :, :, 1], s, qq, qqi)
        x = torch.stack([mod_add(u, v, qq), mod_sub(u, v, qq)],
                        dim=3).reshape(b, l, ln, spec)
        m *= 2
    return x


def _ln_inv_axis1(x, psi_inv, q, qi, radix: int = 2):
    """Gentleman-Sande inverse butterflies along the `len` axis of
    x[b, L, len, spec], without the 1/len scale (the caller applies one
    N^{-1} for both phases).  radix=4 fuses stage pairs as in
    _ln_fwd_axis1."""
    b, l, ln, spec = x.shape
    t, m = 1, ln
    while m > 1:
        if radix == 4 and m % 4 == 0:
            h2 = m // 4
            xs = x.reshape(b, l, h2, 2, 2, t, spec)   # [g, a, dA, k]
            u = xs[:, :, :, :, 0]                     # [b, L, h2, 2, t, spec]
            v = xs[:, :, :, :, 1]
            s1 = psi_inv[:, m // 2:m].reshape(l, h2, 2)[
                None, :, :, :, None, None]
            q6, qi6 = q[..., None, None], qi[..., None, None]
            lo = mod_add(u, v, q6)
            hi = mont_mul(mod_sub(u, v, q6), s1, q6, qi6)
            s2 = psi_inv[:, h2:2 * h2][None, :, :, None, None]
            qq, qqi = q[..., None], qi[..., None]
            d1_lo = mod_sub(lo[:, :, :, 0], lo[:, :, :, 1], qq)
            d1_hi = mod_sub(hi[:, :, :, 0], hi[:, :, :, 1], qq)
            x = torch.stack([mod_add(lo[:, :, :, 0], lo[:, :, :, 1], qq),
                             mod_add(hi[:, :, :, 0], hi[:, :, :, 1], qq),
                             mont_mul(d1_lo, s2, qq, qqi),
                             mont_mul(d1_hi, s2, qq, qqi)],
                            dim=3).reshape(b, l, ln, spec)
            t *= 4
            m = h2
            continue
        h = m // 2
        xs = x.reshape(b, l, h, 2, t, spec)
        u = xs[:, :, :, 0]
        v = xs[:, :, :, 1]
        s = psi_inv[:, h:2 * h][None, :, :, None, None]
        qq, qqi = q[..., None], qi[..., None]
        lo = mod_add(u, v, qq)
        hi = mont_mul(mod_sub(u, v, qq), s, qq, qqi)
        x = torch.stack([lo, hi], dim=3).reshape(b, l, ln, spec)
        t *= 2
        m = h
    return x


def ntt4_fwd_fused(x, psi1, psi2, corr, qs, qinv_negs, radix: int = 2):
    """4-step forward NTT over all limbs, [..., L, N] natural order ->
    bit-reversed, bit-identical to ntt_fwd_fused.  psi1: [L, n1], psi2:
    [L, n2], corr: [L, N], N = n1 * n2 (the split is read off the tables)."""
    l, n = x.shape[-2], x.shape[-1]
    n1, n2 = psi1.shape[-1], psi2.shape[-1]
    batch = x.shape[:-2]
    q = qs[None, :, None, None]
    qi = qinv_negs[None, :, None, None]
    x = x.reshape(-1, l, n1, n2)                          # [j1][j2]
    x = _ln_fwd_axis1(x, psi1, q, qi, radix)              # [br k1][j2]
    x = mont_mul(x, corr.reshape(1, l, n1, n2), q, qi)
    x = x.transpose(2, 3)                                 # [j2][br k1]
    x = _ln_fwd_axis1(x, psi2, q, qi, radix)              # [br k2][br k1]
    return x.transpose(2, 3).reshape(batch + (l, n))


def ntt4_inv_fused(x, psi1_inv, psi2_inv, corr_inv, n_inv_monts, qs,
                   qinv_negs, radix: int = 2):
    """4-step inverse NTT over all limbs, bit-reversed -> natural order,
    bit-identical to ntt_inv_fused (one combined N^{-1} R scale)."""
    l, n = x.shape[-2], x.shape[-1]
    n1, n2 = psi1_inv.shape[-1], psi2_inv.shape[-1]
    batch = x.shape[:-2]
    q = qs[None, :, None, None]
    qi = qinv_negs[None, :, None, None]
    x = x.reshape(-1, l, n1, n2)                          # [br k1][br k2]
    x = x.transpose(2, 3)                                 # [br k2][br k1]
    x = _ln_inv_axis1(x, psi2_inv, q, qi, radix)          # [j2][br k1]
    x = x.transpose(2, 3)                                 # [br k1][j2]
    x = mont_mul(x, corr_inv.reshape(1, l, n1, n2), q, qi)
    x = _ln_inv_axis1(x, psi1_inv, q, qi, radix)          # [j1][j2]
    x = x.reshape(-1, l, n)
    x = mont_mul(x, _col(n_inv_monts), _col(qs), _col(qinv_negs))
    return x.reshape(batch + (l, n))


def mul_add_fused(x, y_mont, z, qs, qinv_negs):
    """x (*) y_mont + z over [..., L, N]; y_mont and z broadcast to x."""
    return mod_add(mont_mul(x, y_mont, _col(qs), _col(qinv_negs)), z,
                   _col(qs))


def he_weighted_sum_fused(cts, w_mont, qs, qinv_negs, limb_axis: int = -2):
    """sum_i w_i (*) ct_i over the leading client axis, all limbs.

    cts: int32[C, ..., L, ...] with the limb axis at `limb_axis` (-2 for
    the ops layout [C, ..., L, N], -3 for ciphertexts [C, ..., L, 2, N]);
    w_mont: int32[C, L] Montgomery scalar weights.  Clients are folded in
    order; modular sums are exact, so the order changes no bit.
    """
    c = cts.shape[0]
    trail = -limb_axis - 1                    # axes after the limb axis
    lshape = (cts.shape[limb_axis],) + (1,) * trail
    q = qs.reshape(lshape)
    qi = qinv_negs.reshape(lshape)
    acc = mont_mul(cts[0], w_mont[0].reshape(lshape), q, qi)
    for i in range(1, c):
        acc = mod_add(acc, mont_mul(cts[i], w_mont[i].reshape(lshape), q, qi),
                      q)
    return acc


def he_weighted_accum_fused(acc, ct, w_mont, qs, qinv_negs,
                            limb_axis: int = -2):
    """Streaming fold acc + w (*) ct mod q_l with one weight per limb.

    ct: int32[..., L, ...] with the limb axis at `limb_axis` (-2 for the ops
    layout, -3 for ciphertexts); acc broadcasts to ct's shape (JAX's
    broadcast_to: a shape that does not raises); w_mont: int32[L]."""
    lshape = (ct.shape[limb_axis],) + (1,) * (-limb_axis - 1)
    q = qs.reshape(lshape)
    return mod_add(acc.expand(ct.shape),
                   mont_mul(ct, w_mont.reshape(lshape), q,
                            qinv_negs.reshape(lshape)), q)


def he_weighted_accum_chunks_fused(acc, cts, w_mont, qs, qinv_negs,
                                   limb_axis: int = -2):
    """Batched streaming flush: acc[k] + w[k] (*) ct[k] mod q_l for every
    row k, all limbs.

    acc, cts: int32[K, ..., L, ...] of one shape, with the limb axis at
    `limb_axis` (-2 for the ops layout [K, ..., L, N], -3 for ciphertexts
    [K, ..., L, 2, N]); w_mont: int32[K, L] per-row Montgomery weights
    (rows may belong to different clients).  The same arithmetic as folding
    each row alone with `mul_add`."""
    trail = -limb_axis - 1                    # axes after the limb axis
    k, l = cts.shape[0], cts.shape[limb_axis]
    lshape = (l,) + (1,) * trail
    wb = w_mont.reshape((k,) + (1,) * (cts.dim() - 2 - trail) + lshape)
    return mod_add(acc, mont_mul(cts, wb, qs.reshape(lshape),
                                 qinv_negs.reshape(lshape)),
                   qs.reshape(lshape))


def mod_lift_fused(x, qs):
    """Per-limb lift of full-range words: out[..., l, :] = x[..., :] mod q_l.

    x: int32[..., N] holding the u32 bits of full-range words (transcipher
    masked coefficients span [1, 2**32 - 2], keystream pads [2**30,
    3 * 2**30)); qs: int32[L].  The words are widened to their u32 values
    before the remainder: `%` of the signed view floors, and would give
    wrong residues for every word >= 2**31."""
    return (_u32(x)[..., None, :] % qs.to(torch.int64)[:, None]).to(
        torch.int32)
