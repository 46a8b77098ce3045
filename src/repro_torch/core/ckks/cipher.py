"""RNS-CKKS cipher: keygen / encrypt / decrypt / homomorphic ops.

Ciphertexts are int32[..., L, 2, N] tensors in bit-reversed NTT domain,
wrapped with their scale.  Every random step is split in two:

  * a sampler draws the random symbols from an explicit `torch.Generator`
    (ternary symbols in {-1, 0, 1}, rounded gaussians, uniform residues);
  * a `*_from_samples` body does the arithmetic on those draws.

The tests feed the same numpy-made draws to a body here and to the same
composition of the JAX package's ops, and compare bits.  The secret draws
(keys, u, e) come from the generator, not from JAX's threefry stream, so the
same seed gives other numbers than a JAX key.  The one stream that crosses
the wire, the public `a` of a seeded ciphertext, is JAX's: `expand_a_rows`
regenerates it from (a_seed, derive id) with the port's threefry
(`threefry.py`) bit for bit, so a port server expands a JAX client's blob
and a JAX server a port client's.

Scale discipline (depth 1, the paper's setting): a fresh ciphertext has
scale delta; after the plaintext-scalar weighting it has delta**2, and
decode divides by it (no rescale).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.ckks import encoding, threefry
from repro_torch.core.ckks.params import CkksContext
from repro_torch.kernels import ntt as _ntt
from repro_torch.kernels import ops, ref as _ref


@dataclasses.dataclass
class Ciphertext:
    """data: int32[..., L, 2, N] NTT domain; scale: encoding scale."""

    data: torch.Tensor
    scale: float = 1.0

    @property
    def n_limbs(self) -> int:
        return self.data.shape[-3]

    @property
    def c0(self):
        return self.data[..., 0, :]

    @property
    def c1(self):
        return self.data[..., 1, :]


# ---------------------------------------------------------------------------
# samplers (torch.Generator) and residue maps
# ---------------------------------------------------------------------------


def sample_ternary(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform ternary symbols in {-1, 0, 1}, int32 of `shape`."""
    return torch.randint(0, 3, tuple(shape), generator=gen, device=device,
                         dtype=torch.int32) - 1


def sample_gaussian(gen: torch.Generator, shape, device,
                    sigma: float) -> torch.Tensor:
    """Rounded gaussian integers round(sigma * N(0, 1)), int32."""
    x = torch.randn(tuple(shape), generator=gen, device=device)
    return torch.round(float(sigma) * x).to(torch.int32)


def sample_uniform(gen: torch.Generator, shape, ctx: CkksContext):
    """Uniform residues int32[..., L, N]: limb l uniform in [0, q_l)."""
    return torch.stack(
        [torch.randint(0, int(q), tuple(shape), generator=gen,
                       device=ctx.device, dtype=torch.int32)
         for q in ctx.primes], dim=-2)


def centered_residues(v, ctx: CkksContext):
    """Small signed integers int[..., N] -> residues int32[..., L, N]."""
    qs = ctx.device_tables.qs[:, None]
    return _ref.mod_reduce_centered(v[..., None, :], qs)


# ---------------------------------------------------------------------------
# the public `a` stream: per-chunk seed derivation (wire-v2 derive ids)
# ---------------------------------------------------------------------------
#
# A seeded ciphertext's c1 = a is expanded per chunk from the base key
# PRNGKey(a_seed); the derive id carried by wire-v2 seeded frames names how
# chunk i's key is derived from (base, i).  The ids, the CTR tag and the
# start-offset ranges are the JAX package's (cipher.DERIVE_KEYFNS).

DERIVE_FOLD_CHUNK = 1    # chunk i's key = fold_in(base, i)
DERIVE_CTR = 2           # chunk i's key = [h_hi, h_lo + i], h = one fold_in
                         # hash of the base key (counter mode)
_CTR_TAG = 0x435452      # "CTR": the domain-separation fold of DERIVE_CTR
DERIVES = (DERIVE_FOLD_CHUNK, DERIVE_CTR)

# rows of `a` expanded per batch: bounds threefry's int64 temporaries to a
# few hundred MB at N=8192, L=2
_EXPAND_VALUES = 1 << 25


def check_derive(derive: int) -> None:
    if derive not in DERIVES:
        raise ValueError(
            f"unknown seed-derivation id {derive}; this build implements "
            f"{DERIVES} (DESIGN.md §9.2)")


def check_chunk_start(start: int, derive: int) -> None:
    """JAX takes a FOLD_CHUNK start offset as an int32 and a CTR one as a
    uint32; larger offsets raise OverflowError there and here."""
    check_derive(derive)
    lo, hi = ((-(1 << 31), 1 << 31) if derive == DERIVE_FOLD_CHUNK
              else (0, 1 << 32))
    if not lo <= int(start) < hi:
        raise OverflowError(f"chunk offset {start} is out of range for "
                            f"derive id {derive} ([{lo}, {hi}))")


def _keys_for_ids(base, ids, derive: int, partitionable: bool):
    """Chunk keys [len(ids), 2] for global chunk ids (int64, mod 2**32)."""
    check_derive(derive)
    if derive == DERIVE_FOLD_CHUNK:
        return threefry.fold_in(base, ids, partitionable)
    h = threefry.fold_in(base, _CTR_TAG, partitionable)
    return torch.stack([h[0].expand(ids.shape),
                        (h[1] + ids) & threefry.M32], dim=-1)


def _chunk_ids(start: int, count: int, device):
    return (int(start) + torch.arange(count, dtype=torch.int64,
                                      device=device)) & threefry.M32


def derive_chunk_keys(base, start: int, count: int,
                      derive: int = DERIVE_FOLD_CHUNK,
                      partitionable: bool = True):
    """Per-chunk PRNG keys int64[count, 2] for chunks [start, start+count)
    from a base key int64[2], by the registered algorithm `derive`."""
    check_chunk_start(start, derive)
    return _keys_for_ids(base, _chunk_ids(start, count, base.device), derive,
                         partitionable)


def expand_a_for_ids(ctx: CkksContext, a_seed: int, ids,
                     derive: int = DERIVE_FOLD_CHUNK):
    """Uniform `a` rows int32[len(ids), L, N] for explicit global chunk ids
    (int64 tensor, taken mod 2**32), in the layout `ctx` names.  Row r is
    randint(key_r, (L, N), 0, q_l per limb): one draw per row over the whole
    [L, N] block, so a row depends only on its own key and rows can be
    expanded in any grouping.  Runs under an `he.expand_a` span timed on
    the context's device."""
    with obs.span("he.expand_a", device=ctx.device, rows=len(ids)):
        base = threefry.prng_key(a_seed, ctx.device)
        ids = torch.as_tensor(ids, dtype=torch.int64).to(ctx.device)
        keys = _keys_for_ids(base, ids, derive, ctx.threefry_partitionable)
        l, n = ctx.n_limbs, ctx.n_poly
        qs = ctx.device_tables.qs.to(torch.int64)[:, None]
        out = torch.empty((ids.numel(), l, n), dtype=torch.int32,
                          device=ctx.device)
        step = max(1, _EXPAND_VALUES // (l * n))
        for r in range(0, ids.numel(), step):
            out[r:r + step] = threefry.randint_u32(
                keys[r:r + step], (l, n), qs, ctx.threefry_partitionable)
        return out


def expand_a_rows(ctx: CkksContext, a_seed: int, start: int, count: int,
                  derive: int = DERIVE_FOLD_CHUNK):
    """Deterministic uniform `a` rows [start, start+count) from a public
    seed: int32[count, L, N] in NTT domain, bit-identical to the JAX
    package's `expand_a_rows` in the threefry layout `ctx` names."""
    check_chunk_start(start, derive)
    return expand_a_for_ids(ctx, a_seed,
                            _chunk_ids(start, count, ctx.device), derive)


def expand_a(ctx: CkksContext, a_seed: int, batch: int,
             derive: int = DERIVE_FOLD_CHUNK):
    """Full-batch `a` expansion (rows 0..batch-1)."""
    return expand_a_rows(ctx, a_seed, 0, batch, derive)


# ---------------------------------------------------------------------------
# key generation
# ---------------------------------------------------------------------------


def keygen_from_samples(ctx: CkksContext, s_sym, a, e_sym):
    """(sk, pk) from a ternary secret s_sym int[N], uniform NTT-domain
    residues a int32[L, N] and gaussian noise e_sym int[N].

    sk = {"s_mont": int32[L, N]}               NTT-domain Montgomery secret
    pk = {"pk0_mont", "pk1_mont": int32[L, N]}  b = -(a s) + e, a
    """
    s = ops.ntt_fwd(centered_residues(s_sym, ctx), ctx)           # [L, N]
    s_mont = ops.to_mont(s, ctx)
    e = ops.ntt_fwd(centered_residues(e_sym, ctx), ctx)
    a_s = ops.mont_mul(a, s_mont, ctx)
    pk0 = ops.mod_add(ops.mod_neg(a_s, ctx), e, ctx)
    return ({"s_mont": s_mont},
            {"pk0_mont": ops.to_mont(pk0, ctx),
             "pk1_mont": ops.to_mont(a, ctx)})


def keygen(ctx: CkksContext, gen: torch.Generator) -> tuple[dict, dict]:
    """Returns (sk, pk) on the context's device, drawn from `gen` (not the
    JAX package's threefry stream: the same seed gives other keys)."""
    n = ctx.n_poly
    s_sym = sample_ternary(gen, (n,), ctx.device)
    a = sample_uniform(gen, (n,), ctx)
    e_sym = sample_gaussian(gen, (n,), ctx.device, ctx.error_sigma)
    return keygen_from_samples(ctx, s_sym, a, e_sym)


# ---------------------------------------------------------------------------
# encrypt / decrypt
# ---------------------------------------------------------------------------


def encrypt_coeffs_from_samples(ctx: CkksContext, pk: dict, m_coeff, u_sym,
                                e0_sym, e1_sym,
                                scale: float | None = None) -> Ciphertext:
    """Public-key encryption of pre-encoded residues with given draws.

    m_coeff: int32[B, L, N] coefficient-domain residues; u_sym: ternary
    int[B, N]; e0_sym, e1_sym: gaussian int[B, N].  Returns data
    int32[B, L, 2, N] with c0 = pk0 (*) u + e0 + m, c1 = pk1 (*) u + e1.
    """
    scale = float(scale if scale is not None else ctx.delta)
    m = ops.ntt_fwd(m_coeff, ctx)
    u = ops.ntt_fwd(centered_residues(u_sym, ctx), ctx)
    e0 = ops.ntt_fwd(centered_residues(e0_sym, ctx), ctx)
    e0m = ops.mod_add(e0, m, ctx)
    del e0, m
    c0 = ops.mul_add(u, pk["pk0_mont"][None], e0m, ctx)
    del e0m
    e1 = ops.ntt_fwd(centered_residues(e1_sym, ctx), ctx)
    c1 = ops.mul_add(u, pk["pk1_mont"][None], e1, ctx)
    del e1, u
    return Ciphertext(data=torch.stack([c0, c1], dim=-2), scale=scale)


def encrypt_coeffs(ctx: CkksContext, pk: dict, m_coeff, gen: torch.Generator,
                   scale: float | None = None) -> Ciphertext:
    """Public-key encryption of pre-encoded residues int32[B, L, N]; the
    (u, e0, e1) draws come from `gen`, not from the JAX package's per-chunk
    `fold_in` key stream."""
    b, n = m_coeff.shape[0], ctx.n_poly
    u = sample_ternary(gen, (b, n), ctx.device)
    e0 = sample_gaussian(gen, (b, n), ctx.device, ctx.error_sigma)
    e1 = sample_gaussian(gen, (b, n), ctx.device, ctx.error_sigma)
    return encrypt_coeffs_from_samples(ctx, pk, m_coeff, u, e0, e1, scale)


def encrypt_values(ctx: CkksContext, pk: dict, values,
                   gen: torch.Generator) -> Ciphertext:
    """values: float32[B, slots] -> fresh ciphertext (encode + encrypt)."""
    return encrypt_coeffs(ctx, pk, encoding.encode(values, ctx), gen,
                          scale=ctx.delta)


def encrypt_coeffs_seeded_from_samples(ctx: CkksContext, sk: dict, m_coeff,
                                       e_sym, a_seed: int,
                                       scale: float | None = None,
                                       derive: int = DERIVE_FOLD_CHUNK
                                       ) -> Ciphertext:
    """Secret-key encryption with a seed-expandable c1, given the noise.

    m_coeff: int32[B, L, N] coefficient-domain residues; e_sym: gaussian
    int[B, N].  c1 = a = expand_a_rows(ctx, a_seed, 0, B, derive) and
    c0 = -(a s) + e + m, so the wire needs only (a_seed, c0).  -(a s) is
    one mul_add with the negated secret: a (*) (q - s) is the canonical
    residue of -(a s R^-1), the same bits as the JAX package's
    mod_neg(mont_mul(a, s)).  `a_seed` must be unique per (client, round):
    reuse leaks m1 - m2."""
    a = expand_a_rows(ctx, a_seed, 0, m_coeff.shape[0], derive)  # [B, L, N]
    return encrypt_coeffs_seeded_with_a(ctx, sk, m_coeff, e_sym, a, scale)


def encrypt_coeffs_seeded_with_a(ctx: CkksContext, sk: dict, m_coeff,
                                 e_sym, a,
                                 scale: float | None = None) -> Ciphertext:
    """The seeded encrypt's arithmetic given its public rows a
    int32[B, L, N]: c0 = -(a s) + e + m, c1 = a (the sharded engine hands
    each block its slice of the rows expanded for every limb)."""
    scale = float(scale if scale is not None else ctx.delta)
    em = ops.mod_add(ops.ntt_fwd(centered_residues(e_sym, ctx), ctx),
                     ops.ntt_fwd(m_coeff, ctx), ctx)
    c0 = ops.mul_add(a, ops.mod_neg(sk["s_mont"], ctx)[None], em, ctx)
    del em
    return Ciphertext(data=torch.stack([c0, a], dim=-2), scale=scale)


def encrypt_coeffs_seeded(ctx: CkksContext, sk: dict, m_coeff,
                          gen: torch.Generator, a_seed: int,
                          scale: float | None = None,
                          derive: int = DERIVE_FOLD_CHUNK) -> Ciphertext:
    """Seeded secret-key encryption of int32[B, L, N] residues; the noise
    comes from `gen`, the public `a` from JAX's stream for `a_seed`."""
    e = sample_gaussian(gen, (m_coeff.shape[0], ctx.n_poly), ctx.device,
                        ctx.error_sigma)
    return encrypt_coeffs_seeded_from_samples(ctx, sk, m_coeff, e, a_seed,
                                              scale, derive)


def encrypt_values_seeded(ctx: CkksContext, sk: dict, values,
                          gen: torch.Generator, a_seed: int,
                          derive: int = DERIVE_FOLD_CHUNK) -> Ciphertext:
    """float32[B, slots] -> seeded secret-key ciphertext (encode + encrypt)."""
    return encrypt_coeffs_seeded(ctx, sk, encoding.encode(values, ctx), gen,
                                 a_seed, scale=ctx.delta, derive=derive)


def decrypt_to_coeffs(ctx: CkksContext, sk: dict, ct: Ciphertext):
    """-> int32[B, L, N] coefficient-domain residues of m + noise.  c0 and
    c1 are read in place from the interleaved ciphertext."""
    s = sk["s_mont"][: ct.n_limbs]
    phase = ops.mul_add(ct.c1, s[None], ct.c0, ctx)
    return ops.ntt_inv(phase, ctx)


def decrypt_values(ctx: CkksContext, sk: dict, ct: Ciphertext):
    """-> float32[B, slots] (torch decode path, 2 limbs)."""
    return encoding.decode(decrypt_to_coeffs(ctx, sk, ct), ctx, ct.scale)


def decrypt_values_np(ctx: CkksContext, sk: dict,
                      ct: Ciphertext) -> np.ndarray:
    """High-precision host decode (any limb count)."""
    coeffs = decrypt_to_coeffs(ctx, sk, ct).cpu().numpy().view(np.uint32)
    return encoding.decode_np(coeffs, ctx, ct.scale)


# ---------------------------------------------------------------------------
# homomorphic ops
# ---------------------------------------------------------------------------


def _limbs_to_minus2(data):
    """[..., L, 2, N] -> [..., 2, L, N] view: the limb-wise helpers
    broadcast per-limb constants over axis -2."""
    return data.movedim(-3, -2)


def _limbs_to_minus3(data):
    return data.movedim(-2, -3).contiguous()


def add(ctx: CkksContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    if abs(a.scale - b.scale) >= 1e-6 * a.scale:
        raise ValueError(f"scales differ: {a.scale} vs {b.scale}")
    out = ops.mod_add(_limbs_to_minus2(a.data), _limbs_to_minus2(b.data), ctx)
    return Ciphertext(data=_limbs_to_minus3(out), scale=a.scale)


def mul_plain_scalar(ctx: CkksContext, ct: Ciphertext, w: float) -> Ciphertext:
    """ct x plaintext scalar (encoded at delta): one multiplicative depth."""
    w_mont = encoding.encode_scalar_residues(w, ctx).view(np.int32)  # [L]
    wb = torch.from_numpy(w_mont.copy()).to(ct.data.device)[:, None]
    out = ops.mont_mul(_limbs_to_minus2(ct.data), wb[: ct.n_limbs], ctx)
    return Ciphertext(data=_limbs_to_minus3(out), scale=ct.scale * ctx.delta)


def mul_plain_vec(ctx: CkksContext, ct: Ciphertext, pt_mont) -> Ciphertext:
    """ct x plaintext vector; pt_mont: int32[L, N] NTT-domain Montgomery."""
    out = ops.mont_mul(_limbs_to_minus2(ct.data), pt_mont, ctx)
    return Ciphertext(data=_limbs_to_minus3(out), scale=ct.scale * ctx.delta)


def weighted_sum(ctx: CkksContext, cts: Ciphertext, weights) -> Ciphertext:
    """Fused FedAvg aggregation: sum_i w_i * ct_i over the leading axis.

    cts.data: int32[C, ..., L, 2, N]; weights: python floats, len C.  One
    kernel launch reads the stacked ciphertexts in their own layout.
    """
    w_mont = encoding.encode_weights_mont(weights, ctx).view(np.int32)
    w = torch.from_numpy(w_mont.copy()).to(cts.data.device)
    data = ops.weighted_sum(cts.data, w, ctx, limb_axis=-3)
    return Ciphertext(data=data, scale=cts.scale * ctx.delta)


def rescale(ctx: CkksContext, ct: Ciphertext) -> Ciphertext:
    """Drop the last RNS limb: c'_j = (c_j - lift(c_last)) * q_last^-1 mod
    q_j, the JAX package's `rescale` step for step.

    The last limb goes to the coefficient domain under q_last (one ntt_inv
    over that limb's tables), is lifted centered into every remaining
    Z_qj (the primes are within 2x of each other, so one conditional
    subtract reduces it) and comes back under the remaining limbs' NTT."""
    l = ct.n_limbs
    if l < 2:
        raise ValueError("rescale needs at least 2 limbs")
    n = ctx.n_poly
    q_last = ctx.primes[l - 1]
    t = ctx.device_tables
    last = slice(l - 1, l)
    flat = ct.data[..., l - 1, :, :].reshape(-1, 1, n).contiguous()
    c_last = _ntt.ntt_inv_fused(flat, t.psi_inv_rev_mont[last],
                                t.n_inv_monts[last], t.qs[last],
                                t.qinv_negs[last])           # [B', 1, N]
    qs = ctx.primes[: l - 1]
    col = lambda vals: torch.tensor(vals, dtype=torch.int32,  # noqa: E731
                                    device=ctx.device)[:, None]
    qjs = col(qs)                                             # [L-1, 1]
    need_sub = torch.tensor([q_last > q for q in qs],
                            device=ctx.device)[:, None]
    v_mod = torch.where(need_sub & (c_last >= qjs), c_last - qjs, c_last)
    lifted = torch.where((c_last > q_last // 2).expand(v_mod.shape),
                         ops.mod_sub(v_mod, col([q_last % q for q in qs]),
                                     ctx), v_mod)
    lifted_ntt = ops.ntt_fwd(lifted, ctx)                     # [B', L-1, N]
    cj = _limbs_to_minus2(ct.data[..., : l - 1, :, :]).reshape(-1, l - 1, n)
    diff = ops.mod_sub(cj, lifted_ntt, ctx)
    inv_mont = col([pow(q_last, -1, q) * (1 << 32) % q for q in qs])
    out = ops.mont_mul(diff, inv_mont, ctx)
    data = _limbs_to_minus3(out.reshape(ct.data.shape[:-3] + (2, l - 1, n)))
    return Ciphertext(data=data, scale=ct.scale / q_last)


def drop_limbs(ctx: CkksContext, ct: Ciphertext, keep: int) -> Ciphertext:
    """Rescale away trailing RNS limbs until only `keep` remain (lossy
    downlink compression: each dropped limb divides the scale by its
    prime)."""
    if not 1 <= keep <= ct.n_limbs:
        raise ValueError(f"cannot keep {keep} of {ct.n_limbs} limbs")
    while ct.n_limbs > keep:
        ct = rescale(ctx, ct)
    return ct
