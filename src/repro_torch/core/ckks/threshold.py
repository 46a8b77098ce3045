"""Threshold CKKS keys (paper §2.2, Appendix B), the JAX package's
`repro.core.ckks.threshold` on int32 residues.

Two variants:
  * additive n-of-n: party i holds s_i with s = sum_i s_i; the joint pk is
    made from a common random `a` (b_i = -(a s_i) + e_i, b = sum_i b_i);
    decryption adds the parties' partial decryptions d_i = c1 (*) s_i +
    e_smudge to c0.
  * Shamir t-of-n: the coefficients of s are secret-shared over each limb
    field; any t parties decrypt, each folding its Lagrange coefficient at
    zero into its partial decryption.

Smudging noise (sigma_smudge >> sigma_err) hides each party's share in its
partial decryption (Asharov et al., 2012).

As in `cipher`, every random step is a sampler that draws from a
`torch.Generator` and a `*_from_samples` body that does the arithmetic on
the draws: ternary symbols int[..., N] in {-1, 0, 1}, rounded gaussians
int[..., N], uniform residues int32[..., L, N].  The tests feed the bodies
the draws the JAX package's key schedule makes and compare bits.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.ckks import cipher
from repro_torch.core.ckks.cipher import Ciphertext
from repro_torch.core.ckks.params import CkksContext
from repro_torch.kernels import ops

DEFAULT_SMUDGE_SIGMA = 2.0 ** 12


def _limb_column(ctx: CkksContext, vals) -> torch.Tensor:
    """Per-limb constants (each below its q < 2**30) as int32[L, 1]."""
    return torch.tensor(vals, dtype=torch.int32, device=ctx.device)[:, None]


# ---------------------------------------------------------------------------
# additive n-of-n
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ThresholdParty:
    index: int
    s_mont: torch.Tensor    # int32[L, N] NTT-domain Montgomery share


def threshold_keygen_from_samples(ctx: CkksContext, a, s_syms, e_syms
                                  ) -> tuple[list[ThresholdParty], dict]:
    """Additive keygen from the common uniform a int32[L, N] and each
    party's ternary secret s_syms[i] and gaussian noise e_syms[i] (int[N]
    each).  Returns (parties, joint pk)."""
    a_mont = ops.to_mont(a, ctx)
    parties, b_sum = [], None
    for i in range(len(s_syms)):
        s_i = ops.ntt_fwd(cipher.centered_residues(s_syms[i], ctx), ctx)
        s_i_mont = ops.to_mont(s_i, ctx)
        e_i = ops.ntt_fwd(cipher.centered_residues(e_syms[i], ctx), ctx)
        b_i = ops.mod_add(ops.mod_neg(ops.mont_mul(a, s_i_mont, ctx), ctx),
                          e_i, ctx)
        b_sum = b_i if b_sum is None else ops.mod_add(b_sum, b_i, ctx)
        parties.append(ThresholdParty(index=i, s_mont=s_i_mont))
    return parties, {"pk0_mont": ops.to_mont(b_sum, ctx), "pk1_mont": a_mont}


def threshold_keygen(ctx: CkksContext, gen: torch.Generator, n_parties: int
                     ) -> tuple[list[ThresholdParty], dict]:
    """Interactive additive keygen with draws from `gen`."""
    n = ctx.n_poly
    a = cipher.sample_uniform(gen, (n,), ctx)
    s = cipher.sample_ternary(gen, (n_parties, n), ctx.device)
    e = cipher.sample_gaussian(gen, (n_parties, n), ctx.device,
                               ctx.error_sigma)
    return threshold_keygen_from_samples(ctx, a, s, e)


def _smudge(ctx: CkksContext, ct: Ciphertext, gen: torch.Generator,
            sigma: float):
    return cipher.sample_gaussian(gen, (ct.data.shape[0], ctx.n_poly),
                                  ctx.device, sigma)


def partial_decrypt_from_samples(ctx: CkksContext, party: ThresholdParty,
                                 ct: Ciphertext, e_sym):
    """d_i = c1 (*) s_i + e (NTT domain), e_sym int[B, N] the smudging
    noise of ct's B rows."""
    e = ops.ntt_fwd(cipher.centered_residues(e_sym, ctx), ctx)
    return ops.mul_add(ct.c1, party.s_mont[: ct.n_limbs][None], e, ctx)


def partial_decrypt(ctx: CkksContext, party: ThresholdParty, ct: Ciphertext,
                    gen: torch.Generator,
                    smudge_sigma: float = DEFAULT_SMUDGE_SIGMA):
    """One party's partial decryption, its smudging noise from `gen`."""
    return partial_decrypt_from_samples(ctx, party, ct,
                                        _smudge(ctx, ct, gen, smudge_sigma))


def combine_partials(ctx: CkksContext, ct: Ciphertext, partials: list):
    """m~ = c0 + sum_i d_i -> coefficient-domain residues int32[B, L, N]."""
    acc = ct.c0
    for d in partials:
        acc = ops.mod_add(acc, d, ctx)
    return ops.ntt_inv(acc.contiguous(), ctx)


# ---------------------------------------------------------------------------
# Shamir t-of-n
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShamirParty:
    index: int              # evaluation point x = index + 1
    share: torch.Tensor     # int32[L, N] NTT-domain share of s (normal form)


def shamir_share_secret_from_samples(ctx: CkksContext, sk: dict, coeffs,
                                     n_parties: int, threshold: int
                                     ) -> list[ShamirParty]:
    """Shares of sk's secret: party i holds s + sum_k coeffs[k] x^(k+1) at
    x = i + 1, with coeffs the threshold - 1 uniform polynomials
    int32[L, N] of the sharing."""
    if len(coeffs) != threshold - 1:
        raise ValueError(f"a {threshold}-of-{n_parties} sharing needs "
                         f"{threshold - 1} coefficient polynomials, got "
                         f"{len(coeffs)}")
    s = ops.from_mont(sk["s_mont"], ctx)           # [L, N] normal form
    parties = []
    for i in range(n_parties):
        x = i + 1
        acc = s
        for k, c in enumerate(coeffs):
            x_pow_mont = _limb_column(
                ctx, [pow(x, k + 1, q) * (1 << 32) % q for q in ctx.primes])
            acc = ops.mod_add(acc, ops.mont_mul(c, x_pow_mont, ctx), ctx)
        parties.append(ShamirParty(index=i, share=acc))
    return parties


def shamir_share_secret(ctx: CkksContext, sk: dict, gen: torch.Generator,
                        n_parties: int, threshold: int) -> list[ShamirParty]:
    """Split sk into Shamir shares over each limb field, the sharing's
    polynomials drawn from `gen`."""
    coeffs = cipher.sample_uniform(gen, (threshold - 1, ctx.n_poly), ctx)
    return shamir_share_secret_from_samples(ctx, sk, list(coeffs), n_parties,
                                            threshold)


def _lagrange_at_zero(indices: list[int], q: int) -> list[int]:
    """lambda_j = prod_{m != j} x_m / (x_m - x_j) mod q (x = index+1)."""
    lams = []
    xs = [i + 1 for i in indices]
    for j, xj in enumerate(xs):
        num, den = 1, 1
        for m, xm in enumerate(xs):
            if m == j:
                continue
            num = num * xm % q
            den = den * ((xm - xj) % q) % q
        lams.append(num * pow(den, -1, q) % q)
    return lams


def shamir_partial_decrypt_from_samples(ctx: CkksContext, party: ShamirParty,
                                        active_indices: list[int],
                                        ct: Ciphertext, e_sym):
    """d_j = c1 (*) (lambda_j share_j) + e for the active subset, e_sym
    int[B, N] the smudging noise of ct's B rows."""
    pos = active_indices.index(party.index)
    lam_mont = _limb_column(
        ctx, [_lagrange_at_zero(active_indices, q)[pos] * (1 << 32) % q
              for q in ctx.primes])
    lam_share = ops.mont_mul(party.share, lam_mont, ctx)       # normal form
    lam_share_mont = ops.to_mont(lam_share, ctx)
    e = ops.ntt_fwd(cipher.centered_residues(e_sym, ctx), ctx)
    return ops.mul_add(ct.c1, lam_share_mont[: ct.n_limbs][None], e, ctx)


def shamir_partial_decrypt(ctx: CkksContext, party: ShamirParty,
                           active_indices: list[int], ct: Ciphertext,
                           gen: torch.Generator,
                           smudge_sigma: float = DEFAULT_SMUDGE_SIGMA):
    """One active party's partial decryption, its smudging noise from
    `gen`; combine_partials adds the active subset's partials."""
    return shamir_partial_decrypt_from_samples(
        ctx, party, active_indices, ct, _smudge(ctx, ct, gen, smudge_sigma))
