"""RNS-CKKS cipher: keygen / encrypt / decrypt / homomorphic ops.

Ciphertexts are int32[..., L, 2, N] tensors in bit-reversed NTT domain,
wrapped with their scale.  Every random step is split in two:

  * a sampler draws the random symbols from an explicit `torch.Generator`
    (ternary symbols in {-1, 0, 1}, rounded gaussians, uniform residues);
  * a `*_from_samples` body does the arithmetic on those draws.

The tests feed the same numpy-made draws to a body here and to the same
composition of the JAX package's ops, and compare bits.  The JAX key stream
(threefry, one `fold_in` per chunk) is not reproduced: a generator gives
other numbers than a JAX key of the same seed.

Scale discipline (depth 1, the paper's setting): a fresh ciphertext has
scale delta; after the plaintext-scalar weighting it has delta**2, and
decode divides by it (no rescale).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.ckks import encoding
from repro_torch.core.ckks.params import CkksContext
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


def weighted_sum(ctx: CkksContext, cts: Ciphertext, weights) -> Ciphertext:
    """Fused FedAvg aggregation: sum_i w_i * ct_i over the leading axis.

    cts.data: int32[C, ..., L, 2, N]; weights: python floats, len C.  One
    kernel launch reads the stacked ciphertexts in their own layout.
    """
    w_mont = encoding.encode_weights_mont(weights, ctx).view(np.int32)
    w = torch.from_numpy(w_mont.copy()).to(cts.data.device)
    data = ops.weighted_sum(cts.data, w, ctx, limb_axis=-3)
    return Ciphertext(data=data, scale=cts.scale * ctx.delta)
