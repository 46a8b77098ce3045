"""Transcipher (hybrid-HE) uplink: additive-masked updates that the server
unmasks into the seeded-ciphertext accumulator path (the JAX package's
`repro.core.ckks.transcipher`, DESIGN.md §15).

A thin client runs no NTT and no modular arithmetic: it masks its encoded
update with a keystream, and the server turns the masked words into the
ciphertext the seeded path would have sent.

  offline (the provisioner, any holder of sk, per client and round):
    seed    = a fresh SECRET 64-bit keystream seed, never derived from the
              wire-public a_seed
    K       = PRG(seed): pad words u32[B, N], uniform in [2^30, 3 * 2^30)
    D       = c0 of a seeded encryption of zero, minus NTT(K mod q)
            = (-s) (*) a + NTT(e - K mod q)            [B, L, N], the server's
    seed_ct = seeded encryption of the seed's four u16 digits (escrow)

  online (the client):
    masked  = encode_centered(values) + K, as u32 words  -> the wire

  server (kernels/lift.py, then the NTT):
    c0 = NTT(mod_lift(masked)) + D,  c1 = a = expand_a(a_seed)

Exactness: |c| < 2^30 is checked on the client, so masked = c + K lies in
[1, 2^32 - 2] with no u32 wrap, NTT((c + K) mod q) + D = NTT(c mod q) + c0
of the zero encryption, and the unmasked ciphertext equals the seeded
path's for the same noise bit for bit.

Where the port differs from the JAX package, on purpose:
  * the keystream seed and the noise come from a `torch.Generator` (secret
    material, it never crosses the wire); `provision_from_samples` takes
    them injected, which is how the tests hold D to JAX's;
  * D is one NTT of (e - K mod q) instead of NTT(e) + NTT(0) - NTT(K): the
    NTT is linear and every step exact, so the residues are the same;
  * the escrow message is encoded on the host in float64 (`encode_np`):
    the seed's digits reach 2^16, and the float32 device encode overflows
    int32 at delta = 2^26;
  * the zero encryption's `a` rows are the provisioned chunk rows
    [chunk_offset, chunk_offset + B), the rows the unmask expands; the JAX
    package draws rows [0, B), the same only when chunk_offset is 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import interop
from repro_torch.core.ckks import cipher, encoding, threefry
from repro_torch.core.ckks.cipher import DERIVE_CTR, Ciphertext
from repro_torch.core.ckks.params import CkksContext
from repro_torch.kernels import ops

# client-side centered coefficients must satisfy |c| < 2**BOUND_BITS; with
# the pad window below, masked = c + K spans [1, 2**32 - 2] with no u32 wrap
BOUND_BITS = 30
_PAD_LO = 1 << BOUND_BITS
_PAD_SPAN = 1 << 31           # pads are _PAD_LO + randint(0, 2**31)

# the escrow ciphertext's public a_seed lies above every update a_seed, so
# no public `a` stream is keyed twice
ESCROW_SEED_OFFSET = 1 << 40

# pad words per threefry batch: bounds its int64 temporaries
_PAD_VALUES = 1 << 25


def _u32_bits(v):
    """int64 u32 values -> int32 tensor with the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def expand_pad_rows(ctx: CkksContext, keystream_seed: int, start: int,
                    count: int, derive: int = DERIVE_CTR):
    """Keystream pad rows [start, start + count): int32[count, N] holding
    u32 words uniform in [2^30, 3 * 2^30), on ctx's device.

    Row i is 2^30 + randint(key_i, (N,), 0, 2^31) with key_i the derive
    registry's key for chunk start + i under the seed's raw key: the JAX
    package's `expand_pad_rows` bit for bit, in the threefry layout ctx
    names.  Any contiguous slice of rows can be re-derived on its own."""
    base = threefry.raw_key(keystream_seed, ctx.device)
    keys = cipher.derive_chunk_keys(base, start, count, derive,
                                    ctx.threefry_partitionable)
    n = ctx.n_poly
    out = torch.empty((count, n), dtype=torch.int32, device=ctx.device)
    step = max(1, _PAD_VALUES // n)
    for r in range(0, count, step):
        words = threefry.randint_u32(keys[r:r + step], (n,), _PAD_SPAN,
                                     ctx.threefry_partitionable)
        out[r:r + step] = _u32_bits(words + _PAD_LO)
    return out


def escrow_values(keystream_seed: int, ctx: CkksContext) -> np.ndarray:
    """The keystream seed's four u16 digits as a 1-chunk slot vector, what
    `seed_ct` encrypts (little-endian digits in slots 0..3)."""
    vals = np.zeros((1, ctx.slots), dtype=np.float32)
    for i in range(4):
        vals[0, i] = float((int(keystream_seed) >> (16 * i)) & 0xFFFF)
    return vals


@dataclasses.dataclass
class ClientMaterials:
    """What a thin client holds for one (client, round): the symmetric
    SECRET `keystream_seed` (it reaches the client over a confidential
    channel, never the aggregation wire) and the escrow ciphertext it
    forwards.  No CKKS secret key, and nothing that needs an NTT."""

    keystream_seed: int
    a_seed: int
    chunk_offset: int
    n_chunks: int
    derive: int
    scale: float
    seed_ct: Ciphertext          # escrow encryption of the keystream seed
    escrow_a_seed: int           # its a_seed (the wire seed-compresses it)


@dataclasses.dataclass
class ServerMaterials:
    """What the aggregator holds: D = c0_zero - NTT(K), int32[B, L, N] in
    the NTT domain, and the public stream's parameters.  D hides K under an
    encryption of zero, so it reveals neither the pad nor an update."""

    d: torch.Tensor
    a_seed: int
    chunk_offset: int
    n_chunks: int
    derive: int
    scale: float


def provision(ctx: CkksContext, sk: dict, gen: torch.Generator, a_seed: int,
              n_chunks: int, *, chunk_offset: int = 0,
              derive: int = DERIVE_CTR, scale: float | None = None,
              keystream_seed: int | None = None
              ) -> tuple[ClientMaterials, ServerMaterials]:
    """Offline set-up for one (client, round): draw a fresh secret keystream
    seed, build the server's D and escrow-encrypt the seed.

    Draws from `gen` (on ctx's device), in this order: the zero
    encryption's gaussian noise [n_chunks, N], the escrow's [1, N], and,
    unless `keystream_seed` is given (established out of band), the seed as
    four uniform u16 digits.  The seed must never be derived from a_seed or
    any other wire-visible value: a_seed rides in clear in every masked
    frame."""
    n, sigma = ctx.n_poly, ctx.error_sigma
    e = cipher.sample_gaussian(gen, (n_chunks, n), ctx.device, sigma)
    escrow_e = cipher.sample_gaussian(gen, (1, n), ctx.device, sigma)
    if keystream_seed is None:
        digits = torch.randint(0, 1 << 16, (4,), generator=gen,
                               device=ctx.device).tolist()
        keystream_seed = sum(int(d) << (16 * i) for i, d in enumerate(digits))
    return provision_from_samples(ctx, sk, e, escrow_e, keystream_seed,
                                  a_seed, chunk_offset=chunk_offset,
                                  derive=derive, scale=scale)


def provision_from_samples(ctx: CkksContext, sk: dict, e_sym, escrow_e_sym,
                           keystream_seed: int, a_seed: int, *,
                           chunk_offset: int = 0, derive: int = DERIVE_CTR,
                           scale: float | None = None
                           ) -> tuple[ClientMaterials, ServerMaterials]:
    """`provision` with its draws given: e_sym gaussian int[B, N] (the zero
    encryption's noise), escrow_e_sym int[1, N] and the keystream seed.
    D equals the JAX package's for the same noise and seed; the unmasked
    ciphertexts then equal `encrypt_coeffs_seeded_from_samples` with e_sym
    and a_seed, bit for bit."""
    scale = float(scale if scale is not None else ctx.delta)
    keystream_seed = int(keystream_seed)
    if not 0 <= keystream_seed < 1 << 64:
        raise ValueError(
            f"keystream_seed must fit the escrow encoding's 64 bits, got "
            f"{keystream_seed}")
    n_chunks = int(e_sym.shape[0])
    a = cipher.expand_a_rows(ctx, a_seed, chunk_offset, n_chunks, derive)
    pad = expand_pad_rows(ctx, keystream_seed, chunk_offset, n_chunks, derive)
    e_minus_k = ops.mod_sub(cipher.centered_residues(e_sym, ctx),
                            ops.mod_lift(pad, ctx.n_limbs, ctx), ctx)
    del pad
    d = ops.mul_add(a, ops.mod_neg(sk["s_mont"], ctx)[None],
                    ops.ntt_fwd(e_minus_k, ctx), ctx)
    del a, e_minus_k
    escrow_a_seed = int(a_seed) + ESCROW_SEED_OFFSET
    m = encoding.encode_np(escrow_values(keystream_seed, ctx), ctx)
    seed_ct = cipher.encrypt_coeffs_seeded_from_samples(
        ctx, sk, interop.residues_from_np(m, ctx.device), escrow_e_sym,
        escrow_a_seed, scale=ctx.delta, derive=derive)
    common = dict(a_seed=int(a_seed), chunk_offset=int(chunk_offset),
                  n_chunks=n_chunks, derive=int(derive), scale=scale)
    return (ClientMaterials(keystream_seed=keystream_seed, seed_ct=seed_ct,
                            escrow_a_seed=escrow_a_seed, **common),
            ServerMaterials(d=d, **common))


# ---------------------------------------------------------------------------
# client online path: no NTT, no modular arithmetic
# ---------------------------------------------------------------------------


def mask_coeffs_centered(ctx: CkksContext, cm: ClientMaterials,
                         c_int) -> np.ndarray:
    """Centered coefficients i64[B, N] -> masked u32[B, N] for the wire.

    The one check a thin client must make: |c| < 2**BOUND_BITS, so that
    c + K cannot wrap u32 (exactness would die silently otherwise).  The
    pad is expanded and added on ctx's device."""
    c_int = np.asarray(c_int, dtype=np.int64)
    if c_int.shape[0] != cm.n_chunks:
        raise ValueError(
            f"masked update has {c_int.shape[0]} chunks but the provisioned "
            f"materials cover {cm.n_chunks}; re-provision for this shape")
    amax = int(np.max(np.abs(c_int))) if c_int.size else 0
    if amax >= (1 << BOUND_BITS):
        raise ValueError(
            f"centered coefficient magnitude {amax} >= 2**{BOUND_BITS}; "
            f"the transcipher pad window cannot absorb it -- lower the "
            f"encoding delta or the update norm (DESIGN.md §15)")
    pad = expand_pad_rows(ctx, cm.keystream_seed, cm.chunk_offset,
                          c_int.shape[0], cm.derive)
    masked = (pad.to(torch.int64) & threefry.M32) + torch.from_numpy(
        c_int).to(ctx.device)            # in [1, 2**32 - 2], exact
    return interop.residues_to_np(_u32_bits(masked))


def mask_values(ctx: CkksContext, cm: ClientMaterials,
                values) -> np.ndarray:
    """float32[B, slots] update (array or tensor) -> masked u32[B, N]: the
    whole client-side encrypt is one float64 FFT, a rint and an add."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    c_int = encoding.encode_centered(np.asarray(values, dtype=np.float32),
                                     ctx, cm.scale)
    return mask_coeffs_centered(ctx, cm, c_int)


# ---------------------------------------------------------------------------
# server transcipher: lift + NTT + D, then the seeded ciphertext's shape
# ---------------------------------------------------------------------------


def unmask_c0(ctx: CkksContext, sm: ServerMaterials, masked, d_rows):
    """c0 = NTT(mod_lift(masked)) + D[d_rows] for masked words int32[K, N]
    on ctx's device: one mod_lift and one ntt_fwd launch for all K rows.
    d_rows: D's row indices (an int64 tensor) or a slice."""
    l = sm.d.shape[-2]
    return ops.mod_add(ops.ntt_fwd(ops.mod_lift(masked, l, ctx), ctx),
                       sm.d[d_rows], ctx)


def server_unmask(ctx: CkksContext, sm: ServerMaterials, masked_rows,
                  chunk_idx: int) -> Ciphertext:
    """Masked u32[B, N] rows starting at global chunk `chunk_idx` -> the
    seeded-equivalent ciphertext int32[B, L, 2, N]: c0 from `unmask_c0`, c1
    the public `a` rows of those chunks.  The bits equal the seeded path's
    for the provisioning noise, so the result drops into StreamIngest."""
    x = interop.residues_from_np(masked_rows, ctx.device)
    b = int(x.shape[0])
    r0 = int(chunk_idx) - sm.chunk_offset
    if r0 < 0 or r0 + b > sm.n_chunks:
        raise ValueError(
            f"chunk rows [{chunk_idx}, {chunk_idx + b}) fall outside the "
            f"provisioned range [{sm.chunk_offset}, "
            f"{sm.chunk_offset + sm.n_chunks})")
    c0 = unmask_c0(ctx, sm, x, slice(r0, r0 + b))
    a = cipher.expand_a_rows(ctx, sm.a_seed, chunk_idx, b, sm.derive)
    return Ciphertext(data=torch.stack([c0, a], dim=-2), scale=sm.scale)


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------


def masked_uplink_bytes(n_chunks: int, n_poly: int) -> int:
    """Payload bytes of a masked update: 4 B a coefficient, no limbs."""
    return n_chunks * n_poly * 4


def seeded_uplink_bytes(n_chunks: int, n_limbs: int, n_poly: int) -> int:
    """Payload bytes of a seeded update's c0: L x 4 B a coefficient."""
    return n_chunks * n_limbs * n_poly * 4
