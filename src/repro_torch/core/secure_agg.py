"""Algorithm 1: HE-based federated aggregation with Selective Parameter
Encryption.

Data flow per round (single-key setup):

  client:  vec = flatten(W_i)
           enc, plain = split_by_mask(vec, partition)
           ct_i = Enc(pk, encode(enc))                        # [n_chunks] cts
           (optional) plain += Laplace(b)
  server:  ct_glob   = sum_i alpha_i (*) ct_i   # one weighted_sum launch
           plain_glob = sum_i alpha_i * plain_i               # plaintext
  client:  enc_glob = decode(Dec(sk, ct_glob))
           W_glob = unflatten(merge(enc_glob, plain_glob))

Over the wire (repro_torch.wire) the client encrypts with the seeded
secret-key path instead (`client_protect_seeded`): c1 is regenerated from a
public seed, so the client ships (seed, c0), and the server folds the
arriving chunks with `wire.StreamIngest`.  A thin client masks its update
with a provisioned keystream instead (`client_protect_transcipher`,
core/ckks/transcipher.py), and the server's StreamIngest unmasks it.

Everything runs on the context's device, or, with `sharded=` (a
core.ckks.sharded.ShardedHe), over its mesh: ciphertext chunks along
`data`, RNS limbs along `model`, bit-identical to the single-device path.
A sharded result holds its ciphertext as a BlockGrid; `client_recover`
decrypts it through the same engine.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import dp, packing, selection
from repro_torch.core.ckks import cipher, encoding, sharded as _sharded
from repro_torch.core.ckks import transcipher
from repro_torch.core.ckks.cipher import Ciphertext
from repro_torch.core.ckks.params import CkksContext
from repro_torch.core.packing import FlatSpec, MaskPartition


@dataclasses.dataclass
class ProtectedUpdate:
    """One client's outgoing update: encrypted chunks + plaintext rest."""

    ct: Ciphertext          # data int32[n_chunks, L, 2, N]
    plain: torch.Tensor     # float32[n_plain]


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    p_ratio: float = 0.1
    strategy: str = "top_p"  # top_p | random | per_layer | recipe | all | none
    dp_b: float = 0.0        # Laplace scale on plaintext part (0 = off)
    seed: int = 0


class SelectiveHEAggregator:
    """Glue object owning (ctx, partition, flat spec)."""

    def __init__(self, ctx: CkksContext, spec: FlatSpec,
                 part: MaskPartition, cfg: AggregatorConfig):
        self.ctx = ctx
        self.spec = spec
        self.part = part
        self.cfg = cfg

    @staticmethod
    def build(ctx: CkksContext, params, sens_vec,
              cfg: AggregatorConfig) -> "SelectiveHEAggregator":
        """The mask is computed on the context's device."""
        spec = packing.make_flat_spec(params)
        sens = torch.as_tensor(sens_vec).to(ctx.device)
        mask = selection.build_mask(sens, cfg.strategy, cfg.p_ratio,
                                    offsets=spec.offsets, sizes=spec.sizes,
                                    seed=cfg.seed)
        part = packing.make_partition(mask, ctx.slots)
        return SelectiveHEAggregator(ctx, spec, part, cfg)

    # -- client side ---------------------------------------------------------

    def client_protect(self, params, pk: dict, gen: torch.Generator,
                       sharded=None) -> ProtectedUpdate:
        vec, _ = packing.flatten_params(params)
        return self.client_protect_vec(vec, pk, gen, sharded=sharded)

    def client_protect_vec(self, vec, pk: dict, gen: torch.Generator,
                           sharded=None) -> ProtectedUpdate:
        """Protect one flat update vector: encode + encrypt the masked part
        (draws from `gen`), then the optional Laplace noise (from `gen`).
        With `sharded` (a ShardedHe) the encrypt runs over its mesh with
        the same draws, bit-identical to the single-device path."""
        enc_vals, plain = packing.split_by_mask(
            vec.to(self.ctx.device), self.part)
        if sharded is not None:
            ct = sharded.encrypt_values(pk, enc_vals, gen)
        else:
            ct = cipher.encrypt_values(self.ctx, pk, enc_vals, gen)
        if self.cfg.dp_b > 0:
            plain = dp.laplace_noise_vec(plain, gen, self.cfg.dp_b)
        return ProtectedUpdate(ct=ct, plain=plain)

    def client_protect_seeded(self, params, sk: dict, gen: torch.Generator,
                              a_seed: int, sharded=None,
                              derive: int = cipher.DERIVE_FOLD_CHUNK
                              ) -> ProtectedUpdate:
        """client_protect through the seeded secret-key encrypt: c1 is
        JAX's public stream for `a_seed`, so `wire.seed_compress` can ship
        (seed, c0) and halve the ciphertext bytes.  `a_seed` must be unique
        per (client, round); `derive` is the per-chunk seed-derivation id
        the wire advertises.  The noise (and the optional Laplace noise on
        the plaintext part) comes from `gen`.  With `sharded` the encrypt
        runs over its mesh (ShardedHe.encrypt_values_seeded), with the same
        bits."""
        vec, _ = packing.flatten_params(params)
        enc_vals, plain = packing.split_by_mask(
            vec.to(self.ctx.device), self.part)
        del vec
        if sharded is not None:
            ct = sharded.encrypt_values_seeded(sk, enc_vals, gen, a_seed,
                                               derive=derive)
        else:
            ct = cipher.encrypt_values_seeded(self.ctx, sk, enc_vals, gen,
                                              a_seed, derive=derive)
        if self.cfg.dp_b > 0:
            plain = dp.laplace_noise_vec(plain, gen, self.cfg.dp_b)
        return ProtectedUpdate(ct=ct, plain=plain)

    def client_protect_transcipher(self, params,
                                   cm: transcipher.ClientMaterials,
                                   gen: torch.Generator):
        """Thin-client protect: mask the encrypted partition with the
        provisioned keystream, no NTT and no RNS arithmetic on the client.

        Returns (masked u32[n_chunks, N] numpy, plain float32 tensor); the
        wire layer frames them with the escrow ciphertext of `cm`
        (wire.stream.pack_masked_update_frames).  `gen` draws the optional
        Laplace noise on the plaintext part."""
        vec, _ = packing.flatten_params(params)
        enc_vals, plain = packing.split_by_mask(
            vec.to(self.ctx.device), self.part)
        del vec
        masked = transcipher.mask_values(self.ctx, cm, enc_vals)
        if self.cfg.dp_b > 0:
            plain = dp.laplace_noise_vec(plain, gen, self.cfg.dp_b)
        return masked, plain

    def client_recover(self, agg: ProtectedUpdate, sk: dict, sharded=None):
        """Decrypt + merge -> flat global vector.  With `sharded` the
        decrypt runs over its mesh and gathers the limb shards once (the
        ciphertext may be a BlockGrid from a sharded aggregate)."""
        if sharded is not None:
            coeffs = sharded.decrypt_to_coeffs(sk, agg.ct)
        else:
            coeffs = cipher.decrypt_to_coeffs(self.ctx, sk, agg.ct)
        enc = decode_coeffs(self.ctx, coeffs, agg.ct.scale)
        return packing.merge_by_mask(enc, agg.plain, self.part)

    def client_recover_params(self, agg: ProtectedUpdate, sk: dict,
                              sharded=None):
        return packing.unflatten_params(
            self.client_recover(agg, sk, sharded=sharded), self.spec)

    # -- server side ---------------------------------------------------------

    def server_aggregate(self, updates: Sequence[ProtectedUpdate],
                         weights: Sequence[float],
                         sharded=None) -> ProtectedUpdate:
        """sum_i alpha_i [[enc_i]]  +  sum_i alpha_i plain_i.

        With `sharded` (a ShardedHe) the HE aggregation runs over its mesh
        (chunks -> data axis, limbs -> model axis), one weighted_sum launch
        per block, bit-identical to the single-device path; the updates'
        ciphertexts may be tensors or BlockGrids of one layout.

        Returns the aggregated update (ct scale = in_scale * delta)."""
        cts = Ciphertext(data=_sharded.stack([u.ct.data for u in updates]),
                         scale=updates[0].ct.scale)
        if sharded is not None:
            ct_glob = sharded.weighted_sum(cts, list(weights))
        else:
            ct_glob = cipher.weighted_sum(self.ctx, cts, list(weights))
        del cts
        w = torch.tensor(list(weights), dtype=torch.float32,
                         device=self.ctx.device)
        plain_glob = torch.einsum("c,cp->p", w,
                                  torch.stack([u.plain for u in updates]))
        return ProtectedUpdate(ct=ct_glob, plain=plain_glob)

    # -- reporting (paper's overhead tables) ---------------------------------

    def overhead_report(self) -> dict:
        part = self.part
        ct_bytes = self.ctx.encrypted_bytes(part.n_enc)
        pt_bytes = self.ctx.plaintext_bytes(part.n_plain)
        return {
            "n_total": part.n_total,
            "n_enc": part.n_enc,
            "ratio": part.ratio,
            "n_ciphertexts": part.n_chunks,
            "bytes_encrypted": ct_bytes,
            "bytes_plain": pt_bytes,
            "bytes_total": ct_bytes + pt_bytes,
            "bytes_all_plain": self.ctx.plaintext_bytes(part.n_total),
            "comm_ratio": (ct_bytes + pt_bytes)
                          / max(1, self.ctx.plaintext_bytes(part.n_total)),
        }


# ---------------------------------------------------------------------------
# encryption-mask agreement (paper §2.4 Step 2, Figure 4)
# ---------------------------------------------------------------------------


# The most ciphertexts a client encrypts at once in agree_sensitivity: the
# in-memory round's row count at Qwen1.5-0.5B width, three clients of which
# an 80 GB card is known to hold.  At that width a map is 113,279
# ciphertexts, 14.85 GB a client, so the maps fold in 10 blocks.
SENSITIVITY_BLOCK_ROWS = 11_328


def decode_coeffs(ctx: CkksContext, coeffs, scale: float):
    """Decrypted coefficient residues int32[B, L, N] -> float32[B, slots] on
    ctx's device: the torch decode at 2 limbs; any other limb count goes
    through the host path."""
    if coeffs.shape[1] == 2:
        return encoding.decode(coeffs, ctx, scale)
    return torch.from_numpy(encoding.decode_np(
        coeffs.cpu().numpy().view(np.uint32), ctx, scale)).to(
            torch.float32).to(ctx.device)


def agree_sensitivity(ctx: CkksContext, pk: dict, sk: dict,
                      local_sens_vecs, weights: Sequence[float],
                      gen: torch.Generator):
    """HE-aggregate the clients' local sensitivity maps -> global map, a
    float32 tensor on the context's device.  Each client encrypts its map
    under pk; the server weighted-sums the ciphertexts; the decrypted
    aggregate is the shared global sensitivity.

    The maps fold in blocks of at most SENSITIVITY_BLOCK_ROWS ciphertexts:
    for each block every client's rows are encoded and encrypted on the
    card, weighted-summed, decrypted and decoded, and only the decoded
    floats outlive the block (the JAX package encrypts whole maps, which at
    Qwen1.5-0.5B width would hold 44.5 GB of ciphertexts for three
    clients).  The result is the same function: the weighted mean of the
    maps within the CKKS error."""
    vecs = [torch.as_tensor(s).reshape(-1).to(ctx.device, torch.float32)
            for s in local_sens_vecs]
    n, slots = vecs[0].numel(), ctx.slots
    n_chunks = -(-n // slots)
    out = torch.empty(n, dtype=torch.float32, device=ctx.device)
    for r0 in range(0, n_chunks, SENSITIVITY_BLOCK_ROWS):
        rows = min(n_chunks - r0, SENSITIVITY_BLOCK_ROWS)
        lo, hi = r0 * slots, min(n, (r0 + rows) * slots)
        cts = None
        for k, v in enumerate(vecs):
            buf = torch.zeros(rows * slots, dtype=torch.float32,
                              device=ctx.device)
            buf[: hi - lo] = v[lo:hi]
            ct = cipher.encrypt_values(ctx, pk, buf.reshape(rows, slots),
                                       gen)
            del buf
            if cts is None:   # the clients' rows in one buffer: no stack
                cts = torch.empty((len(vecs), *ct.data.shape),
                                  dtype=ct.data.dtype, device=ctx.device)
            cts[k] = ct.data
            scale = ct.scale
            del ct
        agg = cipher.weighted_sum(ctx, Ciphertext(data=cts, scale=scale),
                                  list(weights))
        del cts
        coeffs = cipher.decrypt_to_coeffs(ctx, sk, agg)
        out[lo:hi] = decode_coeffs(ctx, coeffs, agg.scale).reshape(-1)[
            : hi - lo]
        del agg, coeffs
    return out


def agree_mask(ctx: CkksContext, pk: dict, sk: dict, local_sens_vecs,
               weights: Sequence[float], p: float, gen: torch.Generator, *,
               strategy: str = "top_p", offsets=None, sizes=None,
               seed: int = 0):
    """Clients encrypt local sensitivity maps; the server HE-aggregates
    them; clients decrypt the aggregate and derive the selection mask
    (bool tensor on the context's device)."""
    s_glob = agree_sensitivity(ctx, pk, sk, local_sens_vecs, weights, gen)
    return selection.build_mask(s_glob, strategy, p, offsets=offsets,
                                sizes=sizes, seed=seed)
