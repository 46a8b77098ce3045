"""Carry state between the JAX package and this port.

The JAX package holds residues as u32 arrays; the port holds them as int32
tensors with the same bits.  These functions take and give numpy arrays
(`np.asarray` of JAX outputs), so this module imports no JAX: keys,
threshold and Shamir key shares, ciphertexts, protected and seeded updates
and context primes cross over unchanged, and so do a JAX
`transcipher.provision`'s materials, so the port ingests masked blobs of a
JAX-provisioned client.  A `StreamIngest` checkpoint needs no converter:
its `export_state` arrays have the JAX package's layout in both packages,
and `repro_torch.ckpt` writes the JAX package's checkpoint format.
Model parameters and AdamW state cross with `params_from_np` and
`params_to_np`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.ckks.cipher import DERIVE_FOLD_CHUNK, Ciphertext
from repro_torch.core.ckks.params import CkksContext


def residues_from_np(arr, device) -> torch.Tensor:
    """u32 numpy residues -> int32 tensor (same bits) on `device`; an int32
    tensor is only moved."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype != torch.int32:
            raise TypeError(f"expected int32 residues, got {arr.dtype}")
        return arr.to(device)
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def residues_to_np(t) -> np.ndarray:
    """int32 tensor -> u32 numpy residues (same bits); an array goes
    through np.asarray(t, uint32)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t, dtype=np.uint32)
    if t.dtype != torch.int32:
        raise TypeError(f"expected int32 residues, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def keys_from_np(keys: dict, device) -> dict:
    """sk {"s_mont"} or pk {"pk0_mont", "pk1_mont"} dict of u32 arrays ->
    the port's dict of int32 tensors."""
    return {k: residues_from_np(v, device) for k, v in keys.items()}


def keys_to_np(keys: dict) -> dict:
    return {k: residues_to_np(v) for k, v in keys.items()}


def ciphertext_from_np(data, scale: float, device) -> Ciphertext:
    """A JAX `Ciphertext`'s u32 data [..., L, 2, N] and scale -> the port's
    `Ciphertext`."""
    return Ciphertext(data=residues_from_np(data, device), scale=float(scale))


def ciphertext_to_np(ct: Ciphertext) -> tuple[np.ndarray, float]:
    """-> (u32 data, scale), the fields of a JAX `Ciphertext`."""
    return residues_to_np(ct.data), float(ct.scale)


def protected_update_from_np(data, scale: float, plain, device):
    """A JAX `ProtectedUpdate`'s ct (u32 data, scale) and float32 plain ->
    the port's ProtectedUpdate on `device`."""
    # imported here: secure_agg imports transcipher, which imports this
    from repro_torch.core.secure_agg import ProtectedUpdate
    return ProtectedUpdate(
        ct=ciphertext_from_np(data, scale, device),
        plain=torch.from_numpy(np.asarray(plain, dtype=np.float32).copy())
        .to(device))


def protected_update_to_np(upd: ProtectedUpdate):
    """-> (u32 data, scale, float32 plain), the fields of a JAX
    ProtectedUpdate."""
    data, scale = ciphertext_to_np(upd.ct)
    return data, scale, upd.plain.detach().cpu().numpy()


def seeded_from_np(c0, seed: int, scale: float, device,
                   chunk_offset: int = 0, derive: int = DERIVE_FOLD_CHUNK):
    """A JAX `SeededCiphertext`'s fields -> the port's
    `wire.SeededCiphertext`, c0 an int32 tensor on `device`."""
    from repro_torch.wire.compress import SeededCiphertext  # the wire
    # layer converts residues with this module
    return SeededCiphertext(c0=residues_from_np(c0, device), seed=int(seed),
                            scale=float(scale),
                            chunk_offset=int(chunk_offset),
                            derive=int(derive))


def server_materials_from_np(d, device, *, a_seed: int, chunk_offset: int,
                             n_chunks: int, derive: int, scale: float):
    """A JAX `transcipher.ServerMaterials` (D as u32 [B, L, N], then its
    scalar fields) -> the port's, with D an int32 tensor on `device`."""
    from repro_torch.core.ckks.transcipher import ServerMaterials
    return ServerMaterials(d=residues_from_np(d, device), a_seed=int(a_seed),
                           chunk_offset=int(chunk_offset),
                           n_chunks=int(n_chunks), derive=int(derive),
                           scale=float(scale))


def client_materials_from_np(seed_ct_data, seed_ct_scale: float, device, *,
                             keystream_seed: int, a_seed: int,
                             chunk_offset: int, n_chunks: int, derive: int,
                             scale: float, escrow_a_seed: int):
    """A JAX `transcipher.ClientMaterials` (its escrow `seed_ct` as u32 data
    and scale, then its scalar fields) -> the port's."""
    from repro_torch.core.ckks.transcipher import ClientMaterials
    return ClientMaterials(
        keystream_seed=int(keystream_seed), a_seed=int(a_seed),
        chunk_offset=int(chunk_offset), n_chunks=int(n_chunks),
        derive=int(derive), scale=float(scale),
        seed_ct=ciphertext_from_np(seed_ct_data, seed_ct_scale, device),
        escrow_a_seed=int(escrow_a_seed))


def threshold_parties_from_np(parties, device) -> list:
    """A JAX `threshold_keygen`'s parties as (index, u32 s_mont [L, N])
    pairs -> the port's `ThresholdParty` list on `device`."""
    from repro_torch.core.ckks.threshold import ThresholdParty
    return [ThresholdParty(index=int(i), s_mont=residues_from_np(s, device))
            for i, s in parties]


def threshold_parties_to_np(parties) -> list:
    """-> [(index, u32 s_mont)], the fields of JAX `ThresholdParty`s."""
    return [(p.index, residues_to_np(p.s_mont)) for p in parties]


def shamir_parties_from_np(parties, device) -> list:
    """A JAX `shamir_share_secret`'s parties as (index, u32 share [L, N])
    pairs -> the port's `ShamirParty` list on `device`."""
    from repro_torch.core.ckks.threshold import ShamirParty
    return [ShamirParty(index=int(i), share=residues_from_np(s, device))
            for i, s in parties]


def shamir_parties_to_np(parties) -> list:
    """-> [(index, u32 share)], the fields of JAX `ShamirParty`s."""
    return [(p.index, residues_to_np(p.share)) for p in parties]


def params_from_np(tree, device):
    """A JAX parameter tree as numpy (`jax.tree_util.tree_map(np.asarray,
    params)`), or AdamW state ({"m", "v", "step"}), -> the same nesting of
    tensors on `device`, dtypes kept."""
    return packing.tree_map(
        lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def params_to_np(tree):
    """Inverse of params_from_np: tensors -> numpy arrays (host copies)."""
    return packing.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def check_context(ctx: CkksContext, primes, n_poly: int | None = None,
                  delta_bits: int | None = None) -> None:
    """Raise unless `ctx` has the JAX context's primes (and N and delta
    where given): only then are residues meaningful across."""
    primes = tuple(int(q) for q in primes)
    if ctx.primes != primes:
        raise ValueError(f"context primes differ: {ctx.primes} vs {primes}")
    if n_poly is not None and ctx.n_poly != int(n_poly):
        raise ValueError(f"context N differs: {ctx.n_poly} vs {n_poly}")
    if delta_bits is not None and ctx.delta_bits != int(delta_bits):
        raise ValueError(f"context delta differs: 2^{ctx.delta_bits} vs "
                         f"2^{delta_bits}")
