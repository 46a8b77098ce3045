"""Bandwidth optimizations for the FL wire (the JAX package's
`repro.wire.compress`, same names and semantics).

  * seed-expanded fresh encryptions (uplink): a seeded secret-key
    ciphertext's c1 is JAX's public threefry stream for a seed, so the
    client ships (seed, c0) and the receiver regenerates c1;
  * RNS limb dropping (downlink): rescale away trailing limbs of the
    aggregate before broadcast, trading precision for bytes;
  * plaintext-partition quantization (uplink): f16 or i8 for the part of a
    selective-encryption update that is not encrypted.

Quantization runs on the host in numpy, with the reference's expressions,
so the quantized bytes are identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import interop, obs
from repro_torch.core.ckks import cipher
from repro_torch.core.ckks.cipher import Ciphertext
from repro_torch.core.ckks.params import CkksContext

PLAIN_CODECS = ("f32", "f16", "i8")

# per-chunk seed-derivation ids (wire v2 seeded frames carry one; v1 frames
# imply DERIVE_FOLD_CHUNK); the registry lives in core/ckks/cipher.py
DERIVE_FOLD_CHUNK = cipher.DERIVE_FOLD_CHUNK
DERIVE_CTR = cipher.DERIVE_CTR
DERIVES = cipher.DERIVES


@dataclasses.dataclass(frozen=True)
class WirePolicy:
    """Per-deployment compression configuration for the FL wire."""

    seed_ciphertexts: bool = True     # uplink: ship (seed, c0), not (c0, c1)
    downlink_keep_limbs: int = 0      # 0 = keep all limbs (lossless)
    plain_codec: str = "f32"          # f32 | f16 | i8

    def __post_init__(self):
        if self.plain_codec not in PLAIN_CODECS:
            raise ValueError(f"plain_codec {self.plain_codec!r} is not one "
                             f"of {PLAIN_CODECS}")
        if self.downlink_keep_limbs < 0:
            raise ValueError("downlink_keep_limbs must be >= 0")


LOSSLESS = WirePolicy(seed_ciphertexts=True, downlink_keep_limbs=0,
                      plain_codec="f32")
COMPACT = WirePolicy(seed_ciphertexts=True, downlink_keep_limbs=0,
                     plain_codec="f16")


# ---------------------------------------------------------------------------
# seed-expanded ciphertexts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SeededCiphertext:
    """Wire form of a fresh seeded encryption: c0 plus the c1 PRNG seed.

    c0: [B, L, N] residues, an int32 tensor (from `seed_compress`) or a u32
    numpy array (from a parsed frame).  `expand(ctx)` regenerates
    c1 = expand_a_rows(seed, chunk_offset, B, derive) and returns the full
    Ciphertext on ctx's device.  `chunk_offset` is the global index of c0's
    first row within the update; `derive` names the per-chunk key
    derivation (v1 frames imply DERIVE_FOLD_CHUNK)."""

    c0: Any
    seed: int
    scale: float
    chunk_offset: int = 0
    derive: int = DERIVE_FOLD_CHUNK

    @property
    def n_chunks(self) -> int:
        return int(self.c0.shape[0])

    def expand(self, ctx: CkksContext) -> Ciphertext:
        cipher.check_derive(self.derive)
        c0 = interop.residues_from_np(self.c0, ctx.device)
        a = cipher.expand_a_rows(ctx, self.seed, self.chunk_offset,
                                 self.n_chunks, derive=self.derive)
        return Ciphertext(data=torch.stack([c0, a], dim=-2),
                          scale=self.scale)


@dataclasses.dataclass
class MaskedChunk:
    """Wire form of a transcipher (hybrid-HE) uplink chunk: stream-cipher-
    masked centered coefficients u32[B, N], no ciphertext limbs
    (core/ckks/transcipher.py); StreamIngest unmasks it."""

    masked: Any
    a_seed: int
    scale: float
    chunk_offset: int = 0
    derive: int = DERIVE_CTR

    @property
    def n_chunks(self) -> int:
        return int(self.masked.shape[0])


def seed_compress(ct: Ciphertext, seed: int,
                  derive: int = DERIVE_FOLD_CHUNK) -> SeededCiphertext:
    """Strip the deterministic c1 from a seeded encryption for the wire.

    `ct` must come from a seeded encrypt with this seed and derive id (a
    mismatch decrypts to noise)."""
    return SeededCiphertext(c0=ct.data[..., 0, :], seed=int(seed),
                            scale=ct.scale, derive=int(derive))


# ---------------------------------------------------------------------------
# RNS limb dropping (downlink)
# ---------------------------------------------------------------------------


def limb_drop(ctx: CkksContext, ct: Ciphertext, keep: int) -> Ciphertext:
    """Rescale the aggregated ciphertext down to `keep` limbs (lossy)."""
    return cipher.drop_limbs(ctx, ct, keep)


# ---------------------------------------------------------------------------
# plaintext-partition quantization
# ---------------------------------------------------------------------------


def quantize_plain(x, codec: str) -> tuple[np.ndarray, float]:
    """f32[P] (tensor or array) -> (wire array, scale).  i8 is symmetric
    per-tensor; an empty or all-zero segment quantizes to zeros at scale
    1.  A tensor's copy to the host runs under a `wire.d2h` span, the cast
    under `wire.codec`."""
    if isinstance(x, torch.Tensor):
        with obs.span("wire.d2h"):
            x = x.detach().cpu().numpy()
    with obs.span("wire.codec", codec=codec):
        x = np.asarray(x, dtype=np.float32)
        if codec == "f32":
            return x, 1.0
        if codec == "f16":
            return x.astype(np.float16), 1.0
        if codec == "i8":
            amax = float(np.max(np.abs(x))) if x.size else 0.0
            scale = amax / 127.0
            if not np.isfinite(scale) or scale <= 0.0:
                return np.zeros(x.shape, dtype=np.int8), 1.0
            return (np.clip(np.rint(x / scale), -127, 127).astype(np.int8),
                    scale)
        raise ValueError(codec)


def dequantize_plain(arr: np.ndarray, codec: str, scale: float) -> np.ndarray:
    if codec in ("f32", "f16"):
        return np.asarray(arr, dtype=np.float32)
    if codec == "i8":
        return np.asarray(arr, dtype=np.float32) * np.float32(scale)
    raise ValueError(codec)
