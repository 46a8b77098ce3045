"""Split and merge of a flat float32 vector by a selection mask, one CUDA
launch each.

`mask_split`: vec[P] -> (enc[n_chunks, slots], the masked elements in index
order zero-padded to whole slot blocks; plain[P - n_enc], the rest).
`mask_merge`: the inverse -> out[P].

Wrappers over `csrc/mask.cu`, which replaces no TPU kernel (the JAX package
gathers by int32 index arrays under XLA).  The kernels read the mask's
per-partition layout (`build_layout`), built once per partition and device
and cached on it (`core.packing.MaskPartition.layout`): the mask packed to
32-bit words and the count of encrypted elements before each tile of
`TILE`.  With it a split or merge reads no index, counts nothing and never
waits for the device.  On a CUDA tensor the wrappers launch the kernel or
raise; on a CPU tensor they run the plain version, boolean indexing.

`part` is a `core.packing.MaskPartition` (its `mask`, counts and
`layout(device)`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build as _build

TILE = 4096   # elements a warp takes (csrc/mask.cu: STEP * TILE_STEPS)


@dataclasses.dataclass(frozen=True)
class MaskLayout:
    """What the kernels read of a mask, on one device."""

    words: torch.Tensor      # int32[n_tiles * TILE / 32]: bit j of word i
                             # is mask[32 i + j], zero past P
    tile_enc: torch.Tensor   # int64[n_tiles]: encrypted elements before
                             # each tile


def build_layout(mask) -> MaskLayout:
    """The layout of a bool[P] mask, on the mask's device (at least one
    tile)."""
    mask = mask.reshape(-1)
    p = mask.numel()
    n_tiles = max(1, -(-p // TILE))
    bits = torch.zeros(n_tiles * TILE, dtype=torch.uint8, device=mask.device)
    bits[:p] = mask
    counts = bits.view(n_tiles, TILE).sum(1)
    by8 = bits.view(-1, 8)
    packed = by8[:, 0].clone()
    for k in range(1, 8):
        packed |= by8[:, k] << k
    # bytes in little-endian order: byte b of word i holds bits 8b..8b+7
    return MaskLayout(words=packed.view(torch.int32),
                      tile_enc=torch.cumsum(counts, 0) - counts)


# ---------------------------------------------------------------------------
# plain versions: boolean indexing
# ---------------------------------------------------------------------------


def split_plain(vec, part):
    mask = part.mask.to(vec.device)
    enc = torch.zeros(part.n_enc_padded, dtype=vec.dtype, device=vec.device)
    enc[: part.n_enc] = vec[mask]
    return enc.reshape(part.n_chunks, part.slots), vec[~mask]


def merge_plain(enc_chunks, plain, part):
    mask = part.mask.to(plain.device)
    out = torch.zeros(part.n_total, dtype=torch.float32, device=plain.device)
    out[mask] = enc_chunks.reshape(-1)[: part.n_enc].to(torch.float32)
    out[~mask] = plain.to(torch.float32)
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_f32(name, t, device, shape=None):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")


def mask_split(vec, part):
    """vec float32[P] -> (enc float32[n_chunks, slots] zero-padded, plain
    float32[n_plain])."""
    if vec.device.type == "cpu":
        return split_plain(vec, part)
    _build.require_cuda("mask_split", vec)
    _check_f32("mask_split vec", vec, vec.device, (part.n_total,))
    if not vec.is_contiguous():
        raise ValueError("mask_split: vec must be contiguous")
    if vec.data_ptr() % 16:
        raise ValueError("mask_split: vec must be 16-byte aligned")
    lay = part.layout(vec.device)
    enc = torch.empty(part.n_enc_padded, dtype=torch.float32,
                      device=vec.device)
    plain = torch.empty(part.n_plain, dtype=torch.float32, device=vec.device)
    _build.launch("mask", "mask_split_launch", vec, lay.words, lay.tile_enc,
                  part.n_total, part.n_enc, part.n_enc_padded, enc, plain)
    mask_split.launches += 1
    return enc.reshape(part.n_chunks, part.slots), plain


def mask_merge(enc_chunks, plain, part):
    """Inverse of mask_split -> float32[P] on the plain part's device.
    enc_chunks: float32 holding the encrypted values first in its flat
    order (any view that flattens without a copy is read in place)."""
    if plain.device.type == "cpu":
        return merge_plain(enc_chunks, plain, part)
    _build.require_cuda("mask_merge", plain)
    _check_f32("mask_merge plain", plain, plain.device, (part.n_plain,))
    if not plain.is_contiguous():
        raise ValueError("mask_merge: plain must be contiguous")
    enc = enc_chunks.reshape(-1)
    _check_f32("mask_merge enc_chunks", enc, plain.device)
    if enc.numel() < part.n_enc:
        raise ValueError(f"mask_merge: enc_chunks holds {enc.numel()} "
                         f"values, fewer than n_enc = {part.n_enc}")
    lay = part.layout(plain.device)
    out = torch.empty(part.n_total, dtype=torch.float32, device=plain.device)
    _build.launch("mask", "mask_merge_launch", out, enc, enc.stride(0), plain,
                  lay.words, lay.tile_enc, part.n_total)
    mask_merge.launches += 1
    return out


mask_split.launches = 0
mask_merge.launches = 0
