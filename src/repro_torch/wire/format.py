"""Wire binary format: versioned, length-prefixed frames, byte-identical to
the JAX package's `repro.wire.format`.

Every FL artifact travels as one or more frames:

    [4s magic "RPWR"][u8 version][u8 type][u16 flags][u64 payload_len][payload]

Frames nest (a PROTECTED_UPDATE payload holds a ciphertext frame and a
plain-segment frame).  Arrays inside payloads are

    [u8 dtype_code][u8 ndim][u32 dims...][raw little-endian bytes]

and every integer is little-endian.  DESIGN.md §6 and §9.2 give the full
layout.  Residues travel as u32; the port's int32 residue tensors have the
same bits, so they are written and read without conversion.

Versioning is per frame: this build reads versions 1 and 2 and emits
`VERSION` (2).  The only layout difference is the u8 derive id that v2
seeded-ciphertext frames carry; v1 implies DERIVE_FOLD_CHUNK.  Setting
REPRO_WIRE_VERSION=1 pins a sender to the legacy layout, read once at
import as the reference reads it (README.md "Environment variables &
flags").

Robustness contract: `deserialize` raises WireError (NeedMoreData for a
short buffer) for any truncated or mutated input, never a raw struct,
numpy or torch error, and never reads past a frame's payload.
"""
from __future__ import annotations

import dataclasses
import os
import struct
from typing import Iterator

import numpy as np
import torch

from repro_torch import interop, obs
from repro_torch.core.ckks.cipher import Ciphertext
from repro_torch.core.packing import MaskPartition
from repro_torch.core.secure_agg import ProtectedUpdate
from repro_torch.wire import compress as _c
from repro_torch.wire.compress import (DERIVE_FOLD_CHUNK, DERIVES,
                                       MaskedChunk, SeededCiphertext)

MAGIC = b"RPWR"
VERSION = 2                      # default emit version
SUPPORTED_VERSIONS = (1, 2)      # what parse_frame accepts

_HEADER = struct.Struct("<4sBBHQ")
HEADER_BYTES = _HEADER.size

T_CIPHERTEXT = 0x01          # f64 scale + u32[B, L, 2, N] array
T_SEEDED_CIPHERTEXT = 0x02   # v1: f64 scale, u64 seed, u32 chunk_offset +
                             #     u32[B, L, N] c0
                             # v2: + u8 derive between chunk_offset and c0
T_PROTECTED_UPDATE = 0x03    # nested (SEEDED_)CIPHERTEXT + PLAIN_SEGMENT
T_KEYSET = 0x04              # named-array bundle
T_MASK_PARTITION = 0x05      # u64 n_total, u32 slots + enc/plain idx arrays
T_UPDATE_BEGIN = 0x06        # u32 cid, n_samples, round, n_chunks; u8 ct_kind
T_CT_CHUNK = 0x07            # u32 chunk_idx + one nested one-chunk ct frame
T_PLAIN_SEGMENT = 0x08       # u8 codec, f64 qscale + quantized array
T_UPDATE_END = 0x09          # empty payload
T_MASKED_CHUNK = 0x0A        # v2+: f64 scale, u64 a_seed, u32 chunk_offset,
                             #     u8 derive + u32[B, N] masked coefficients
T_TRANSCIPHER_SEED = 0x0B    # v2+: one nested SEEDED_CIPHERTEXT frame

_DTYPE_CODES = {
    np.dtype(np.uint32): 0, np.dtype(np.float32): 1, np.dtype(np.float16): 2,
    np.dtype(np.int8): 3, np.dtype(np.float64): 4, np.dtype(np.int32): 5,
    np.dtype(np.uint8): 6, np.dtype(np.int64): 7,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}

_PLAIN_CODEC_IDS = {"f32": 0, "f16": 2, "i8": 3}
_PLAIN_CODEC_NAMES = {v: k for k, v in _PLAIN_CODEC_IDS.items()}


class WireError(ValueError):
    pass


class NeedMoreData(WireError):
    """Raised when a buffer ends mid-frame (incremental readers catch it)."""


def _emit_version_from_env() -> int:
    """REPRO_WIRE_VERSION=1 makes every frame() call emit the legacy
    layout.  Read once at import; a bad value fails here, loudly."""
    raw = os.environ.get("REPRO_WIRE_VERSION")
    if raw is None:
        return VERSION
    try:
        v = int(raw)
    except ValueError:
        v = None
    if v not in SUPPORTED_VERSIONS:
        raise WireError(
            f"REPRO_WIRE_VERSION={raw!r} is not a supported wire version; "
            f"this build speaks {SUPPORTED_VERSIONS} (README.md "
            "'Environment variables & flags')")
    return v


EMIT_VERSION = _emit_version_from_env()


# ---------------------------------------------------------------------------
# frame envelope
# ---------------------------------------------------------------------------


def frame(ftype: int, payload: bytes, flags: int = 0,
          version: int | None = None) -> bytes:
    """Wrap `payload` in a frame envelope (`version` defaults to
    EMIT_VERSION; the caller makes the payload match it)."""
    version = EMIT_VERSION if version is None else version
    if version not in SUPPORTED_VERSIONS:
        raise WireError(
            f"cannot emit wire version {version}; this build speaks "
            f"{SUPPORTED_VERSIONS} (README.md 'Environment variables & "
            "flags', REPRO_WIRE_VERSION)")
    return _HEADER.pack(MAGIC, version, ftype, flags, len(payload)) + payload


def parse_frame_v(buf, off: int = 0) -> tuple[int, int, int, memoryview, int]:
    """-> (ftype, flags, version, payload, next_off).  NeedMoreData on a
    truncated buffer; WireError on bad magic or an unknown version."""
    view = memoryview(buf)
    if len(view) - off < HEADER_BYTES:
        raise NeedMoreData("incomplete frame header")
    magic, version, ftype, flags, plen = _HEADER.unpack_from(view, off)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r} at offset {off}")
    if version not in SUPPORTED_VERSIONS:
        raise WireError(
            f"unsupported wire version {version}: this build speaks "
            f"versions {SUPPORTED_VERSIONS}. Upgrade this receiver, or pin "
            "the sender to a legacy layout with REPRO_WIRE_VERSION=1 — see "
            "README.md 'Environment variables & flags' and the version "
            "rules in DESIGN.md §9.2")
    end = off + HEADER_BYTES + plen
    if len(view) < end:
        raise NeedMoreData("incomplete frame payload")
    return ftype, flags, version, view[off + HEADER_BYTES:end], end


def parse_frame(buf, off: int = 0) -> tuple[int, int, memoryview, int]:
    """-> (ftype, flags, payload, next_off)."""
    ftype, flags, _, payload, end = parse_frame_v(buf, off)
    return ftype, flags, payload, end


def iter_frames(buf) -> Iterator[tuple[int, int, memoryview]]:
    off = 0
    n = len(buf)
    while off < n:
        ftype, flags, payload, off = parse_frame(buf, off)
        yield ftype, flags, payload


class FrameReader:
    """Incremental frame splitter: feed() arbitrary byte slices, pop()
    complete frames.  Holds at most one partial frame of buffered bytes."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)

    def pop(self):
        """-> (ftype, flags, payload bytes) or None if no complete frame."""
        try:
            ftype, flags, payload, end = parse_frame(self._buf, 0)
        except NeedMoreData:
            return None
        out = (ftype, flags, bytes(payload))
        payload.release()          # else the bytearray can't be resized
        del self._buf[:end]
        return out

    def __iter__(self):
        while True:
            item = self.pop()
            if item is None:
                return
            yield item


# ---------------------------------------------------------------------------
# array primitive
# ---------------------------------------------------------------------------


def pack_array(a) -> bytes:
    a = np.ascontiguousarray(np.asarray(a))
    code = _DTYPE_CODES.get(a.dtype)
    if code is None:
        raise WireError(f"unsupported wire dtype {a.dtype}")
    head = struct.pack("<BB", code, a.ndim)
    dims = struct.pack(f"<{a.ndim}I", *a.shape) if a.ndim else b""
    return head + dims + a.tobytes()


def unpack_array(payload, off: int = 0) -> tuple[np.ndarray, int]:
    """-> (array copy, next offset); bounds-checked before the buffer is
    touched, with python-int size math (u32 dims from a corrupt frame
    overflow fixed-width sums)."""
    view = memoryview(payload)
    code, ndim = struct.unpack_from("<BB", view, off)
    off += 2
    shape = struct.unpack_from(f"<{ndim}I", view, off) if ndim else ()
    off += 4 * ndim
    dtype = _CODE_DTYPES.get(code)
    if dtype is None:
        raise WireError(f"unknown dtype code {code}")
    count = 1
    for d in shape:
        count *= int(d)
    nbytes = count * dtype.itemsize
    if nbytes > len(view) - off:
        raise WireError(
            f"array of {count} x {dtype} ({nbytes} B) exceeds the "
            f"{len(view) - off} payload bytes remaining")
    arr = np.frombuffer(view, dtype=dtype, count=count, offset=off)
    return arr.reshape(shape).copy(), off + nbytes


def _check_residues(arr, what: str) -> None:
    if arr.dtype != np.uint32:
        raise WireError(f"{what} array must be uint32, got {arr.dtype}")


def _residues(arr, device, what: str) -> torch.Tensor:
    """A parsed array -> int32 residue tensor; WireError unless u32."""
    _check_residues(arr, what)
    return torch.from_numpy(arr.view(np.int32)).to(device)


def _device(ctx):
    return ctx.device if ctx is not None else torch.device("cpu")


# ---------------------------------------------------------------------------
# ciphertexts
# ---------------------------------------------------------------------------


def serialize_ciphertext(ct: Ciphertext, version: int | None = None) -> bytes:
    """Full ciphertext -> one frame (payload layout version-invariant)."""
    payload = struct.pack("<d", float(ct.scale)) + pack_array(
        interop.residues_to_np(ct.data))
    return frame(T_CIPHERTEXT, payload, version=version)


def _parse_ciphertext(payload, device) -> Ciphertext:
    (scale,) = struct.unpack_from("<d", payload, 0)
    data, _ = unpack_array(payload, 8)
    return Ciphertext(data=_residues(data, device, "ciphertext"),
                      scale=scale)


def serialize_seeded_ciphertext(sct: SeededCiphertext,
                                version: int | None = None) -> bytes:
    """Seeded ciphertext -> one frame.  v2 carries sct.derive; v1 can only
    express DERIVE_FOLD_CHUNK and refuses any other id."""
    version = EMIT_VERSION if version is None else version
    arr = pack_array(interop.residues_to_np(sct.c0))
    head = struct.pack("<dQI", float(sct.scale), int(sct.seed),
                       int(sct.chunk_offset))
    if version == 1:
        if sct.derive != DERIVE_FOLD_CHUNK:
            raise WireError(
                f"seed-derivation id {sct.derive} is not expressible in "
                "wire v1 frames (v1 implies derive="
                f"{DERIVE_FOLD_CHUNK}); emit v2 (DESIGN.md §9.2)")
        return frame(T_SEEDED_CIPHERTEXT, head + arr, version=1)
    return frame(T_SEEDED_CIPHERTEXT,
                 head + struct.pack("<B", int(sct.derive)) + arr,
                 version=version)


def _parse_seeded_ciphertext(payload, version: int = 1) -> SeededCiphertext:
    """-> SeededCiphertext with c0 a u32 numpy array (not yet expanded)."""
    scale, seed, chunk_offset = struct.unpack_from("<dQI", payload, 0)
    off = struct.calcsize("<dQI")
    derive = DERIVE_FOLD_CHUNK
    if version >= 2:
        (derive,) = struct.unpack_from("<B", payload, off)
        off += 1
        if derive not in DERIVES:
            raise WireError(
                f"unknown seed-derivation id {derive} in v{version} seeded "
                f"ciphertext; this build knows {DERIVES} (DESIGN.md §9.2)")
    c0, _ = unpack_array(payload, off)
    return SeededCiphertext(c0=c0, seed=seed, scale=scale,
                            chunk_offset=chunk_offset, derive=derive)


# ---------------------------------------------------------------------------
# transcipher uplink frames (wire/stream.py ingests them)
# ---------------------------------------------------------------------------


def serialize_masked_chunk(mc: MaskedChunk,
                           version: int | None = None) -> bytes:
    """Masked transcipher chunk -> one frame (v2+ only)."""
    version = EMIT_VERSION if version is None else version
    if version < 2:
        raise WireError(
            "transcipher masked chunks are not expressible in wire v1 "
            "frames; emit v2 (DESIGN.md §15)")
    head = struct.pack("<dQI", float(mc.scale), int(mc.a_seed),
                       int(mc.chunk_offset))
    payload = head + struct.pack("<B", int(mc.derive)) \
        + pack_array(interop.residues_to_np(mc.masked))
    return frame(T_MASKED_CHUNK, payload, version=version)


def _parse_masked_chunk(payload, version: int) -> MaskedChunk:
    if version < 2:
        raise WireError(
            "masked transcipher chunk in a v1 frame; transcipher requires "
            "wire v2 (DESIGN.md §15)")
    scale, a_seed, chunk_offset = struct.unpack_from("<dQI", payload, 0)
    off = struct.calcsize("<dQI")
    (derive,) = struct.unpack_from("<B", payload, off)
    off += 1
    if derive not in DERIVES:
        raise WireError(
            f"unknown seed-derivation id {derive} in v{version} masked "
            f"chunk; this build knows {DERIVES} (DESIGN.md §9.2)")
    masked, _ = unpack_array(payload, off)
    if masked.dtype != np.uint32 or masked.ndim != 2:
        raise WireError(
            f"masked chunk array must be u32[B, N], got "
            f"{masked.dtype}[{masked.ndim}d]")
    return MaskedChunk(masked=masked, a_seed=a_seed, scale=scale,
                       chunk_offset=chunk_offset, derive=derive)


def serialize_transcipher_seed(sct: SeededCiphertext,
                               version: int | None = None) -> bytes:
    """The escrow keystream-seed ciphertext -> one wrapper frame nesting a
    seeded-ciphertext frame (v2+ only)."""
    version = EMIT_VERSION if version is None else version
    if version < 2:
        raise WireError(
            "transcipher seed frames are not expressible in wire v1 "
            "frames; emit v2 (DESIGN.md §15)")
    return frame(T_TRANSCIPHER_SEED,
                 serialize_seeded_ciphertext(sct, version=version),
                 version=version)


# ---------------------------------------------------------------------------
# plain segment (quantized plaintext partition)
# ---------------------------------------------------------------------------


def serialize_plain_segment(arr: np.ndarray, codec: str, qscale: float,
                            version: int | None = None) -> bytes:
    payload = struct.pack("<Bd", _PLAIN_CODEC_IDS[codec], float(qscale)) \
        + pack_array(arr)
    return frame(T_PLAIN_SEGMENT, payload, version=version)


def _parse_plain_segment(payload) -> tuple[np.ndarray, str, float]:
    codec_id, qscale = struct.unpack_from("<Bd", payload, 0)
    arr, _ = unpack_array(payload, struct.calcsize("<Bd"))
    return arr, _PLAIN_CODEC_NAMES[codec_id], qscale


# ---------------------------------------------------------------------------
# protected update (one-shot, non-streaming)
# ---------------------------------------------------------------------------


def serialize_update(upd: ProtectedUpdate, *,
                     seeded: SeededCiphertext | None = None,
                     plain_codec: str = "f32",
                     version: int | None = None) -> bytes:
    """ProtectedUpdate -> one nested frame.  `seeded` (from seed_compress
    of the same encryption) replaces upd.ct on the wire; `version` pins
    every frame in the nest."""
    with obs.span("wire.serialize"):
        with obs.span("wire.d2h"):
            host = interop.residues_to_np(seeded.c0 if seeded is not None
                                          else upd.ct.data)
        arr, qscale = _c.quantize_plain(upd.plain, plain_codec)
        with obs.span("wire.frames"):
            ct_frame = (serialize_seeded_ciphertext(
                dataclasses.replace(seeded, c0=host), version=version)
                if seeded is not None
                else serialize_ciphertext(Ciphertext(data=host,
                                                     scale=upd.ct.scale),
                                          version=version))
            return frame(T_PROTECTED_UPDATE,
                         ct_frame + serialize_plain_segment(
                             arr, plain_codec, qscale, version=version),
                         version=version)


def _parse_update(payload, ctx) -> ProtectedUpdate:
    """The protected update's frames parsed on the host (`wire.frames`),
    the plain codec undone (`wire.codec`), then the copies to ctx's device
    (`wire.h2d`); a seeded ciphertext then expands its `a` there."""
    dev = _device(ctx)
    with obs.span("wire.frames"):
        ct_type, _, ct_version, ct_payload, off = parse_frame_v(payload, 0)
        if ct_type == T_CIPHERTEXT:
            (scale,) = struct.unpack_from("<d", ct_payload, 0)
            data, _ = unpack_array(ct_payload, 8)
            _check_residues(data, "ciphertext")
        elif ct_type == T_SEEDED_CIPHERTEXT:
            if ctx is None:
                raise WireError("seeded ciphertext needs a ctx to expand")
            sct = _parse_seeded_ciphertext(ct_payload, ct_version)
        else:
            raise WireError(f"unexpected inner frame type {ct_type}")
        ftype, _, pl_payload, _ = parse_frame(payload, off)
        if ftype != T_PLAIN_SEGMENT:
            raise WireError(f"expected plain segment, got type {ftype}")
        arr, codec, qscale = _parse_plain_segment(pl_payload)
    with obs.span("wire.codec"):
        plain = _c.dequantize_plain(arr, codec, qscale)
    with obs.span("wire.h2d"):
        if ct_type == T_CIPHERTEXT:
            ct = Ciphertext(data=_residues(data, dev, "ciphertext"),
                            scale=scale)
        else:
            sct = dataclasses.replace(
                sct, c0=interop.residues_from_np(sct.c0, dev))
        plain = torch.from_numpy(plain).to(dev)
    if ct_type != T_CIPHERTEXT:
        ct = sct.expand(ctx)
    return ProtectedUpdate(ct=ct, plain=plain)


# ---------------------------------------------------------------------------
# key bundles + mask partition
# ---------------------------------------------------------------------------


def serialize_keyset(keys: dict) -> bytes:
    """dict[str, residues] -> frame (pk, eval keys, threshold shares)."""
    parts = [struct.pack("<I", len(keys))]
    for name, arr in sorted(keys.items()):
        nb = name.encode("utf-8")
        parts.append(struct.pack("<H", len(nb)) + nb)
        parts.append(pack_array(interop.residues_to_np(arr)))
    return frame(T_KEYSET, b"".join(parts))


def _parse_keyset(payload, device) -> dict:
    (n,) = struct.unpack_from("<I", payload, 0)
    if n > (len(payload) - 4) // 4:
        # every entry needs >= 4 bytes: a corrupt count must not drive a
        # multi-billion-iteration parse loop
        raise WireError(f"keyset declares {n} entries but only "
                        f"{len(payload) - 4} payload bytes follow")
    off = 4
    out = {}
    for _ in range(n):
        (nlen,) = struct.unpack_from("<H", payload, off)
        off += 2
        name = bytes(memoryview(payload)[off:off + nlen]).decode("utf-8")
        off += nlen
        arr, off = unpack_array(payload, off)
        out[name] = _residues(arr, device, f"keyset entry {name!r}")
    return out


def serialize_partition(part: MaskPartition) -> bytes:
    """MaskPartition -> frame; the index arrays are int32, as the JAX
    package's MaskPartition holds them."""
    enc = part.enc_idx.cpu().numpy().astype(np.int32)
    plain = part.plain_idx.cpu().numpy().astype(np.int32)
    payload = struct.pack("<QI", part.n_total, part.slots) \
        + pack_array(enc) + pack_array(plain)
    return frame(T_MASK_PARTITION, payload)


def _parse_partition(payload, device) -> MaskPartition:
    n_total, slots = struct.unpack_from("<QI", payload, 0)
    off = struct.calcsize("<QI")
    enc_idx, off = unpack_array(payload, off)
    plain_idx, _ = unpack_array(payload, off)
    # the port keeps the partition as a mask: the index arrays must be a
    # disjoint cover of [0, n_total) for one to exist
    if enc_idx.ndim != 1 or plain_idx.ndim != 1 \
            or enc_idx.size + plain_idx.size != n_total:
        raise WireError(f"partition indices ({enc_idx.size} + "
                        f"{plain_idx.size}) do not cover n_total {n_total}")
    enc = enc_idx.astype(np.int64)
    if enc.size and (enc.min() < 0 or enc.max() >= n_total):
        raise WireError(f"partition index out of range [0, {n_total})")
    mask = np.zeros(n_total, dtype=bool)
    mask[enc] = True
    if not np.array_equal(np.flatnonzero(~mask), plain_idx):
        raise WireError("partition plain indices are not the complement "
                        "of its encrypted indices")
    return MaskPartition(mask=torch.from_numpy(mask).to(device),
                         n_enc=int(enc_idx.size), slots=int(slots))


# ---------------------------------------------------------------------------
# generic entry point
# ---------------------------------------------------------------------------

_PARSERS = {
    T_CIPHERTEXT: lambda p, ctx, v: _parse_ciphertext(p, _device(ctx)),
    T_SEEDED_CIPHERTEXT: lambda p, ctx, v: _parse_seeded_ciphertext(p, v),
    T_PROTECTED_UPDATE: lambda p, ctx, v: _parse_update(p, ctx),
    T_KEYSET: lambda p, ctx, v: _parse_keyset(p, _device(ctx)),
    T_MASK_PARTITION: lambda p, ctx, v: _parse_partition(p, _device(ctx)),
    T_MASKED_CHUNK: lambda p, ctx, v: _parse_masked_chunk(p, v),
    # unwrap to the nested escrow seeded-ciphertext artifact
    T_TRANSCIPHER_SEED: lambda p, ctx, v: _deserialize(p, ctx, 0)[0],
}


def deserialize(buf, ctx=None, off: int = 0):
    """One frame -> (artifact, next_off).  Tensors land on ctx's device (the
    CPU without a ctx); `ctx` is needed to expand seeded ciphertexts nested
    in protected updates.  A bare seeded-ciphertext frame comes back
    unexpanded, its c0 a u32 numpy array.  Any malformed input raises
    WireError.  Runs under a `wire.deserialize` span."""
    with obs.span("wire.deserialize", nbytes=len(buf) - off):
        return _deserialize(buf, ctx, off)


def _deserialize(buf, ctx=None, off: int = 0):
    """`deserialize` without its span, for a caller's per-frame loop."""
    ftype, _, version, payload, end = parse_frame_v(buf, off)
    parser = _PARSERS.get(ftype)
    if parser is None:
        raise WireError(f"no parser for frame type {ftype:#x}")
    try:
        return parser(payload, ctx, version), end
    except WireError:
        raise
    except Exception as e:
        # struct.error / KeyError / reshape and torch errors from a payload
        # whose bytes were mutated after the envelope survived
        raise WireError(
            f"malformed frame type {ftype:#x} payload: {e!r}") from e
