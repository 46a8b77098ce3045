"""The wire's frame layout, parsed and counted from its definition.

    frame   = [4s "RPWR"][u8 version][u8 type][u16 flags][u64 len][payload]
    array   = [u8 dtype code][u8 ndim][u32 dims...][raw little-endian]

A downlink is one PROTECTED_UPDATE frame nesting a CIPHERTEXT frame (f64
scale + u32[B, L, 2, N]) and a PLAIN_SEGMENT frame (u8 codec, f64 scale +
array).  A seeded uplink stream is UPDATE_BEGIN (u32 cid, n_samples,
round, n_chunks; u8 kind), one CT_CHUNK per row (u32 index + a version-2
SEEDED_CIPHERTEXT frame: f64 scale, u64 seed, u32 chunk offset, u8 derive,
u32[1, L, N] c0), PLAIN_SEGMENT and an empty UPDATE_END.  Arrays come back
as numpy views of the blob, not copies.
"""
from __future__ import annotations

import struct

import numpy as np

MAGIC = b"RPWR"
HEADER = struct.Struct("<4sBBHQ")
CIPHERTEXT, SEEDED, PROTECTED_UPDATE = 0x01, 0x02, 0x03
UPDATE_BEGIN, CT_CHUNK, PLAIN_SEGMENT, UPDATE_END = 0x06, 0x07, 0x08, 0x09
DTYPES = {0: np.uint32, 1: np.float32, 2: np.float16, 3: np.int8,
          4: np.float64, 5: np.int32, 6: np.uint8, 7: np.int64}
CODECS = {0: "f32", 2: "f16", 3: "i8"}
CODEC_ITEMSIZE = {"f32": 4, "f16": 2, "i8": 1}
SEEDED_KIND = 1
DERIVE_FOLD_CHUNK = 1


class LayoutError(ValueError):
    pass


def frame(buf, off: int = 0):
    """-> (type, version, payload memoryview, next offset)."""
    view = memoryview(buf)
    if len(view) - off < HEADER.size:
        raise LayoutError(f"short frame header at {off}")
    magic, version, ftype, _, n = HEADER.unpack_from(view, off)
    if magic != MAGIC:
        raise LayoutError(f"bad magic at {off}")
    start = off + HEADER.size
    if start + n > len(view):
        raise LayoutError(f"frame at {off} runs past the end")
    return ftype, version, view[start:start + n], start + n


def array(payload, off: int = 0):
    """-> (numpy view, next offset)."""
    code, ndim = struct.unpack_from("<BB", payload, off)
    off += 2
    shape = struct.unpack_from(f"<{ndim}I", payload, off)
    off += 4 * ndim
    dt = np.dtype(DTYPES[code])
    count = int(np.prod(shape, dtype=np.int64))
    arr = np.frombuffer(payload, dtype=dt, count=count, offset=off)
    return arr.reshape(shape), off + count * dt.itemsize


def _array_bytes(ndim: int, count: int, itemsize: int) -> int:
    return 2 + 4 * ndim + count * itemsize


def _plain_frame_bytes(n_plain: int, codec: str) -> int:
    return HEADER.size + 9 + _array_bytes(1, n_plain, CODEC_ITEMSIZE[codec])


def downlink_bytes(n_rows: int, n_limbs: int, n_poly: int, n_plain: int,
                   codec: str = "f32") -> int:
    ct = HEADER.size + 8 + _array_bytes(4, n_rows * n_limbs * 2 * n_poly, 4)
    return HEADER.size + ct + _plain_frame_bytes(n_plain, codec)


def uplink_bytes(n_rows: int, n_limbs: int, n_poly: int, n_plain: int,
                 codec: str) -> int:
    seeded = HEADER.size + 21 + _array_bytes(3, n_limbs * n_poly, 4)
    chunk = HEADER.size + 4 + seeded
    return (HEADER.size + 17 + n_rows * chunk
            + _plain_frame_bytes(n_plain, codec) + HEADER.size)


def _plain(payload):
    codec_id, qscale = struct.unpack_from("<Bd", payload, 0)
    arr, _ = array(payload, 9)
    return CODECS[codec_id], qscale, arr


def parse_downlink(blob):
    """-> {"scale", "ct" u32[B, L, 2, N], "codec", "qscale", "plain"}."""
    ftype, _, payload, end = frame(blob)
    if ftype != PROTECTED_UPDATE or end != len(blob):
        raise LayoutError("a downlink is one PROTECTED_UPDATE frame")
    ftype, _, ct_payload, off = frame(payload)
    if ftype != CIPHERTEXT:
        raise LayoutError(f"inner frame {ftype:#x} is not a ciphertext")
    (scale,) = struct.unpack_from("<d", ct_payload, 0)
    ct, _ = array(ct_payload, 8)
    ftype, _, pl_payload, off = frame(payload, off)
    if ftype != PLAIN_SEGMENT or off != len(payload):
        raise LayoutError("the ciphertext is not followed by one plain "
                          "segment")
    codec, qscale, plain = _plain(pl_payload)
    return {"scale": scale, "ct": ct, "codec": codec, "qscale": qscale,
            "plain": plain}


def parse_uplink(blob):
    """-> {"begin": (cid, n_samples, round, n_chunks, kind), "rows": list
    of (index, scale, seed, offset, derive, version, u32[1, L, N] c0),
    "codec", "qscale", "plain", "end": bool}, in arrival order."""
    out = {"rows": [], "end": False}
    off = 0
    while off < len(blob):
        ftype, version, payload, off = frame(blob, off)
        if out["end"]:
            raise LayoutError("a frame follows UPDATE_END")
        if ftype == UPDATE_BEGIN:
            out["begin"] = struct.unpack_from("<IIIIB", payload, 0)
        elif ftype == CT_CHUNK:
            (idx,) = struct.unpack_from("<I", payload, 0)
            ity, iver, inner, iend = frame(payload, 4)
            if ity != SEEDED or iend != len(payload):
                raise LayoutError(f"chunk {idx} does not nest one seeded "
                                  "ciphertext")
            scale, seed, coff, derive = struct.unpack_from("<dQIB", inner, 0)
            c0, _ = array(inner, 21)
            out["rows"].append((idx, scale, seed, coff, derive, iver, c0))
        elif ftype == PLAIN_SEGMENT:
            out["codec"], out["qscale"], out["plain"] = _plain(payload)
        elif ftype == UPDATE_END:
            out["end"] = True
        else:
            raise LayoutError(f"unexpected frame type {ftype:#x}")
    return out
