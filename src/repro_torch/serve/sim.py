"""Fleet simulation: many thousands of wire-distinct clients, cheaply (the
JAX package's `repro.serve.sim`, byte for byte).

Encrypting 10k genuinely independent updates would make a benchmark the
bottleneck, not the service.  Instead the simulator encrypts a handful of
TEMPLATE updates once and mints each simulated client by rewriting the
UPDATE_BEGIN header (cid / n_samples / round) of a rotating template —
pure byte surgery, no HE.  The service cannot tell the difference: every
submission is a fully valid, parseable, foldable wire stream with a
unique client id, and the server-side work (frame parsing, chunk decode,
weighted accumulate launch) is exactly what real traffic would cost.

The header layout being patched (wire/format.py, wire/stream.py):

    [16B frame header][u32 cid][u32 n_samples][u32 round][u32 n_chunks][u8]

`launch/serve.py` drives a fleet through the service; the tests use it
(at small N) wherever client identity matters more than ciphertext
content.
"""
from __future__ import annotations

import struct

import numpy as np

from repro_torch.wire import format as wf
from repro_torch.wire import stream as wire_stream

_U32 = struct.Struct("<I")


def rewrite_begin(blob: bytes, *, cid: int | None = None,
                  n_samples: int | None = None,
                  rnd: int | None = None) -> bytes:
    """Return `blob` with its UPDATE_BEGIN header fields rewritten.

    The first frame must be UPDATE_BEGIN (raises WireError otherwise);
    only the requested fields change, every other byte is the input's.
    """
    ftype, _, payload, _ = wf.parse_frame(blob, 0)
    if ftype != wf.T_UPDATE_BEGIN:
        raise wf.WireError(f"expected UPDATE_BEGIN, got {ftype:#x}")
    if len(payload) < 12:
        raise wf.WireError("short UPDATE_BEGIN payload")
    base = wf.HEADER_BYTES          # payload offset of the first frame
    out = bytearray(blob)
    if cid is not None:
        out[base:base + 4] = _U32.pack(int(cid))
    if n_samples is not None:
        out[base + 4:base + 8] = _U32.pack(int(n_samples))
    if rnd is not None:
        out[base + 8:base + 12] = _U32.pack(int(rnd))
    return bytes(out)


class Fleet:
    """A population of `n_clients` simulated clients over template blobs.

    Args:
        templates: clean serialized update streams (pack_update_frames
            output) to rotate through; each minted client is template
            `cid % len(templates)` with a rewritten header.
        n_clients: fleet size (client ids are 0..n_clients-1).
        seed: RNG seed for the per-client n_samples draw (numpy's
            RandomState, the reference's draws).
        n_samples_range: inclusive (lo, hi) for the local sample counts —
            distinct weights keep the FedAvg normalization honest.
    """

    def __init__(self, templates: list[bytes], n_clients: int,
                 seed: int = 0, n_samples_range: tuple[int, int] = (8, 64)):
        if not templates:
            raise ValueError("need at least one template blob")
        self.templates = [bytes(t) for t in templates]
        self.n_clients = int(n_clients)
        lo, hi = n_samples_range
        rng = np.random.RandomState(seed)
        self.n_samples = rng.randint(lo, hi + 1,
                                     size=self.n_clients).astype(int)

    def blob(self, cid: int, rnd: int) -> bytes:
        """Mint client `cid`'s update stream for round `rnd`."""
        return rewrite_begin(self.templates[cid % len(self.templates)],
                             cid=cid, n_samples=int(self.n_samples[cid]),
                             rnd=rnd)

    def blobs(self, rnd: int, cids=None):
        """Yield (cid, blob) for the whole fleet (or the given cids)."""
        for cid in (range(self.n_clients) if cids is None else cids):
            yield cid, self.blob(cid, rnd)


def reference_aggregate(ctx, blobs: list[bytes], *, sharded=None):
    """The clean synchronous aggregate the service must match bit-for-bit:
    one StreamIngest over `blobs` in order, FedAvg weights normalized over
    exactly this set (the same float64 math as quorum.normalized_weights
    and fl.server.FLServer.aggregate_wire)."""
    metas = [wire_stream.peek_update_meta(b) for b in blobs]
    weights = np.asarray([m.n_samples for m in metas], dtype=np.float64)
    weights = weights / weights.sum()
    ingest = wire_stream.StreamIngest(ctx, sharded=sharded)
    for b, w in zip(blobs, weights):
        ingest.ingest(b, float(w))
    return ingest.finalize()
