"""Streaming uplink: one client's update as a frame stream, and the server's
chunk-by-chunk ingest into a running modular accumulator (the JAX package's
`repro.wire.stream`, byte- and bit-identical).

Client side, `pack_update_frames()` emits per update:

    UPDATE_BEGIN   (cid, n_samples, round, n_chunks, ct_kind)
    CT_CHUNK * n   (chunk_idx + one one-chunk ciphertext/seeded frame)
    PLAIN_SEGMENT  (quantized plaintext partition)
    UPDATE_END

and a transcipher thin client's `pack_masked_update_frames()` the same with
ct_kind CT_TRANSCIPHER, one escrow TRANSCIPHER_SEED frame after the header,
and a masked-chunk frame in each CT_CHUNK (DESIGN.md §15).

Server side, `StreamIngest.ingest()` parses and validates one update's
frames, buffers its chunks, and folds them in ONE launch of the
`weighted_accum_chunks` kernel:

    acc[k] = acc[k] + w[k] (*) ct[k]    for every ready row k

so launches are O(clients), not O(clients * n_chunks) (`accum_launches`),
and at most one update's chunks are resident beside the accumulator
(`peak_chunk_buffers`).  The modular sums are exact, so the streamed
aggregate equals the in-memory weighted_sum bit for bit.

On the card, the flush does in batches what the reference does per chunk:

  * a buffered seeded chunk keeps its c0 row on the host; the flush gathers
    the update's c0 rows into one host buffer, copies it to the device once,
    and expands every row's public `a` in batched threefry calls grouped by
    (seed, derive), with each row's own chunk id.  A row's `a` depends only
    on its own key, so no bit changes;
  * a buffered masked chunk keeps its u32 row on the host; the flush copies
    each (cid, round)'s masked rows to the device once and unmasks them all
    with one `mod_lift`, one `ntt_fwd`, the gathered D rows and one batched
    `a` expansion, where the reference unmasks chunk by chunk;
  * the accumulator is dense int32 [n_chunks, L, 2, N] in the ciphertext
    layout, updated in place by the kernel, held as a BlockGrid of the
    ingest's engine: a 1x1 mesh on the context's device by default, or
    the ShardedHe given as `sharded=` (chunk-index ranges on its data
    slots, limbs on its model slots).  A flush groups its rows by owning
    data slot, builds each block's rows on that block's device (host rows
    copied there directly, `a` expanded there for every limb and sliced;
    masked rows unmasked on the context's device, then copied) and folds
    through `ShardedHe.weighted_accum_chunks`, one launch per block.
    `finalize` hands the aggregate out as one tensor, the engine's counted
    gather;
  * the plaintext accumulator stays on the device and folds as
    acc += float32(w) * plain with a separate multiply and add, the
    reference's numpy expression, so its bits match.

Everything a rejected update could break is validated inside ingest's
rollback scope (frame kinds, scale, dtype, shape, derive id, seed and chunk
offset ranges, transcipher materials and their provisioned rows), before
the flush, and a rejected update restores every escrow seed it touched.

Telemetry: an ingest's counters are registry series labelled with its
`ingest_id` (`wire_ingest_*`, `repro_torch.obs`), read through read-only
properties.  While spans record (obs enabled or a torch.profiler session),
`ingest` runs under a `wire.ingest` span holding one `wire.frames` span
(the frame loop), a `wire.h2d` span (the plain segment's copy) and the
`wire.flush`, which holds a `wire.h2d` span (the gather of rows into one
host buffer and its copies to the device) and the `he.expand_a` of each
seed; `pack_update_frames` runs under
`wire.pack` with `wire.d2h`, `wire.frames` and the plain codec's spans.  No
span opens per frame or per chunk.  The accumulate is the engine's
`sharded.weighted_accum_chunks` launch.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
import struct
from typing import Any

import numpy as np
import torch

from repro_torch import interop, obs
from repro_torch.core.ckks import cipher, encoding, threefry, transcipher
from repro_torch.core.ckks.cipher import Ciphertext
from repro_torch.core.ckks.params import CkksContext
from repro_torch.core.ckks.sharded import BlockGrid, Layout, ShardedHe
from repro_torch.core.secure_agg import ProtectedUpdate
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.wire import compress as _c
from repro_torch.wire import format as wf

_BEGIN = struct.Struct("<IIIIB")

CT_FULL = 0
CT_SEEDED = 1
CT_TRANSCIPHER = 2
_CT_KINDS = (CT_FULL, CT_SEEDED, CT_TRANSCIPHER)

# escrow-rollback sentinel: this (cid, round) had no escrow seed before the
# update under ingest set one
_ESCROW_MISSING = object()


@dataclasses.dataclass(frozen=True)
class UpdateMeta:
    cid: int
    n_samples: int
    round: int
    n_chunks: int
    seeded: bool
    transcipher: bool = False


# ---------------------------------------------------------------------------
# client side: update -> frames
# ---------------------------------------------------------------------------


def pack_update_frames(upd: ProtectedUpdate, *, cid: int, n_samples: int,
                       rnd: int = 0,
                       seeded: _c.SeededCiphertext | None = None,
                       plain_codec: str = "f32",
                       version: int | None = None) -> bytes:
    """One client's ProtectedUpdate -> concatenated wire frames.

    `seeded` (compress.seed_compress of the same encryption) makes each
    CT_CHUNK carry (seed, c0 row) instead of the full row, with its derive
    id in every v2 seeded frame.  `plain_codec` is f32, f16 or i8;
    `version` pins every frame (v1 needs DERIVE_FOLD_CHUNK).  Returns
    UPDATE_BEGIN + CT_CHUNK * n_chunks + PLAIN_SEGMENT + UPDATE_END."""
    with obs.span("wire.pack", cid=cid, round=rnd):
        n_chunks = int(upd.ct.data.shape[0])
        kind = CT_SEEDED if seeded is not None else CT_FULL
        with obs.span("wire.d2h"):
            ct_host = interop.residues_to_np(seeded.c0 if seeded is not None
                                             else upd.ct.data)
        with obs.span("wire.frames"):
            out = [wf.frame(wf.T_UPDATE_BEGIN,
                            _BEGIN.pack(cid, n_samples, rnd, n_chunks, kind),
                            version=version)]
            for b in range(n_chunks):
                if seeded is not None:
                    chunk = _c.SeededCiphertext(
                        c0=ct_host[b:b + 1], seed=seeded.seed,
                        scale=seeded.scale, chunk_offset=b,
                        derive=seeded.derive)
                    inner = wf.serialize_seeded_ciphertext(chunk,
                                                           version=version)
                else:
                    inner = wf.serialize_ciphertext(Ciphertext(
                        data=ct_host[b:b + 1], scale=upd.ct.scale),
                        version=version)
                out.append(wf.frame(wf.T_CT_CHUNK,
                                    struct.pack("<I", b) + inner,
                                    version=version))
        arr, qscale = _c.quantize_plain(upd.plain, plain_codec)
        with obs.span("wire.frames"):
            out.append(wf.serialize_plain_segment(arr, plain_codec, qscale,
                                                  version=version))
            out.append(wf.frame(wf.T_UPDATE_END, b"", version=version))
            return b"".join(out)


def pack_masked_update_frames(masked: _c.MaskedChunk,
                              seed_ct: _c.SeededCiphertext, plain, *,
                              cid: int, n_samples: int, rnd: int = 0,
                              plain_codec: str = "f32",
                              version: int | None = None) -> bytes:
    """One transcipher client's masked update -> concatenated wire frames:
    UPDATE_BEGIN (ct_kind CT_TRANSCIPHER) + the escrow TRANSCIPHER_SEED
    frame + one masked chunk per row nested in CT_CHUNK + PLAIN_SEGMENT +
    UPDATE_END.  Transcipher frames are v2+ only: version=1 raises the
    serializer's WireError.

    `masked` holds the whole update's masked u32[n_chunks, N] words with
    the a_seed, derive, scale and chunk offset the unmask needs; `seed_ct`
    is compress.seed_compress of ClientMaterials.seed_ct."""
    n_chunks = masked.n_chunks
    host = interop.residues_to_np(masked.masked)
    out = [wf.frame(wf.T_UPDATE_BEGIN,
                    _BEGIN.pack(cid, n_samples, rnd, n_chunks,
                                CT_TRANSCIPHER),
                    version=version),
           wf.serialize_transcipher_seed(seed_ct, version=version)]
    for b in range(n_chunks):
        chunk = _c.MaskedChunk(masked=host[b:b + 1], a_seed=masked.a_seed,
                               scale=masked.scale,
                               chunk_offset=masked.chunk_offset + b,
                               derive=masked.derive)
        inner = wf.serialize_masked_chunk(chunk, version=version)
        out.append(wf.frame(wf.T_CT_CHUNK, struct.pack("<I", b) + inner,
                            version=version))
    arr, qscale = _c.quantize_plain(plain, plain_codec)
    out.append(wf.serialize_plain_segment(arr, plain_codec, qscale,
                                          version=version))
    out.append(wf.frame(wf.T_UPDATE_END, b"", version=version))
    return b"".join(out)


def peek_update_meta(blob: bytes) -> UpdateMeta:
    """Read only the UPDATE_BEGIN header (e.g. to compute FedAvg weights
    before ingesting)."""
    ftype, _, payload, _ = wf.parse_frame(blob, 0)
    if ftype != wf.T_UPDATE_BEGIN:
        raise wf.WireError(f"expected UPDATE_BEGIN, got {ftype:#x}")
    try:
        cid, n_samples, rnd, n_chunks, kind = _BEGIN.unpack_from(payload, 0)
    except struct.error as e:
        raise wf.WireError(f"short UPDATE_BEGIN payload: {e}") from e
    return UpdateMeta(cid=cid, n_samples=n_samples, round=rnd,
                      n_chunks=n_chunks, seeded=kind == CT_SEEDED,
                      transcipher=kind == CT_TRANSCIPHER)


# ---------------------------------------------------------------------------
# server side: streaming modular accumulator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Ready:
    """One buffered ciphertext row waiting for the next flush, by kind:

      "full"    data is a u32 numpy row [L, 2, N];
      "seeded"  data is a u32 numpy c0 row [L, N]; seed, derive and a_row
                (its global chunk id) name its `a`;
      "masked"  data is a u32 numpy row [N] of masked words; materials
                unmask it, a_row is its global chunk id;
      "device"  data is a device int32 row [L, 2, N] (in-memory ingest)."""

    chunk_idx: int
    w_mont: np.ndarray                 # int32[L] Montgomery weight
    data: Any
    kind: str = "full"
    seed: int = 0
    derive: int = cipher.DERIVE_FOLD_CHUNK
    a_row: int = 0
    materials: Any = None              # transcipher.ServerMaterials


class StreamIngest:
    """Accumulates arriving client updates chunk by chunk.

    Usage:
        ingest = StreamIngest(ctx)
        for blob, w in arriving:
            ingest.ingest(blob, weight=w)
        agg = ingest.finalize()    # ProtectedUpdate, scale = in_scale*delta

    `sharded` (a core.ckks.sharded.ShardedHe) holds the accumulator as
    blocks over its mesh and folds each flush through the engine, one
    launch per block; the aggregate is bit-identical to the unsharded
    ingest's.  `transcipher_materials` is a
    {(cid, round): transcipher.ServerMaterials} registry (more via
    `add_transcipher_materials`); a masked update from an unprovisioned
    (cid, round) is rejected.  `escrow_seeds` keeps each
    accepted update's escrow keystream-seed ciphertext under (cid, round).

    Attributes (read-only views of registry series labelled
    ingest=<ingest_id>, `wire_ingest_*`):
        accum_launches: accumulate launches (one per flush with ready rows).
        peak_chunk_buffers: most decoded-but-unfolded rows ever resident.
        clients_ingested, bytes_ingested, rejected_updates: ingest counts.
    """

    _ids = itertools.count()

    def __init__(self, ctx: CkksContext, sharded=None,
                 transcipher_materials: dict | None = None):
        self.ctx = ctx
        self._eng = sharded if sharded is not None else ShardedHe(
            ctx, make_host_mesh(ctx.device))
        self._transcipher = dict(transcipher_materials or {})
        self.escrow_seeds: dict = {}
        self._acc = None             # BlockGrid int32[n_rows, L, 2, N]
        self._acc_plain = None       # float32[n_plain] on ctx.device
        self._rows: set[int] = set()  # chunk indices folded so far
        self._shape = None           # (L, N) pinned by the first chunk
        self._in_scale = None
        self._pending: list[_Ready] = []
        # one label set per ingest instance; obs.REGISTRY.total(
        # "wire_ingest_...") sums over instances
        self.ingest_id = str(next(self._ids))
        lab = {"ingest": self.ingest_id}
        self._m_launches = obs.counter("wire_ingest_accum_launches", **lab)
        self._m_clients = obs.counter("wire_ingest_clients", **lab)
        self._m_bytes = obs.counter("wire_ingest_bytes", **lab)
        # decoded rows resident beside the accumulator, and their peak: a
        # regression that buffers several updates before folding shows as
        # peak > one update's rows
        self._m_resident = obs.gauge("wire_ingest_resident_chunks", **lab)
        self._m_peak = obs.gauge("wire_ingest_peak_chunk_buffers", **lab)
        self._m_rejected = obs.counter("wire_ingest_rejected_updates", **lab)

    # -- counters (registry-backed, read-only) -------------------------------

    @property
    def accum_launches(self) -> int:
        return int(self._m_launches.value)

    @property
    def clients_ingested(self) -> int:
        return int(self._m_clients.value)

    @property
    def bytes_ingested(self) -> int:
        return int(self._m_bytes.value)

    @property
    def peak_chunk_buffers(self) -> int:
        return int(self._m_peak.value)

    @property
    def rejected_updates(self) -> int:
        return int(self._m_rejected.value)

    def add_transcipher_materials(self, cid: int, rnd: int,
                                  materials) -> None:
        """Register one (cid, round)'s transcipher.ServerMaterials before
        its masked update arrives."""
        self._transcipher[(int(cid), int(rnd))] = materials

    # -- internals ----------------------------------------------------------

    def _w_mont(self, weight: float) -> np.ndarray:
        return encoding.encode_scalar_residues(float(weight),
                                               self.ctx).view(np.int32)

    def _note_decoded(self, n: int) -> None:
        self._m_resident.add(n)
        self._m_peak.set_max(self._m_resident.value)

    def _check_row(self, scale: float, dtype, shape) -> None:
        """Validate one chunk against the running aggregation: scale, u32
        residues, one row [1, L, 2, N] with the (L, N) the first chunk
        pinned."""
        if self._in_scale is None:
            self._in_scale = float(scale)
        elif abs(self._in_scale - scale) > 1e-6 * self._in_scale:
            raise wf.WireError("mixed ciphertext scales in one aggregation")
        if dtype != np.uint32:
            raise wf.WireError(f"ciphertext chunk dtype {dtype} is not "
                               "uint32")
        shape = tuple(int(d) for d in shape)
        if self._shape is None and len(shape) >= 3:
            self._shape = (shape[-3], shape[-1])
            if shape[-3] % self._eng.n_model:
                raise wf.WireError(
                    f"{shape[-3]} limbs do not divide over the engine's "
                    f"{self._eng.n_model} model slots")
        want = (1, self._shape[0], 2, self._shape[1]) if self._shape else None
        if shape != want:
            raise wf.WireError(
                f"ciphertext chunk shape {shape} does not match this "
                f"aggregation's {want}")

    def _masked_row(self, meta: UpdateMeta, mc: _c.MaskedChunk,
                    chunk_idx: int, w_mont) -> _Ready:
        """Validate one masked chunk against its (cid, round)'s materials.
        Everything the flush's unmask could fail on is checked here."""
        sm = self._transcipher.get((meta.cid, meta.round))
        if sm is None:
            raise wf.WireError(
                f"no transcipher materials provisioned for client "
                f"{meta.cid} round {meta.round}; register ServerMaterials "
                f"(transcipher.provision) before ingest (DESIGN.md §15)")
        if int(mc.a_seed) != int(sm.a_seed) \
                or int(mc.derive) != int(sm.derive):
            raise wf.WireError(
                f"masked chunk parameters (a_seed={mc.a_seed}, "
                f"derive={mc.derive}) do not match the provisioned "
                f"materials (a_seed={sm.a_seed}, derive={sm.derive}) for "
                f"client {meta.cid} round {meta.round}")
        words = mc.masked
        b, start = int(words.shape[0]), int(mc.chunk_offset)
        r0 = start - sm.chunk_offset
        if r0 < 0 or r0 + b > sm.n_chunks:
            raise wf.WireError(
                f"transcipher unmask failed: chunk rows [{start}, "
                f"{start + b}) fall outside the provisioned range "
                f"[{sm.chunk_offset}, {sm.chunk_offset + sm.n_chunks})")
        l, n = int(sm.d.shape[-2]), int(sm.d.shape[-1])
        if words.shape[1] != n:
            raise wf.WireError(f"masked chunk rows of N={words.shape[1]} do "
                               f"not match the provisioned N={n}")
        threefry.prng_key(sm.a_seed)
        cipher.check_chunk_start(start, sm.derive)
        self._check_row(sm.scale, words.dtype, (b, l, 2, n))
        return _Ready(int(chunk_idx), w_mont, words[0], kind="masked",
                      a_row=start, materials=sm)

    def _buffer_wire_chunk(self, meta: UpdateMeta, chunk_idx: int, inner,
                           w_mont) -> None:
        """Validate and queue one parsed CT_CHUNK payload."""
        if isinstance(inner, _c.MaskedChunk):
            row = self._masked_row(meta, inner, chunk_idx, w_mont)
        elif isinstance(inner, _c.SeededCiphertext):
            c0 = inner.c0
            l, n = self.ctx.n_limbs, self.ctx.n_poly
            if c0.ndim != 3 or c0.shape[1:] != (l, n):
                raise wf.WireError(
                    f"seeded chunk c0 {c0.shape} does not expand to this "
                    f"context's ({l}, {n}) rows")
            # the expansion runs at flush, outside the rollback scope: its
            # key and chunk id must be valid now (JAX raises for both)
            threefry.prng_key(inner.seed)
            cipher.check_chunk_start(inner.chunk_offset, inner.derive)
            self._check_row(inner.scale, c0.dtype, (c0.shape[0], l, 2, n))
            row = _Ready(int(chunk_idx), w_mont, c0[0], kind="seeded",
                         seed=int(inner.seed), derive=int(inner.derive),
                         a_row=int(inner.chunk_offset))
        else:
            data = interop.residues_to_np(inner.data)
            self._check_row(inner.scale, np.dtype(np.uint32), data.shape)
            row = _Ready(int(chunk_idx), w_mont, data[0])
        self._pending.append(row)
        self._note_decoded(+1)

    def _rows_to_blocks(self, batch: list[_Ready], slots) -> list:
        """The batch's ciphertext rows as int32[K, hi - lo, 2, N] on each
        slot's device, for slots [(device, lo, hi)] (limbs [lo, hi)): one
        host-to-device copy per kind of row and slot, every seeded row's
        `a` expanded on the slot's device in one call per (seed, derive),
        and every (cid, round)'s masked rows unmasked on the context's
        device in one call, then copied."""
        k = len(batch)
        n = self._shape[1]
        full_l = self.ctx.n_limbs
        outs = [torch.empty((k, hi - lo, 2, n), dtype=torch.int32,
                            device=dev) for dev, lo, hi in slots]

        def on(dev):   # all limbs of the context on dev, for expand_a
            return self._eng.range_ctx(dev, 0, full_l)

        def sel(js, dev):   # rows of an output: all, or an index tensor
            return (slice(None) if len(js) == k
                    else torch.tensor(js, dtype=torch.int64, device=dev))

        def host_rows(js):   # the rows' u32 host data, stacked
            return np.stack([batch[j].data for j in js])

        def to(rows, lo, hi, dev):   # a limb range of host rows [K', L, ...]
            return torch.from_numpy(np.ascontiguousarray(
                rows[:, lo:hi]).view(np.int32)).to(dev)

        def ids(js):
            return torch.tensor([batch[j].a_row for j in js],
                                dtype=torch.int64)

        by_kind: dict[str, list[int]] = {}
        for j, r in enumerate(batch):
            by_kind.setdefault(r.kind, []).append(j)
        groups: dict[tuple[int, int], list[int]] = {}
        for j in by_kind.get("seeded", ()):
            groups.setdefault((batch[j].seed, batch[j].derive), []).append(j)
        mgroups: dict[int, list[int]] = {}
        for j in by_kind.get("masked", ()):
            mgroups.setdefault(id(batch[j].materials), []).append(j)
        with obs.span("wire.h2d", rows=k):
            full = host_rows(by_kind["full"]) if "full" in by_kind else None
            c0 = host_rows(by_kind["seeded"]) if "seeded" in by_kind \
                else None
            device = (torch.stack([batch[j].data
                                   for j in by_kind["device"]])
                      if "device" in by_kind else None)
            words = [torch.from_numpy(host_rows(gjs).view(np.int32)).to(
                self.ctx.device) for gjs in mgroups.values()]
            for out, (dev, lo, hi) in zip(outs, slots):
                if full is not None:
                    out[sel(by_kind["full"], dev)] = to(full, lo, hi, dev)
                if device is not None:
                    out[sel(by_kind["device"], dev)] = \
                        device[:, lo:hi].to(dev)
                if c0 is not None:
                    out[sel(by_kind["seeded"], dev), :, 0, :] = to(
                        c0, lo, hi, dev)
        unmasked = []
        for gjs, g_words in zip(mgroups.values(), words):
            sm = batch[gjs[0]].materials
            g_ids = ids(gjs)
            d_rows = (g_ids - sm.chunk_offset).to(self.ctx.device)
            unmasked.append((gjs, transcipher.unmask_c0(
                self.ctx, sm, g_words, d_rows),
                cipher.expand_a_for_ids(self.ctx, sm.a_seed, g_ids,
                                        sm.derive)))
        del words
        for out, (dev, lo, hi) in zip(outs, slots):
            for (seed, derive), gjs in groups.items():
                out[sel(gjs, dev), :, 1, :] = cipher.expand_a_for_ids(
                    on(dev), seed, ids(gjs), derive)[:, lo:hi]
            for gjs, m_c0, m_a in unmasked:
                out[sel(gjs, dev), :, 0, :] = m_c0[:, lo:hi].to(dev)
                out[sel(gjs, dev), :, 1, :] = m_a[:, lo:hi].to(dev)
        return outs

    def _grow(self, need: int) -> None:
        """Make room for chunk rows [0, need).  The first allocation cuts
        the rows evenly over the data slots and later growth extends the
        last slot's range, so no row changes slot."""
        l, n = self._shape
        eng, old = self._eng, self._acc
        if old is not None and old.shape[0] >= need:
            return
        rows = (Layout(eng.mesh).row_offsets(need) if old is None
                else old.rows[:-1] + (need,))
        k = l // eng.n_model

        def body(d, m):
            if old is not None and d < eng.n_data - 1:
                return (old.blocks[d][m],)
            block = torch.zeros((rows[d + 1] - rows[d], k, 2, n),
                                dtype=torch.int32,
                                device=eng.mesh.device(d, m))
            if old is not None:
                block[: old.blocks[d][m].shape[0]] = old.blocks[d][m]
            return (block,)

        self._acc, = eng.map_slots(body, ((need, l, 2, n), 0, -3, rows))

    def _fold(self, batch: list[_Ready]) -> None:
        """One accumulate launch a block over rows with distinct chunk
        indices: rows grouped by the data slot that owns their chunk index,
        each block's rows and accumulator rows on its own device, one
        ShardedHe.weighted_accum_chunks."""
        self._grow(max(r.chunk_idx for r in batch) + 1)
        eng, acc = self._eng, self._acc
        l, n = self._shape
        owned: list[list[_Ready]] = [[] for _ in range(eng.n_data)]
        for r in batch:
            owned[bisect.bisect_right(acc.rows, r.chunk_idx) - 1].append(r)
        rows = [0]
        for grp in owned:
            rows.append(rows[-1] + len(grp))
        k = l // eng.n_model
        cts, accs, ws, copy_back = [], [], [], []
        for d, grp in enumerate(owned):
            slots = [(eng.mesh.device(d, m), m * k, (m + 1) * k)
                     for m in range(eng.n_model)]
            cts.append(tuple(self._rows_to_blocks(grp, slots)))
            w = np.asarray([r.w_mont for r in grp], np.int32).reshape(
                len(grp), self.ctx.n_limbs)
            ws.append(tuple(torch.from_numpy(w[:, lo:hi].copy()).to(dev)
                            for dev, lo, hi in slots))
            local = [r.chunk_idx - acc.rows[d] for r in grp]
            a_row = []
            for m, (dev, _, _) in enumerate(slots):
                block = acc.blocks[d][m]
                if local == list(range(len(local))):
                    a_row.append(block[: len(local)])
                else:
                    sel = torch.tensor(local, dtype=torch.int64, device=dev)
                    a_row.append(block.index_select(0, sel))
                    copy_back.append((block, sel, a_row[-1]))
            accs.append(tuple(a_row))

        def grid(shape, blocks):
            return BlockGrid(eng.mesh, shape, 0, 1, tuple(rows),
                             tuple(blocks))

        a = grid((len(batch), l, 2, n), accs)
        eng.weighted_accum_chunks(a, grid((len(batch), l, 2, n), cts),
                                  grid((len(batch), l), ws), limb_axis=-3,
                                  out=a)
        for block, sel, rows_out in copy_back:
            block.index_copy_(0, sel, rows_out)
        self._rows.update(r.chunk_idx for r in batch)

    def flush(self) -> None:
        """Fold every ready row into the accumulator: one accumulate launch
        per pass (a second pass only if one chunk index was buffered twice,
        to keep arrival order), under a `wire.flush` span: its time beside
        its `wire.h2d`, `he.expand_a` and accumulate is the per-row host
        bookkeeping."""
        with obs.span("wire.flush", rows=len(self._pending)):
            while self._pending:
                batch, rest, seen = [], [], set()
                for item in self._pending:
                    if item.chunk_idx in seen:
                        rest.append(item)
                    else:
                        seen.add(item.chunk_idx)
                        batch.append(item)
                self._pending = rest
                self._fold(batch)
                self._m_launches.inc()
                self._note_decoded(-len(batch))

    def _plain_to_device(self, arr: np.ndarray, codec: str, qscale: float):
        """Dequantize on the device (f16 and i8 move half or a quarter of
        the bytes); the same float32 values as compress.dequantize_plain."""
        dev = self.ctx.device
        if arr.dtype in (np.float32, np.float16, np.int8):
            plain = torch.from_numpy(arr).to(dev).to(torch.float32)
            if codec == "i8":
                plain = plain * float(np.float32(qscale))
            return plain
        return torch.from_numpy(_c.dequantize_plain(arr, codec, qscale)).to(
            dev)

    def _fold_plain(self, plain: torch.Tensor, weight: float) -> None:
        """acc += float32(w) * plain: a separate float32 multiply and add,
        as the reference's numpy expression rounds."""
        if self._acc_plain is None:
            self._acc_plain = torch.zeros(plain.shape, dtype=torch.float32,
                                          device=self.ctx.device)
        elif plain.shape != self._acc_plain.shape:
            raise wf.WireError(
                f"plain segment shape {tuple(plain.shape)} does not match "
                f"this aggregation's {tuple(self._acc_plain.shape)}")
        self._acc_plain += torch.mul(plain, float(np.float32(weight)))

    # -- public API ---------------------------------------------------------

    def ingest(self, blob: bytes, weight: float) -> UpdateMeta:
        """Parse one client's frames, buffer its chunks, and flush them in
        one accumulate launch.

        The stream is validated against its own UPDATE_BEGIN header: the
        received chunk indices must be exactly {0..n_chunks-1}.  A rejected
        update raises WireError and leaves no trace in the state."""
        with obs.span("wire.ingest", nbytes=len(blob)) as sp:
            return self._ingest_spanned(blob, weight, sp)

    def _ingest_spanned(self, blob: bytes, weight: float, sp) -> UpdateMeta:
        meta = None
        w_mont = self._w_mont(weight)
        saw_end = False
        chunks_seen: set[int] = set()
        plain_segments = []            # folded only after validation
        n_buffered = 0
        escrow_prev: dict = {}         # escrow keys this update set ->
                                       # prior value (or _ESCROW_MISSING)
        prev_in_scale = self._in_scale
        prev_shape = self._shape
        try:
            with obs.span("wire.frames"):
                for ftype, _, payload in wf.iter_frames(blob):
                    if ftype == wf.T_UPDATE_BEGIN:
                        cid, n_samples, rnd, n_chunks, kind = \
                            _BEGIN.unpack_from(payload, 0)
                        if kind not in _CT_KINDS:
                            raise wf.WireError(
                                f"unknown ct_kind {kind} in UPDATE_BEGIN; "
                                f"this build implements {_CT_KINDS}")
                        meta = UpdateMeta(cid, n_samples, rnd, n_chunks,
                                          kind == CT_SEEDED,
                                          kind == CT_TRANSCIPHER)
                    elif ftype == wf.T_CT_CHUNK:
                        if meta is None:
                            raise wf.WireError("CT_CHUNK before UPDATE_BEGIN")
                        (chunk_idx,) = struct.unpack_from("<I", payload, 0)
                        if chunk_idx >= meta.n_chunks:
                            raise wf.WireError(
                                f"chunk index {chunk_idx} >= declared "
                                f"n_chunks {meta.n_chunks}")
                        if chunk_idx in chunks_seen:
                            raise wf.WireError(f"duplicate chunk {chunk_idx}")
                        chunks_seen.add(chunk_idx)
                        inner, _ = wf._deserialize(payload, None, off=4)
                        got = ("masked" if isinstance(inner, _c.MaskedChunk)
                               else "seeded"
                               if isinstance(inner, _c.SeededCiphertext)
                               else "full")
                        want = ("masked" if meta.transcipher
                                else "seeded" if meta.seeded else "full")
                        if got != want:
                            raise wf.WireError(
                                f"CT_CHUNK {chunk_idx} carries a {got} "
                                f"payload but the update's declared ct_kind "
                                f"expects {want}")
                        self._buffer_wire_chunk(meta, chunk_idx, inner, w_mont)
                        n_buffered += 1
                    elif ftype == wf.T_TRANSCIPHER_SEED:
                        if meta is None:
                            raise wf.WireError(
                                "TRANSCIPHER_SEED before UPDATE_BEGIN")
                        if not meta.transcipher:
                            raise wf.WireError(
                                "TRANSCIPHER_SEED frame in a non-transcipher "
                                "update (declared ct_kind is not "
                                "CT_TRANSCIPHER)")
                        sct, _ = wf._deserialize(payload, self.ctx, off=0)
                        if not isinstance(sct, _c.SeededCiphertext):
                            raise wf.WireError(
                                "TRANSCIPHER_SEED must nest a seeded-"
                                f"ciphertext frame, got {type(sct).__name__}")
                        escrow_key = (meta.cid, meta.round)
                        if escrow_key not in escrow_prev:
                            escrow_prev[escrow_key] = self.escrow_seeds.get(
                                escrow_key, _ESCROW_MISSING)
                        self.escrow_seeds[escrow_key] = sct
                    elif ftype == wf.T_PLAIN_SEGMENT:
                        arr, codec, qscale = wf._parse_plain_segment(payload)
                        ref_shape = (tuple(self._acc_plain.shape)
                                     if self._acc_plain is not None
                                     else plain_segments[0][0].shape
                                     if plain_segments else None)
                        if ref_shape is not None and arr.shape != ref_shape:
                            raise wf.WireError(
                                f"plain segment shape {arr.shape} does not "
                                f"match this aggregation's {ref_shape}")
                        plain_segments.append((arr, codec, qscale))
                    elif ftype == wf.T_UPDATE_END:
                        saw_end = True
                    else:
                        raise wf.WireError(f"unexpected frame type {ftype:#x} "
                                           "in update stream")
                if meta is None or not saw_end:
                    raise wf.WireError("truncated update stream")
                if len(chunks_seen) != meta.n_chunks:
                    raise wf.WireError(
                        f"update declared {meta.n_chunks} chunks, "
                        f"received {len(chunks_seen)}")
        except Exception as e:
            # rejected update: nothing of it may reach the accumulator
            if n_buffered:
                del self._pending[len(self._pending) - n_buffered:]
                self._note_decoded(-n_buffered)
            for key, prev in escrow_prev.items():
                if prev is _ESCROW_MISSING:
                    self.escrow_seeds.pop(key, None)
                else:
                    self.escrow_seeds[key] = prev
            self._in_scale = prev_in_scale
            self._shape = prev_shape
            self._m_rejected.inc()
            if isinstance(e, wf.WireError):
                raise
            raise wf.WireError(f"malformed update stream: {e!r}") from e
        with obs.span("wire.h2d", plain=True):
            for arr, codec, qscale in plain_segments:
                self._fold_plain(self._plain_to_device(arr, codec, qscale),
                                 weight)
        self.flush()
        self._m_clients.inc()
        self._m_bytes.inc(len(blob))
        sp.set(cid=meta.cid, round=meta.round, n_chunks=meta.n_chunks)
        return meta

    def ingest_update(self, upd: ProtectedUpdate, weight: float) -> None:
        """In-memory streaming (no serialization): the caller holds the
        whole decoded update; its rows are folded in one flush."""
        with obs.span("wire.ingest", in_memory=True):
            self._ingest_update(upd, weight)

    def _ingest_update(self, upd: ProtectedUpdate, weight: float) -> None:
        data = upd.ct.data
        if data.dtype != torch.int32 or data.dim() != 4:
            raise wf.WireError(f"update data {data.dtype} "
                               f"{tuple(data.shape)} is not int32 "
                               "[B, L, 2, N] residues")
        w_mont = self._w_mont(weight)
        self._check_row(upd.ct.scale, np.dtype(np.uint32),
                        (1,) + tuple(data.shape[1:]))
        for b in range(data.shape[0]):
            self._pending.append(_Ready(b, w_mont,
                                        data[b].to(self.ctx.device),
                                        kind="device"))
            self._note_decoded(+1)
        self.flush()
        self._fold_plain(upd.plain.to(self.ctx.device, torch.float32),
                         weight)
        self._m_clients.inc()

    # -- checkpointing ---------------------------------------------------------

    def export_state(self) -> tuple[dict, dict]:
        """-> (arrays, meta) in the JAX package's exact layout: chunk_idx
        int32[K], acc_ct u32[K, 2, L, N], acc_plain float32; meta holds the
        scale and the counters.  A JAX StreamIngest restores it and the
        other way round.  Raises RuntimeError with unflushed rows."""
        if self._pending:
            raise RuntimeError("cannot export StreamIngest state with "
                               "unflushed chunks pending; call flush()")
        idxs = sorted(self._rows)
        if idxs:
            acc_ct = np.ascontiguousarray(
                np.moveaxis(self._acc_rows(idxs), -3, -2))
        else:
            acc_ct = np.zeros((0, 2, 0, 0), dtype=np.uint32)
        arrays = {
            "chunk_idx": np.asarray(idxs, dtype=np.int32),
            "acc_ct": acc_ct,
            "acc_plain": (self._acc_plain.cpu().numpy().copy()
                          if self._acc_plain is not None
                          else np.zeros((0,), dtype=np.float32)),
        }
        meta = {
            "in_scale": self._in_scale,
            "has_plain": self._acc_plain is not None,
            "clients": self.clients_ingested,
            "bytes": self.bytes_ingested,
            "launches": self.accum_launches,
            "rejected": self.rejected_updates,
        }
        return arrays, meta

    def restore_state(self, arrays: dict, meta: dict) -> None:
        """Load a checkpointed accumulator (the export_state inverse, from
        this port or the JAX package) into this empty ingest; the counters
        resume at their checkpointed values."""
        if self._acc is not None or self._pending or self.clients_ingested:
            raise RuntimeError("restore_state needs a fresh StreamIngest")
        idxs = [int(i) for i in np.asarray(arrays["chunk_idx"]).tolist()]
        acc = np.asarray(arrays["acc_ct"], dtype=np.uint32)
        if idxs:
            l, n = int(acc.shape[-2]), int(acc.shape[-1])
            self._eng._check_limbs(l)
            self._shape = (l, n)
            self._grow(max(idxs) + 1)
            self._put_acc_rows(idxs, np.moveaxis(acc, -2, -3))
            self._rows = set(idxs)
        if meta.get("has_plain"):
            self._acc_plain = torch.from_numpy(np.asarray(
                arrays["acc_plain"], dtype=np.float32).copy()).to(
                    self.ctx.device)
        if meta.get("in_scale") is not None:
            self._in_scale = float(meta["in_scale"])
        self._m_clients.inc(int(meta.get("clients", 0)))
        self._m_bytes.inc(int(meta.get("bytes", 0)))
        self._m_launches.inc(int(meta.get("launches", 0)))
        self._m_rejected.inc(int(meta.get("rejected", 0)))

    def _acc_rows(self, idxs) -> np.ndarray:
        """Accumulator rows `idxs` as u32 host rows [K, L, 2, N] (each block
        copies its own rows to the host)."""
        acc, pos = self._acc, np.asarray(idxs)
        out = np.empty((len(idxs),) + acc.shape[1:], dtype=np.uint32)
        for d, m in acc.slots():
            (r0, r1), (lo, hi) = acc.row_range(d), acc.limb_range(m)
            js = np.nonzero((pos >= r0) & (pos < r1))[0]
            block = acc.blocks[d][m]
            out[js, lo:hi] = interop.residues_to_np(block.index_select(
                0, torch.from_numpy(pos[js] - r0).to(block.device)))
        return out

    def _put_acc_rows(self, idxs, rows) -> None:
        """Write u32 host rows [K, L, 2, N] to accumulator rows `idxs` (each
        block from the host directly)."""
        acc, pos = self._acc, np.asarray(idxs)
        for d in range(acc.mesh.n_data):
            for m in range(acc.mesh.n_model):
                (r0, r1), (lo, hi) = acc.row_range(d), acc.limb_range(m)
                js = np.nonzero((pos >= r0) & (pos < r1))[0]
                block = acc.blocks[d][m]
                block[torch.from_numpy(pos[js] - r0).to(block.device)] = \
                    interop.residues_from_np(rows[js, lo:hi], block.device)

    def finalize(self) -> ProtectedUpdate:
        """-> the aggregated ProtectedUpdate (ct scale = in_scale * delta),
        a copy of the accumulators (the ingest may go on).  Raises
        WireError if nothing arrived or chunk indices have holes."""
        self.flush()
        if self.clients_ingested == 0 or self._acc is None:
            raise wf.WireError("no updates ingested")
        n_chunks = max(self._rows) + 1
        if sorted(self._rows) != list(range(n_chunks)):
            raise wf.WireError("missing ciphertext chunks at finalize")
        # the hand-off to the downlink is the engine's counted gather of the
        # blocks (a copy: the ingest may go on)
        ct = Ciphertext(data=self._eng.gather(self._acc)[:n_chunks],
                        scale=self._in_scale * self.ctx.delta)
        plain = (self._acc_plain.clone() if self._acc_plain is not None
                 else torch.zeros((0,), dtype=torch.float32,
                                  device=self.ctx.device))
        return ProtectedUpdate(ct=ct, plain=plain)
