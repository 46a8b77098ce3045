"""FL aggregation server (the JAX package's `fl/server.py`).

Holds only the public crypto context + the SelectiveHEAggregator (static
mask indices).  Never sees secret keys.  Handles:
  * synchronous weighted aggregation over whatever updates arrived
    (dropout-robust: weights renormalize over the received set — HE needs
    no mask-recovery round, unlike secure aggregation, paper Table 1);
  * streaming wire ingest (repro_torch.wire.stream): serialized client
    updates fold chunk-by-chunk into the modular accumulator — O(1)
    server-side update buffers in the number of clients;
  * async FedBuff-style buffered aggregation with staleness discounting.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import obs
from repro_torch.core.secure_agg import ProtectedUpdate, SelectiveHEAggregator
from repro_torch.serve import quorum as serve_quorum
from repro_torch.wire import budget as wire_budget
from repro_torch.wire import stream as wire_stream


@dataclasses.dataclass
class ReceivedUpdate:
    cid: int
    update: ProtectedUpdate
    n_samples: int
    round_sent: int = 0          # for staleness in async mode


class FLServer:
    def __init__(self, aggregator: SelectiveHEAggregator,
                 buffer_size: int = 0, staleness_half_life: float = 4.0,
                 ledger: wire_budget.BandwidthLedger | None = None,
                 sharded=None):
        """Args:
            aggregator: the SelectiveHEAggregator (public ctx + mask).
            buffer_size: 0 => synchronous; >0 => async FedBuff buffer.
            staleness_half_life: async staleness discount half-life.
            ledger: optional BandwidthLedger for measured uplink bytes.
            sharded: optional core.ckks.sharded.ShardedHe engine; batch and
                streaming HE aggregation then run sharded over its mesh
                (chunks -> data axis, limbs -> model axis), bit-identical
                to the single-device path.
        """
        self.agg = aggregator
        self.buffer_size = buffer_size            # 0 => synchronous
        self.staleness_half_life = staleness_half_life
        self.ledger = ledger
        self.sharded = sharded
        self._buffer: list[ReceivedUpdate] = []
        self.rounds_aggregated = 0
        self.last_ingest: wire_stream.StreamIngest | None = None

    # -- synchronous ---------------------------------------------------------

    def aggregate_sync(self, received: list[ReceivedUpdate]) -> ProtectedUpdate:
        if not received:
            raise ValueError("no client updates received this round")
        weights = np.asarray([r.n_samples for r in received], dtype=np.float64)
        weights = weights / weights.sum()
        out = self.agg.server_aggregate([r.update for r in received],
                                        [float(w) for w in weights],
                                        sharded=self.sharded)
        self.rounds_aggregated += 1
        return out

    # -- streaming wire ingest (repro_torch.wire) ----------------------------

    def aggregate_wire(self, blobs: list[bytes]) -> ProtectedUpdate:
        """Aggregate serialized client updates without materializing them.

        Pass 1 reads only the fixed-size UPDATE_BEGIN headers to normalize
        FedAvg weights; pass 2 streams each blob through the chunked modular
        accumulator (one in-flight update's chunks at any time — the
        decoded-update memory footprint does not grow with len(blobs)).
        """
        if not blobs:
            raise ValueError("no client updates received this round")
        metas = [wire_stream.peek_update_meta(b) for b in blobs]
        weights = np.asarray([m.n_samples for m in metas], dtype=np.float64)
        weights = weights / weights.sum()
        ingest = wire_stream.StreamIngest(self.agg.ctx, sharded=self.sharded)
        for blob, meta, w in zip(blobs, metas, weights):
            ingest.ingest(blob, float(w))
            if self.ledger is not None:
                # uplink is accounted where it arrives (the server);
                # clients account the downlink they receive
                self.ledger.record_blob(blob, rnd=meta.round, cid=meta.cid,
                                        direction=wire_budget.UPLINK)
        self.last_ingest = ingest
        self.rounds_aggregated += 1
        with obs.span("wire.finalize", n_updates=len(blobs),
                      launches=ingest.accum_launches):
            return ingest.finalize()

    # -- async (FedBuff) -----------------------------------------------------

    def submit_async(self, r: ReceivedUpdate,
                     current_round: int) -> ProtectedUpdate | None:
        """Buffer an update; aggregate + flush when the buffer fills.
        Staleness discount: w *= 0.5 ** (staleness / half_life) — the
        shared weight law in serve.quorum."""
        self._buffer.append(r)
        if len(self._buffer) < self.buffer_size:
            return None
        ws = serve_quorum.staleness_weights(
            [u.n_samples for u in self._buffer],
            [u.round_sent for u in self._buffer],
            current_round, self.staleness_half_life)
        out = self.agg.server_aggregate([u.update for u in self._buffer],
                                        ws, sharded=self.sharded)
        self._buffer.clear()
        self.rounds_aggregated += 1
        return out
