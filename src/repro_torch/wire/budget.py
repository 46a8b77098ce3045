"""Per-round bandwidth ledger: measured bytes on the wire, not estimates
(the JAX package's `repro.wire.budget`, same classes and queries).

Every serialized artifact that crosses the network records an entry here:
direction, client, artifact class and byte count.  `record_blob` splits a
frame stream into per-class entries, so the paper's communication tables
come from real serialized sizes.  Each record also adds its bytes to the
registry series `wire_bytes_total{direction, kind}` (`repro_torch.obs`).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from repro_torch import obs
from repro_torch.wire import format as wf

UPLINK = "up"
DOWNLINK = "down"

# artifact classes
K_CIPHERTEXT = "ciphertext"
K_SEEDED_CT = "seeded_ciphertext"
K_PLAIN = "plain"
K_KEY = "key"
K_META = "meta"


@dataclasses.dataclass(frozen=True)
class WireRecord:
    round: int
    cid: int
    direction: str       # "up" | "down"
    kind: str            # artifact class (K_* above)
    nbytes: int


class BandwidthLedger:
    """Append-only log of measured wire traffic, with queries by round,
    client, direction and artifact class."""

    def __init__(self):
        self.records: list[WireRecord] = []

    def record(self, *, rnd: int, cid: int, direction: str, kind: str,
               nbytes: int) -> None:
        self.records.append(WireRecord(int(rnd), int(cid), direction, kind,
                                       int(nbytes)))
        obs.counter("wire_bytes_total", direction=direction,
                    kind=kind).inc(int(nbytes))

    # -- queries ------------------------------------------------------------

    def total(self, direction: str | None = None, rnd: int | None = None,
              kind: str | None = None, cid: int | None = None) -> int:
        """Sum of measured bytes over records matching every given filter
        (None matches all)."""
        return sum(r.nbytes for r in self.records
                   if (direction is None or r.direction == direction)
                   and (rnd is None or r.round == rnd)
                   and (kind is None or r.kind == kind)
                   and (cid is None or r.cid == cid))

    def round_summary(self, rnd: int) -> dict:
        """Measured bytes for one round, split by direction and artifact."""
        by_kind: dict[str, int] = defaultdict(int)
        clients = set()
        for r in self.records:
            if r.round != rnd:
                continue
            by_kind[f"{r.direction}/{r.kind}"] += r.nbytes
            clients.add(r.cid)
        up = self.total(UPLINK, rnd)
        down = self.total(DOWNLINK, rnd)
        return {
            "round": rnd,
            "n_clients": len(clients),
            "uplink_bytes": up,
            "downlink_bytes": down,
            "total_bytes": up + down,
            "by_kind": dict(by_kind),
        }

    def rounds(self) -> list[int]:
        return sorted({r.round for r in self.records})

    def per_client_uplink(self, rnd: int) -> dict[int, int]:
        out: dict[int, int] = defaultdict(int)
        for r in self.records:
            if r.round == rnd and r.direction == UPLINK:
                out[r.cid] += r.nbytes
        return dict(out)

    def record_blob(self, blob: bytes, *, rnd: int, cid: int,
                    direction: str) -> int:
        """Split a serialized frame stream into per-artifact-class entries.

        Returns the total bytes recorded (== len(blob) when every frame
        parses).  Header bytes count toward the class they envelope; a
        nested PROTECTED_UPDATE is split into its inner ct and plain
        classes, with the envelope counted as K_META."""
        off = 0
        total = 0
        while off < len(blob):
            ftype, _, payload, end = wf.parse_frame(blob, off)
            nbytes = end - off
            if ftype == wf.T_CT_CHUNK:
                inner_t, _, _, _ = wf.parse_frame(payload, 4)
                kind = (K_SEEDED_CT if inner_t == wf.T_SEEDED_CIPHERTEXT
                        else K_CIPHERTEXT)
            elif ftype == wf.T_CIPHERTEXT:
                kind = K_CIPHERTEXT
            elif ftype == wf.T_SEEDED_CIPHERTEXT:
                kind = K_SEEDED_CT
            elif ftype == wf.T_PLAIN_SEGMENT:
                kind = K_PLAIN
            elif ftype == wf.T_KEYSET:
                kind = K_KEY
            elif ftype == wf.T_PROTECTED_UPDATE:
                inner_off = 0
                while inner_off < len(payload):
                    it, _, _, inner_end = wf.parse_frame(payload, inner_off)
                    ik = (K_PLAIN if it == wf.T_PLAIN_SEGMENT else
                          K_SEEDED_CT if it == wf.T_SEEDED_CIPHERTEXT else
                          K_CIPHERTEXT)
                    self.record(rnd=rnd, cid=cid, direction=direction,
                                kind=ik, nbytes=inner_end - inner_off)
                    inner_off = inner_end
                self.record(rnd=rnd, cid=cid, direction=direction,
                            kind=K_META, nbytes=nbytes - len(payload))
                total += nbytes
                off = end
                continue
            else:
                kind = K_META
            self.record(rnd=rnd, cid=cid, direction=direction, kind=kind,
                        nbytes=nbytes)
            total += nbytes
            off = end
        return total

    # -- paper-table helpers -------------------------------------------------

    def compression_summary(self, ctx, part, rnd: int) -> dict:
        """Measured uplink vs the naive all-encrypted raw-u32 baseline
        (every client ships the whole model encrypted, uncompressed)."""
        ups = self.per_client_uplink(rnd)
        n_clients = max(1, len(ups))
        measured = sum(ups.values())
        naive = n_clients * ctx.encrypted_bytes(part.n_total, packed=False)
        return {
            "round": rnd,
            "n_clients": n_clients,
            "measured_uplink_bytes": measured,
            "uplink_bytes_per_client": measured // n_clients,
            "naive_all_encrypted_bytes": naive,
            "compression_ratio": naive / max(1, measured),
        }

    def report_rows(self) -> list[dict]:
        """One row per round."""
        return [self.round_summary(r) for r in self.rounds()]
