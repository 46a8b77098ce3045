"""Quorum policy: when may a round seal, and with what client weights.

A round of the aggregation service accepts updates while OPEN and seals —
freezing the accepted set — when the policy says so.  Sealing is the
partial-quorum contract of every HE-FL serving system (paper §4; flwr's
failure-handling contract minus its decrypt-at-server hole): the server
never waits for the full fleet, it waits for `min_clients` and a reason
to stop (the optional `target_clients` high-water mark, or the round
deadline).  Below `min_clients` a round can NEVER finalize.

Weight math lives here so every aggregation path (the service,
`FLServer.aggregate_wire`, the async FedBuff buffer) computes FedAvg
weights through the same float64 expressions and stays bit-identical.
The JAX package's `serve/quorum.py` line for line: the same numpy
expressions give the same weights, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# reasons should_seal can return (None = keep accepting)
SEAL_TARGET = "target"        # target_clients accepted
SEAL_DEADLINE = "deadline"    # deadline passed with quorum met
FAIL_DEADLINE = "deadline_below_quorum"   # deadline passed, quorum NOT met


@dataclasses.dataclass(frozen=True)
class QuorumPolicy:
    """Partial-quorum finalization policy for one service round.

    Attributes:
        min_clients: quorum floor — a round below this NEVER finalizes
            (it fails at the deadline instead).
        target_clients: optional high-water mark; the round seals as soon
            as this many updates were accepted (stragglers past it are
            late).  None = seal only at the deadline.
        deadline_s: optional round deadline in seconds since open; updates
            arriving later are rejected as ``late`` and the round seals
            (quorum met) or fails (quorum unmet) at the next poll.
            None = no deadline (the driver must seal explicitly).
    """

    min_clients: int = 2
    target_clients: int | None = None
    deadline_s: float | None = None

    def __post_init__(self):
        if self.min_clients < 1:
            raise ValueError(f"min_clients must be >= 1, got "
                             f"{self.min_clients}")
        if self.target_clients is not None \
                and self.target_clients < self.min_clients:
            raise ValueError(
                f"target_clients ({self.target_clients}) must be >= "
                f"min_clients ({self.min_clients})")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got "
                             f"{self.deadline_s}")

    def met(self, n_accepted: int) -> bool:
        """True iff `n_accepted` updates satisfy the quorum floor."""
        return n_accepted >= self.min_clients

    def late(self, elapsed_s: float) -> bool:
        """True iff an update arriving `elapsed_s` after round open missed
        the deadline."""
        return self.deadline_s is not None and elapsed_s > self.deadline_s

    def should_seal(self, n_accepted: int, elapsed_s: float) -> str | None:
        """-> SEAL_TARGET | SEAL_DEADLINE | FAIL_DEADLINE | None.

        None means the round stays open.  FAIL_DEADLINE means the round
        can no longer reach quorum in time and must fail."""
        if self.target_clients is not None \
                and n_accepted >= self.target_clients:
            return SEAL_TARGET
        if self.deadline_s is not None and elapsed_s > self.deadline_s:
            return SEAL_DEADLINE if self.met(n_accepted) else FAIL_DEADLINE
        return None


def normalized_weights(n_samples: Sequence[int]) -> list[float]:
    """FedAvg weights over the accepted set: n_i / sum(n).

    The same float64 expression `FLServer.aggregate_wire` uses, extracted
    so the service's partial-quorum renormalization is bit-identical to
    the synchronous reference path.
    """
    w = np.asarray(list(n_samples), dtype=np.float64)
    if w.size == 0 or w.sum() <= 0:
        raise ValueError("cannot normalize weights over an empty or "
                         "zero-sample accepted set")
    w = w / w.sum()
    return [float(x) for x in w]


def staleness_weights(n_samples: Sequence[int],
                      rounds_sent: Sequence[int],
                      current_round: int,
                      half_life: float) -> list[float]:
    """FedBuff staleness-discounted FedAvg weights.

    w_i ∝ n_i * 0.5 ** (staleness_i / half_life), normalized to sum to 1 —
    the float64 math of `FLServer.submit_async`.
    """
    ws = []
    for n, sent in zip(n_samples, rounds_sent):
        stale = max(0, current_round - sent)
        ws.append(n * 0.5 ** (stale / half_life))
    ws = np.asarray(ws, dtype=np.float64)
    if ws.size == 0 or ws.sum() <= 0:
        raise ValueError("cannot normalize staleness weights over an empty "
                         "or zero-sample buffer")
    ws = ws / ws.sum()
    return [float(w) for w in ws]
