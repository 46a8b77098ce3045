"""repro_torch.serve — the async encrypted aggregation service (the JAX
package's `repro.serve`, DESIGN.md §14).

A round state machine (`service.AggregationService`) that drives
`wire.stream.StreamIngest` asynchronously — accepting round r+1's updates
while round r finalizes — with partial-quorum finalization
(`quorum.QuorumPolicy`, whose FedAvg weight law `fl.server` shares),
atomic rejection of faulty or late updates, and accumulator +
budget-ledger + round-state checkpointing through `ckpt/store.py` so a
`kill -9` mid-round resumes bit-exactly.  `faults.py` is the service's
adversary: a deterministic injector for wire faults (drop / duplicate /
truncate / garbage / delay / reorder) and crash points between service
transitions; `sim.py` mints a client fleet from template blobs.
"""
from repro_torch.serve.faults import (CRASH_POINTS, FAULT_MODES,
                                      FaultInjector, SimulatedCrash,
                                      corrupt_blob)
from repro_torch.serve.quorum import (FAIL_DEADLINE, SEAL_DEADLINE,
                                      SEAL_TARGET, QuorumPolicy,
                                      normalized_weights, staleness_weights)
from repro_torch.serve.service import (ST_DONE, ST_FAILED, ST_FOLDING,
                                       ST_OPEN, ST_SEALED, AggregationService,
                                       RoundState, SubmitResult)

__all__ = [
    "AggregationService", "RoundState", "SubmitResult",
    "ST_OPEN", "ST_SEALED", "ST_FOLDING", "ST_DONE", "ST_FAILED",
    "QuorumPolicy", "normalized_weights", "staleness_weights",
    "SEAL_TARGET", "SEAL_DEADLINE", "FAIL_DEADLINE",
    "FAULT_MODES", "CRASH_POINTS", "FaultInjector", "SimulatedCrash",
    "corrupt_blob",
]
