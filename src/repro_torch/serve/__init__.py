"""repro_torch.serve — the aggregation service's layer (the JAX package's
`repro.serve`).  So far its quorum policy and the FedAvg weight law
(`quorum`), which `fl.server` uses; the round state machine
(`service`), the fault injector (`faults`) and the simulator (`sim`) come
with ROADMAP Queue A item 5."""
from repro_torch.serve.quorum import (FAIL_DEADLINE, SEAL_DEADLINE,
                                      SEAL_TARGET, QuorumPolicy,
                                      normalized_weights, staleness_weights)

__all__ = ["QuorumPolicy", "normalized_weights", "staleness_weights",
           "SEAL_TARGET", "SEAL_DEADLINE", "FAIL_DEADLINE"]
