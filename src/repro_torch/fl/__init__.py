"""Federated-learning roles (the JAX package's `repro.fl`): the key
authorities (`keys`), the client (`client`: local training, the uplink,
sensitivity maps), the server (`server`: synchronous, streaming-wire and
FedBuff aggregation) and the orchestrator (`orchestrator`: the paper's
three-stage pipeline)."""
from repro_torch.fl.keys import KeyAuthority, ThresholdKeyAuthority
from repro_torch.fl.client import ClientConfig, FLClient
from repro_torch.fl.server import FLServer
from repro_torch.fl.orchestrator import (FLRunConfig, FLTask, RoundLog,
                                         run_federated_training)
from repro_torch.wire import BandwidthLedger, WirePolicy

__all__ = ["KeyAuthority", "ThresholdKeyAuthority", "FLClient",
           "ClientConfig", "FLServer", "FLTask", "FLRunConfig", "RoundLog",
           "run_federated_training", "BandwidthLedger", "WirePolicy"]
