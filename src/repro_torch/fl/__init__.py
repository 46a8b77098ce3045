"""Federated-learning roles.  So far the key authorities (`keys`); the
client, server and orchestrator are still to be ported."""
from repro_torch.fl.keys import KeyAuthority, ThresholdKeyAuthority

__all__ = ["KeyAuthority", "ThresholdKeyAuthority"]
