"""Synthetic data pipeline: deterministic LM token streams + federated
non-IID (Dirichlet) partitioning.

Each client gets a seeded generator over its own token distribution so FL
runs are reproducible and clients are genuinely heterogeneous (the paper's
sensitivity-map aggregation exists precisely because client data differ).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Markov-ish synthetic LM stream: each client mixes a shared bigram
    table with a client-specific unigram prior."""

    vocab: int
    seq_len: int
    batch_size: int
    client_prior: np.ndarray        # [vocab] probability
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)
        base = np.random.RandomState(1234)
        self._shift = base.randint(1, self.vocab)

    def next_batch(self) -> dict:
        b, s, v = self.batch_size, self.seq_len, self.vocab
        first = self._rng.choice(v, size=(b, 1), p=self.client_prior)
        noise = self._rng.randint(0, v, size=(b, s))
        toks = np.empty((b, s), dtype=np.int64)
        toks[:, :1] = first
        for t in range(1, s):
            # deterministic bigram + 10% client-prior noise
            nxt = (toks[:, t - 1] * 31 + self._shift) % v
            use_noise = self._rng.rand(b) < 0.1
            toks[:, t] = np.where(use_noise, noise[:, t], nxt)
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}


def dirichlet_partition(n_clients: int, vocab: int, alpha: float = 0.5,
                        seed: int = 0) -> list[np.ndarray]:
    """Client-specific unigram priors ~ Dirichlet(alpha) (non-IID)."""
    rng = np.random.RandomState(seed)
    priors = rng.dirichlet([alpha] * vocab, size=n_clients)
    return [p / p.sum() for p in priors]


def make_client_streams(n_clients: int, vocab: int, seq_len: int,
                        batch_size: int, alpha: float = 0.5,
                        seed: int = 0) -> list[SyntheticLM]:
    priors = dirichlet_partition(n_clients, vocab, alpha, seed)
    return [SyntheticLM(vocab=vocab, seq_len=seq_len, batch_size=batch_size,
                        client_prior=priors[i], seed=seed * 1000 + i)
            for i in range(n_clients)]
