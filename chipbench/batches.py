"""The token batches of a training cell, made from `--seed` alone.

A client's local step in a round reads one batch of `rows` sequences of
`seq` tokens, uniform over the model's vocabulary; its labels are the
tokens shifted by one (next-token prediction).  Each (round, client, step)
has its own numpy generator, seeded through `inputs.sub_seed`, so the
program's stream and the reference make the same batch independently and
every seed gives batches of one size.
"""
from __future__ import annotations

import numpy as np

import inputs


def batch(seed: int, rnd, client: int, step: int, rows: int, seq: int,
          vocab: int) -> dict:
    """{"tokens", "labels"}: int32[rows, seq] each."""
    rng = np.random.Generator(np.random.PCG64(
        inputs.sub_seed(seed, "batch", rnd, client, step)))
    toks = rng.integers(0, vocab, size=(rows, seq + 1), dtype=np.int32)
    return {"tokens": np.ascontiguousarray(toks[:, :-1]),
            "labels": np.ascontiguousarray(toks[:, 1:])}


class Stream:
    """A client's data stream as `FLClient` reads it (`next_batch`): the
    batches of (round, client, 0), (round, client, 1), ... after
    `begin(round)`."""

    def __init__(self, seed: int, client: int, rows: int, seq: int,
                 vocab: int):
        self.seed, self.client = seed, client
        self.rows, self.seq, self.vocab = rows, seq, vocab
        self.rnd, self.step = None, 0

    def begin(self, rnd) -> None:
        self.rnd, self.step = rnd, 0

    def next_batch(self) -> dict:
        b = batch(self.seed, self.rnd, self.client, self.step, self.rows,
                  self.seq, self.vocab)
        self.step += 1
        return b
