"""Faults planted in the program underneath the harness, for the readings
that set a training cell's limits (`calibrate.py --control <fault>`) and
for the tests that see its `correct` come out false.  Each is a context
manager that patches the port's code while it is open; the harness and the
cell's driver run unchanged inside it.
"""
from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def patched(owner, name: str, make):
    """`owner.name` replaced by `make(real)` while open."""
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def _client():
    from repro_torch.fl import client

    return client


def _aggregator():
    from repro_torch.core import secure_agg

    return secure_agg.SelectiveHEAggregator


def one_step():
    """One local step where the traffic states more."""
    def make(real):
        def local_train(self, global_params):
            saved = self.cfg
            self.cfg = dataclasses.replace(saved, local_steps=1)
            try:
                return real(self, global_params)
            finally:
                self.cfg = saved
        return local_train
    return patched(_client().FLClient, "local_train", make)


def half_batch():
    """Half of each batch's rows left out, the mean taken over the rest."""
    def make(real):
        def next_batch(self):
            return {k: v[:v.shape[0] // 2] for k, v in real(self).items()}
        return next_batch
    return patched(_client().FLClient, "_next_batch", make)


def one_left_out():
    """The last client's update left out of the aggregate, the weights
    renormalised over the rest."""
    def make(real):
        def server_aggregate(self, updates, weights, sharded=None):
            w = [x / sum(weights[:-1]) for x in weights[:-1]]
            return real(self, updates[:-1], w)
        return server_aggregate
    return patched(_aggregator(), "server_aggregate", make)


def grad_flip():
    """The sign of one leaf's gradient flipped before the optimizer: the
    middle leaf of the tree (for mamba2 `layers/in_C`, all its layers), as
    a wrong backward of one projection would give."""
    from repro_torch.core import packing

    def make(real):
        def adamw_update(grads, *rest, **kw):
            leaves = packing.tree_leaves(grads)
            bad = leaves[len(leaves) // 2]
            grads = packing.tree_map(lambda g: -g if g is bad else g, grads)
            return real(grads, *rest, **kw)
        return adamw_update
    return patched(_client(), "adamw_update", make)


def unchanged_state():
    """A local step that returns its parameters and optimizer state
    unchanged (it still computes the loss and gradients)."""
    return patched(_client(), "adamw_update",
                   lambda real: lambda grads, state, params, *a, **kw:
                   (params, state, None))


@contextlib.contextmanager
def recovered_unchanged():
    """The recovered model returned unchanged: the round's incoming global
    model in the place of the decrypted aggregate."""
    incoming = {}

    def remember(real):
        def local_train(self, global_params):
            incoming["global"] = global_params
            return real(self, global_params)
        return local_train

    def unchanged(real):
        def client_recover_params(self, agg, sk, sharded=None):
            real(self, agg, sk)
            return incoming["global"]
        return client_recover_params

    with patched(_client().FLClient, "local_train", remember), \
            patched(_aggregator(), "client_recover_params", unchanged):
        yield
