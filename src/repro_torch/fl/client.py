"""FL client: local training + selective encryption of the outgoing model
(the JAX package's `fl/client.py`).

Supports FedAvg (plain local SGD/AdamW) and FedProx (proximal term against
the incoming global model).  JAX jits the local step; here it runs eagerly
through `models.value_and_grad`.  The uplink mode is an argument only: the
JAX package also reads REPRO_UPLINK_MODE, and no environment variable
switches anything in the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import models, obs
from repro_torch.core import packing, sensitivity
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.wire import budget as wire_budget
from repro_torch.wire import compress as wire_compress
from repro_torch.wire import format as wire_format
from repro_torch.wire import stream as wire_stream


UPLINK_MODES = ("auto", "full", "seeded", "transcipher")


def uplink_a_seed(rnd: int, cid: int) -> int:
    """The per-(client, round) public seed every uplink path keys its a
    stream (and, via transcipher.provision's escrow offset, the escrow
    frame's a stream) from.  One shared definition so the client and the
    server-side provisioner agree without negotiation.  PUBLIC by design —
    the transcipher keystream seed is deliberately NOT derived from it
    (transcipher.provision draws it from secret material)."""
    return rnd * 1_000_003 + cid


@dataclasses.dataclass(frozen=True)
class ClientConfig:
    local_steps: int = 4
    lr: float = 1e-3
    prox_mu: float = 0.0           # FedProx coefficient (0 = FedAvg)
    optimizer: str = "adamw"       # adamw | sgd
    sensitivity_probes: int = 4


class FLClient:
    def __init__(self, cid: int, model: Model, stream,
                 cfg: ClientConfig = ClientConfig(),
                 ledger: wire_budget.BandwidthLedger | None = None):
        self.cid = cid
        self.model = model
        self.stream = stream
        self.cfg = cfg
        self.ledger = ledger           # shared wire-bandwidth ledger (opt.)
        self._step = self._make_step()
        self.n_samples = 0

    def _next_batch(self) -> dict:
        return {k: torch.from_numpy(v).to(self.model.device)
                for k, v in self.stream.next_batch().items()}

    # -- local training -------------------------------------------------------

    def _make_step(self):
        loss_fn = self.model.loss_fn
        mu = self.cfg.prox_mu
        lr = self.cfg.lr
        opt_cfg = AdamWConfig(lr=lr, weight_decay=0.0)

        def objective(params, batch, global_params):
            loss = loss_fn(params, batch)
            if mu > 0.0:
                prox = sum(torch.sum((p.float() - g.float()) ** 2)
                           for p, g in zip(packing.tree_leaves(params),
                                           packing.tree_leaves(global_params)))
                loss = loss + 0.5 * mu * prox
            return loss

        grad_fn = models.value_and_grad(objective)
        if self.cfg.optimizer == "sgd":
            def step(params, opt_state, batch, global_params):
                loss, grads = grad_fn(params, batch, global_params)
                params = packing.tree_map(
                    lambda p, g: p - lr * g.to(p.dtype), params, grads)
                return params, opt_state, loss
            return step

        def step(params, opt_state, batch, global_params):
            loss, grads = grad_fn(params, batch, global_params)
            params, opt_state, _ = adamw_update(grads, opt_state, params,
                                                opt_cfg)
            return params, opt_state, loss
        return step

    def local_train(self, global_params) -> tuple[dict, float]:
        """E local steps from the incoming global model. Returns
        (local params, mean loss)."""
        with obs.span("local_train", cid=self.cid,
                      steps=self.cfg.local_steps) as sp:
            params = global_params
            opt_state = adamw_init(params)
            losses = []
            for _ in range(self.cfg.local_steps):
                batch = self._next_batch()
                params, opt_state, loss = self._step(params, opt_state, batch,
                                                     global_params)
                losses.append(float(loss))
                self.n_samples += int(batch["tokens"].shape[0]) \
                    if "tokens" in batch \
                    else int(next(iter(batch.values())).shape[0])
            params = obs.maybe_block(params)
            sp.set(loss=float(np.mean(losses)))
        return params, float(np.mean(losses))

    # -- wire: serialized uplink/downlink (repro_torch.wire) -------------------

    def protect_and_pack(self, aggregator, local_params, *, rnd: int,
                         policy: wire_compress.WirePolicy,
                         pk: dict | None = None, sk: dict | None = None,
                         key: torch.Generator | None = None, sharded=None,
                         mode: str = "auto", derive: int | None = None,
                         transcipher_materials=None) -> bytes:
        """Protect the local update and serialize it for the uplink.

        `mode` picks the uplink path:

          * "auto"        — seeded when policy.seed_ciphertexts and sk is
                            available, else full public-key ciphertexts.
          * "full"        — public-key ciphertexts (requires pk).
          * "seeded"      — secret-key seeded path; the wire carries
                            (seed, c0), roughly half the ciphertext bytes.
                            `derive` picks the per-chunk derivation id the
                            frames advertise (DESIGN.md §9.2).
          * "transcipher" — thin-client hybrid path (DESIGN.md §15): the
                            wire carries keystream-masked coefficients (no
                            client NTT, 1/L of the seeded ciphertext
                            bytes) plus the escrow seed ciphertext from
                            the pre-provisioned `transcipher_materials`
                            (a transcipher.ClientMaterials for
                            (cid, rnd); its a_seed must be
                            uplink_a_seed(rnd, cid)).

        `key` (a torch.Generator on the context's device) draws the
        encryption noise and the optional Laplace noise; by default it is
        seeded with rnd * 100_003 + cid (the JAX package's PRNGKey of that
        integer).  With `sharded` (a core.ckks.sharded.ShardedHe), the
        weights -> ciphertext graph runs over its mesh and the emitted
        frames are byte-identical to the single-device client's.  Bytes are
        accounted at the receiving end: the server ledgers this uplink blob
        when it ingests it (FLServer.aggregate_wire); this client ledgers
        the downlink it receives (receive_global).
        """
        if mode not in UPLINK_MODES:
            raise ValueError(f"unknown uplink mode {mode!r}; expected one of "
                             f"{UPLINK_MODES}")
        if mode == "auto":
            mode = "seeded" if policy.seed_ciphertexts and sk is not None \
                else "full"
        key = key if key is not None else torch.Generator(
            device=aggregator.ctx.device).manual_seed(rnd * 100_003 + self.cid)
        a_seed = uplink_a_seed(rnd, self.cid)
        n_samples = max(1, self.n_samples)
        with obs.span("encrypt", cid=self.cid, round=rnd, mode=mode,
                      seeded=mode == "seeded") as sp:
            if mode == "transcipher":
                cm = transcipher_materials
                if cm is None:
                    raise ValueError(
                        "mode='transcipher' needs transcipher_materials (a "
                        "core.ckks.transcipher.ClientMaterials provisioned "
                        "for this (cid, round) — DESIGN.md §15)")
                if int(cm.a_seed) != a_seed:
                    raise ValueError(
                        f"transcipher materials a_seed {cm.a_seed} != "
                        f"uplink_a_seed({rnd}, {self.cid}) = {a_seed}; "
                        f"provision per (client, round)")
                masked, plain = aggregator.client_protect_transcipher(
                    local_params, cm, key)
                mc = wire_compress.MaskedChunk(
                    masked=masked, a_seed=cm.a_seed, scale=cm.scale,
                    chunk_offset=cm.chunk_offset, derive=cm.derive)
                blob = wire_stream.pack_masked_update_frames(
                    mc, wire_compress.seed_compress(cm.seed_ct,
                                                    cm.escrow_a_seed,
                                                    cm.derive),
                    plain, cid=self.cid, n_samples=n_samples, rnd=rnd,
                    plain_codec=policy.plain_codec)
                sp.set(nbytes=len(blob))
                return blob
            seeded = None
            if mode == "seeded":
                if sk is None:
                    raise ValueError("mode='seeded' needs sk")
                drv = derive if derive is not None \
                    else wire_compress.DERIVE_FOLD_CHUNK
                upd = aggregator.client_protect_seeded(local_params, sk, key,
                                                       a_seed,
                                                       sharded=sharded,
                                                       derive=drv)
                seeded = wire_compress.seed_compress(upd.ct, a_seed,
                                                     derive=drv)
            else:
                upd = aggregator.client_protect(local_params, pk, key,
                                                sharded=sharded)
            blob = wire_stream.pack_update_frames(
                upd, cid=self.cid, n_samples=n_samples, rnd=rnd,
                seeded=seeded, plain_codec=policy.plain_codec)
            sp.set(nbytes=len(blob))
        return blob

    def receive_global(self, blob: bytes, ctx, *, rnd: int):
        """Deserialize the broadcast global update, recording downlink
        bytes against this client."""
        with obs.span("recv_global", cid=self.cid, round=rnd,
                      nbytes=len(blob)):
            if self.ledger is not None:
                self.ledger.record_blob(blob, rnd=rnd, cid=self.cid,
                                        direction=wire_budget.DOWNLINK)
            upd, _ = wire_format.deserialize(blob, ctx)
        return upd

    # -- privacy sensitivity (paper §2.4 Step 1) ------------------------------

    def _soft_labels(self, batch: dict):
        """(features, one-hot float32 labels) of a batch.  A label < 0 or
        >= vocab (an ignored position) gets a zero row, as jax.nn.one_hot
        gives it."""
        label_key = "labels" if "labels" in batch else "targets"
        labels = batch[label_key]
        y_soft = (labels[..., None] == torch.arange(
            self.model.cfg.vocab, device=labels.device)).float()
        return {k: v for k, v in batch.items() if k != label_key}, y_soft

    def sensitivity_map(self, params, gen: torch.Generator | None = None):
        """Flat |d(grad)/dy| estimate on one local batch (soft labels), a
        float tensor on the model's device.  The probes come from `gen`
        (default: seeded with cid, as JAX's PRNGKey(cid))."""
        gen = gen if gen is not None else torch.Generator(
            device=self.model.device).manual_seed(self.cid)
        feats, y_soft = self._soft_labels(self._next_batch())
        probes = sensitivity.sample_probes(y_soft, gen,
                                           self.cfg.sensitivity_probes)
        return self._sensitivity(params, feats, y_soft, probes)

    def sensitivity_map_from_probes(self, params, batch: dict, probes):
        """The map of `sensitivity_map` on the given batch (tensors with
        labels) and probes (each shaped like its one-hot labels)."""
        feats, y_soft = self._soft_labels(batch)
        return self._sensitivity(params, feats, y_soft, probes)

    def _sensitivity(self, params, feats, y_soft, probes):
        # torch.func refuses checkpointing: the forward runs with remat off
        # (the same values)
        cfg = dataclasses.replace(self.model.cfg, remat=False)
        ax = self.model.ax
        fwd = models.family_module(cfg).forward_logits
        vocab = cfg.vocab

        def loss_of_y(p, feats_, y):
            logits, _ = fwd(p, dict(feats_), cfg, ax)
            logits = logits[..., :vocab]
            logp = torch.log_softmax(logits.float(), dim=-1)
            return -torch.mean(torch.sum(y * logp, dim=-1))

        smap = sensitivity.sensitivity_jvp_from_probes(
            loss_of_y, params, feats, y_soft, probes)
        vec, _ = packing.flatten_params(smap)
        return vec
