"""FL task orchestration: the full paper pipeline (Figure 3), the JAX
package's `fl/orchestrator.py`.

  stage 1  key agreement        (KeyAuthority | ThresholdKeyAuthority)
  stage 2  encryption-mask calc (clients' sensitivity maps, HE-aggregated)
  stage 3  encrypted rounds     (Algorithm 1) with:
             - client sampling per round
             - dropout simulation (clients fail mid-round; weights
               renormalize over survivors — no protocol restart)
             - straggler deadlines (simulated wall-clock per client)
             - elastic client pool (join/leave between rounds)
             - round-boundary checkpointing + resume

Client sampling, dropout and stragglers draw from
`np.random.RandomState(seed)` in the JAX package's order, so the same seed
picks the same clients.  Keys are `torch.Generator`s: the initial model
from `seed`, each (round, client)'s encryption from a stream of its own,
agree_mask's from 7 and party i's partial decryption from 900 + i (the
integers of the JAX package's PRNGKeys; the draws differ).

Threshold mode with 0 < threshold_t < n decrypts through a Shamir t-of-n
sharing of the joint secret, dealt by the key authority; the JAX package
combines the additive partials of only t parties there, which cannot
decrypt (an additive sharing needs every party).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import interop, obs
from repro_torch.ckpt import CheckpointManager
from repro_torch.core import packing, secure_agg, selection
from repro_torch.core.ckks import threshold
from repro_torch.core.secure_agg import AggregatorConfig, SelectiveHEAggregator
from repro_torch.fl.client import FLClient
from repro_torch.fl.keys import KeyAuthority, ThresholdKeyAuthority
from repro_torch.fl.server import FLServer, ReceivedUpdate
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.wire import budget as wire_budget
from repro_torch.wire import compress as wire_compress
from repro_torch.wire import format as wire_format
from repro_torch.wire.compress import WirePolicy

ROUND_KEY_TAG = 0x5EC     # the per-(round, client) streams' entropy tag
SHAMIR_KEY_TAG = 0x5A3    # the Shamir sharing's entropy tag


def _generator(device, *entropy: int) -> torch.Generator:
    """A generator seeded from np.random.SeedSequence(entropy): distinct
    entropy tuples give distinct 64-bit seeds (collision-free in practice,
    where the JAX package folds keys with fold_in), unlike arithmetic such
    as seed * 1000 + client, which collides once client indices reach the
    stride."""
    state = np.random.SeedSequence(list(entropy)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


@dataclasses.dataclass
class FLRunConfig:
    n_rounds: int = 5
    clients_per_round: int = 0          # 0 = all
    dropout_prob: float = 0.0           # per-client, per-round
    straggler_prob: float = 0.0         # client exceeds the deadline
    deadline_s: float = float("inf")    # simulated round deadline
    threshold_mode: bool = False        # threshold HE decryption
    threshold_t: int = 0                # parties needed (0 = all)
    ckpt_dir: str | None = None
    ckpt_every: int = 1
    seed: int = 0
    # repro_torch.wire transport: None keeps the in-memory hand-off (comm
    # bytes estimated); a WirePolicy serializes every update, streams it
    # through the O(1)-memory server ingest, and logs measured bytes.
    wire_policy: WirePolicy | None = None


@dataclasses.dataclass
class RoundLog:
    round: int
    loss: float
    n_participating: int
    n_dropped: int
    comm_bytes: int
    wall_s: float
    comm_up_bytes: int = 0      # measured uplink (wire mode only)
    comm_down_bytes: int = 0    # measured downlink (wire mode only)
    comm_measured: bool = False  # True = bytes-on-wire, False = estimate


class FLTask:
    """Owns (model, clients, server, keys) and runs the 3-stage pipeline.
    Without `ctx` the key authority makes `make_context()` (a card)."""

    def __init__(self, model: Model, clients: list[FLClient],
                 agg_cfg: AggregatorConfig, run_cfg: FLRunConfig,
                 ctx=None):
        self.model = model
        self.clients = clients
        self.agg_cfg = agg_cfg
        self.run_cfg = run_cfg
        self.rng = np.random.RandomState(run_cfg.seed)

        # stage 1 — key agreement
        self._shamir = None
        if run_cfg.threshold_mode:
            n = len(clients)
            if not 0 <= run_cfg.threshold_t <= n:
                raise ValueError(f"threshold_t {run_cfg.threshold_t} is not "
                                 f"in [0, {n}]")
            self.authority = ThresholdKeyAuthority(
                n_parties=n, ctx=ctx, seed=run_cfg.seed)
            self.pk = self.authority.public_key()
            self.sk = None
            if 0 < run_cfg.threshold_t < n:
                self._shamir = self._deal_shamir(run_cfg.threshold_t)
        else:
            self.authority = KeyAuthority(ctx=ctx, seed=run_cfg.seed)
            self.pk, self.sk = self.authority.client_keys()
        self.ctx = self.authority.ctx

        self.global_params = model.init(
            torch.Generator(device=model.device).manual_seed(run_cfg.seed))
        self.server: FLServer | None = None
        self.aggregator: SelectiveHEAggregator | None = None
        # the task owns round accounting: always (re)attach its ledger, so
        # clients reused from a previous FLTask record into THIS task's
        # ledger rather than the old one
        self.ledger = wire_budget.BandwidthLedger()
        for c in clients:
            c.ledger = self.ledger
        self.logs: list[RoundLog] = []
        self._ckpt = (CheckpointManager(run_cfg.ckpt_dir)
                      if run_cfg.ckpt_dir else None)
        self._start_round = 0

    def _deal_shamir(self, t: int) -> list:
        """A t-of-n Shamir sharing of the additive parties' joint secret
        (the key authority acts as the trusted dealer)."""
        parties = self.authority.parties
        joint = parties[0].s_mont
        for p in parties[1:]:
            joint = ops.mod_add(joint, p.s_mont, self.authority.ctx)
        return threshold.shamir_share_secret(
            self.authority.ctx, {"s_mont": joint},
            _generator(self.authority.ctx.device, self.run_cfg.seed,
                       SHAMIR_KEY_TAG),
            len(parties), t)

    # -- stage 2: encryption-mask agreement -----------------------------------

    def agree_encryption_mask(self):
        spec = packing.make_flat_spec(self.global_params)
        if self.agg_cfg.strategy in ("all", "none", "random"):
            # sensitivity-free strategies: no map exchange needed
            sens = torch.zeros(spec.total, device=self.ctx.device)
            self.aggregator = SelectiveHEAggregator.build(
                self.ctx, self.global_params, sens, self.agg_cfg)
        else:
            # sensitivity-driven strategies (top_p / per_layer / recipe):
            # HE-aggregate the clients' local maps, then apply the
            # configured selector to the decrypted aggregate
            sens_maps = [c.sensitivity_map(self.global_params)
                         for c in self.clients]
            weights = [1.0 / len(sens_maps)] * len(sens_maps)
            if self.run_cfg.threshold_mode:
                # threshold path: aggregate in the clear between clients
                # (maps are lower-sensitivity than weights; the HE path is
                # exercised in single-key mode)
                glob = sum(w * s for w, s in zip(weights, sens_maps))
                mask = selection.build_mask(
                    glob.to(self.ctx.device), self.agg_cfg.strategy,
                    self.agg_cfg.p_ratio, offsets=spec.offsets,
                    sizes=spec.sizes, seed=self.agg_cfg.seed)
            else:
                mask = secure_agg.agree_mask(
                    self.ctx, self.pk, self.sk, sens_maps, weights,
                    self.agg_cfg.p_ratio,
                    torch.Generator(device=self.ctx.device).manual_seed(7),
                    strategy=self.agg_cfg.strategy, offsets=spec.offsets,
                    sizes=spec.sizes, seed=self.agg_cfg.seed)
            part = packing.make_partition(mask, self.ctx.slots)
            self.aggregator = SelectiveHEAggregator(
                self.ctx, spec, part, self.agg_cfg)
        self.server = FLServer(self.aggregator, ledger=self.ledger)
        return self.aggregator

    # -- resume ----------------------------------------------------------------

    def maybe_resume(self):
        if self._ckpt is None:
            return
        tree, step, _ = self._ckpt.restore(self.global_params)
        if tree is not None:
            self.global_params = interop.params_from_np(tree,
                                                        self.model.device)
            self._start_round = step + 1

    # -- stage 3: encrypted federated rounds ------------------------------------

    def run_round(self, rnd: int) -> RoundLog:
        with obs.span("round", round=rnd) as sp:
            log = self._run_round(rnd, sp)
            sp.set(loss=log.loss, n_participating=log.n_participating,
                   n_dropped=log.n_dropped, bytes_up=log.comm_up_bytes,
                   bytes_down=log.comm_down_bytes, wall_s=log.wall_s)
        return log

    def _run_round(self, rnd: int, sp) -> RoundLog:
        # perf_counter: monotonic, immune to wall-clock steps; RoundLog
        # wall_s is a duration, not a timestamp
        t0 = time.perf_counter()
        cfg = self.run_cfg
        n = len(self.clients)
        k = cfg.clients_per_round or n
        chosen = self.rng.choice(n, size=min(k, n), replace=False)

        use_wire = cfg.wire_policy is not None
        received, dropped = [], 0
        wire_blobs, wire_clients = [], []
        losses = []
        for ci in chosen:
            client = self.clients[ci]
            if self.rng.rand() < cfg.dropout_prob:
                dropped += 1
                continue                      # client crashed mid-round
            with obs.span("client", cid=int(ci)):
                local_params, loss = client.local_train(self.global_params)
                simulated_s = self.rng.exponential(1.0)
                if self.rng.rand() < cfg.straggler_prob:
                    simulated_s += cfg.deadline_s   # guaranteed late
                if simulated_s > cfg.deadline_s:
                    dropped += 1
                    continue                  # straggler cut at the deadline
                losses.append(loss)
                key = _generator(self.ctx.device, cfg.seed, ROUND_KEY_TAG,
                                 rnd, int(ci))
                if use_wire:
                    blob = client.protect_and_pack(
                        self.aggregator, local_params, rnd=rnd,
                        policy=cfg.wire_policy, pk=self.pk,
                        sk=None if cfg.threshold_mode else self.sk, key=key)
                    wire_blobs.append(blob)
                    wire_clients.append(client)
                else:
                    upd = self.aggregator.client_protect(local_params,
                                                         self.pk, key)
                    received.append(ReceivedUpdate(
                        cid=int(ci), update=upd,
                        n_samples=max(1, client.n_samples), round_sent=rnd))
                del local_params
        if not received and not wire_blobs:
            # total dropout: keep the old global model, log and move on
            return RoundLog(rnd, float("nan"), 0, dropped, 0,
                            time.perf_counter() - t0)
        if use_wire:
            agg, n_recv = self._wire_round(rnd, wire_blobs, wire_clients)
            del wire_blobs
            with obs.span("recover"):
                self.global_params = obs.maybe_block(self._recover(agg))
            up = self.ledger.total(wire_budget.UPLINK, rnd)
            down = self.ledger.total(wire_budget.DOWNLINK, rnd)
            log = RoundLog(rnd, float(np.mean(losses)), n_recv, dropped,
                           up + down, time.perf_counter() - t0,
                           comm_up_bytes=up, comm_down_bytes=down,
                           comm_measured=True)
        else:
            n_recv = len(received)
            with obs.span("aggregate", n_updates=n_recv):
                agg = self.server.aggregate_sync(received)
            del received
            with obs.span("recover"):
                self.global_params = obs.maybe_block(self._recover(agg))
            rep = self.aggregator.overhead_report()
            log = RoundLog(rnd, float(np.mean(losses)), n_recv, dropped,
                           rep["bytes_total"] * n_recv,
                           time.perf_counter() - t0)
        self.logs.append(log)
        if self._ckpt is not None and (rnd + 1) % cfg.ckpt_every == 0:
            with obs.span("checkpoint", round=rnd):
                self._ckpt.save(rnd, self.global_params,
                                extra={"loss": log.loss})
        return log

    def _wire_round(self, rnd, wire_blobs, wire_clients):
        """Serialized transport: stream blobs through the O(1) server
        ingest, apply the downlink policy, broadcast, deserialize."""
        policy = self.run_cfg.wire_policy
        with obs.span("aggregate", n_updates=len(wire_blobs)):
            agg = self.server.aggregate_wire(wire_blobs)
        with obs.span("broadcast", n_clients=len(wire_clients)):
            keep = policy.downlink_keep_limbs
            if (keep and keep < agg.ct.n_limbs
                    and not self.run_cfg.threshold_mode):
                agg = secure_agg.ProtectedUpdate(
                    ct=wire_compress.limb_drop(self.ctx, agg.ct, keep),
                    plain=agg.plain)
            blob_down = wire_format.serialize_update(agg)
            del agg
            out = None
            for client in wire_clients:
                out = client.receive_global(blob_down, self.ctx, rnd=rnd)
        return out, len(wire_clients)

    def _recover(self, agg):
        if not self.run_cfg.threshold_mode:
            return self.aggregator.client_recover_params(agg, self.sk)
        ctx = self.ctx
        gen = lambda i: torch.Generator(device=ctx.device).manual_seed(
            900 + i)
        if self._shamir is None:
            # additive n-of-n: every party's partial decryption
            partials = [self.authority.partial_decrypt(i, agg.ct, gen(i))
                        for i in range(self.authority.n_parties)]
        else:
            # Shamir t-of-n: the first t parties' partial decryptions
            active = list(range(self.run_cfg.threshold_t))
            partials = [threshold.shamir_partial_decrypt(
                ctx, self._shamir[i], active, agg.ct, gen(i)) for i in active]
        coeffs = threshold.combine_partials(ctx, agg.ct, partials)
        del partials
        enc = secure_agg.decode_coeffs(ctx, coeffs, agg.ct.scale)
        vec = packing.merge_by_mask(enc, agg.plain, self.aggregator.part)
        return packing.unflatten_params(vec, self.aggregator.spec)

    def run(self) -> list[RoundLog]:
        if self.aggregator is None:
            self.agree_encryption_mask()
        self.maybe_resume()
        for rnd in range(self._start_round, self.run_cfg.n_rounds):
            self.run_round(rnd)
        return self.logs

    # -- elasticity -------------------------------------------------------------

    def add_client(self, client: FLClient):
        """Elastic scale-up: new clients only need (pk, sk) + the public
        mask — no re-keying, no mask re-agreement."""
        client.ledger = self.ledger
        self.clients.append(client)

    def remove_client(self, cid: int):
        self.clients = [c for c in self.clients if c.cid != cid]


def run_federated_training(model: Model, clients: list[FLClient],
                           agg_cfg: AggregatorConfig,
                           run_cfg: FLRunConfig, ctx=None) -> FLTask:
    task = FLTask(model, clients, agg_cfg, run_cfg, ctx=ctx)
    task.run()
    return task
