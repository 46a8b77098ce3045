"""The aggregation service as an operator runs it: rounds of seeded client
uploads through `AggregationService` on its worker thread.

Set-up encrypts and packs `templates` client uploads
(`client_protect_seeded` with a unique `a_seed`, `seed_compress`,
`pack_update_frames` with the traffic's plain codec) and builds a fleet of
`fleet` simulated clients over them, each with a seeded sample count.  It
then folds one blob through a throw-away service to warm every shape.

The window is a closed loop: each round opens, takes the next
`clients_per_round` clients' blobs as fast as `submit` accepts them, and
seals at its target; the worker folds it while the driver opens and fills
the next round.  Each blob is minted just before its submit: one copy of a
template with its header rewritten, as a receive buffer holds it.  A round
ends when its result is serialized for the downlink.  The first
`MIN_ROUNDS` rounds always start; a later one starts only while the
window's clock plus the time of the last round that ended is under
`--seconds`.  The window ends when the last round ends.
"""
from __future__ import annotations

import collections
import time

import torch

import inputs
from fleet import Fleet
from kinds import common
from reference import fedavg, frames, judge

from repro_torch import obs
from repro_torch.serve import quorum as qr
from repro_torch.serve import service as svc_mod
from repro_torch.wire import compress, stream
from repro_torch.wire import format as wf

METRICS = ("agg_rate",)
NUMBERS = ("downlink_len_err", "downlink_layout_err", "folded_err",
           "plain_err", "enc_err")
# lower-precision controls: the CKKS scale 2**20 below the stated 2**26;
# the i8 plain codec below the stated f16
CONTROLS = {"delta20": {"delta_bits": 20}, "i8": {"plain_codec": "i8"}}
POLL_S = 0.001
MIN_ROUNDS = 2


class Cell:
    def __init__(self, cfg, traffic, run, delta_bits=None, plain_codec=None):
        self.cfg, self.traffic, self.run = cfg, traffic, run
        self.ck = common.ckks_params(cfg, delta_bits)
        self.p = float(traffic["p_ratio"])
        self.offset_std = float(traffic["offset_std"])
        self.per_round = int(traffic["clients_per_round"])
        self.codec = plain_codec or traffic["plain_codec"]
        self.pick = inputs.sub_seed(run.seed, "pick") % int(
            traffic["checked_rounds"])
        self.kept = None

    def _template(self, t: int) -> bytes:
        run, agg = self.run, self.agg
        vec = inputs.client_vector(self.base, run.seed, "template", t,
                                   self.offset_std)
        seed = inputs.a_seed(run.seed, "template", t)
        upd = agg.client_protect_seeded(
            inputs.tree(self.cfg, vec), self.sk,
            inputs.generator(run.device, run.seed, "noise", "template", t),
            seed)
        return stream.pack_update_frames(
            upd, cid=t, n_samples=1, rnd=0,
            seeded=compress.seed_compress(upd.ct, seed),
            plain_codec=self.codec)

    def setup(self):
        run, tr = self.run, self.traffic
        self.ctx, self.sk, _, self.base, self.agg = common.build(
            self.cfg, self.ck, self.p, run)
        run.geometry.update(kind="service", clients=self.per_round)
        self.fleet = Fleet([self._template(t)
                            for t in range(int(tr["templates"]))],
                           inputs.n_samples(run.seed, "fleet",
                                            int(tr["fleet"]),
                                            *tr["n_samples"]))
        warm = svc_mod.AggregationService(
            self.ctx, qr.QuorumPolicy(min_clients=1, target_clients=1))
        warm.open_round()
        warm.submit(self.fleet.blob(0, 0))
        warm.drain()
        warm.result(0)
        del warm
        self.svc = svc_mod.AggregationService(
            self.ctx, qr.QuorumPolicy(min_clients=self.per_round,
                                      target_clients=self.per_round))
        self.svc.start(POLL_S)
        run.sync()

    def _finish(self, rnd, opened, cids):
        run, svc = self.run, self.svc
        with run.span("bench.wait"):
            while svc.status(rnd) not in (svc_mod.ST_DONE,
                                          svc_mod.ST_FAILED):
                if svc.worker_error is not None:
                    raise RuntimeError("the service's worker failed") \
                        from svc.worker_error
                time.sleep(POLL_S)
        info = svc.round_info(rnd)
        res = svc.result(rnd)
        with run.span("bench.downlink"):
            blob = wf.serialize_update(res)
        run.units.append(time.perf_counter() - opened)
        self.folded += info["folded"]
        self.rejected += info["bad_after_accept"]
        if rnd == self.pick or self.kept is None:
            self.kept = {"round": rnd, "cids": cids, "downlink": blob,
                         "folded": info["folded"]}
        del res, blob
        svc.forget_round(rnd)

    def window(self, run):
        svc, fleet, k = self.svc, self.fleet, self.per_round
        self.folded = self.rejected = 0
        submitted = refused = 0
        inflight = collections.deque()
        r = 0
        t0 = time.perf_counter()
        if run.trace:
            obs.configure(enabled=True, trace_path=None, reset=True)
            # the tracer's clock against the host's perf_counter
            offset_us = obs.get_tracer().now_us() - time.perf_counter() * 1e6
        while r < MIN_ROUNDS or \
                time.perf_counter() - t0 + run.units[-1] < run.seconds:
            opened = time.perf_counter()
            with run.span("bench.open"):
                rnd = svc.open_round()
            cids = [(k * r + j) % fleet.n_clients for j in range(k)]
            for cid in cids:
                with run.span("bench.mint"):
                    blob = fleet.blob(cid, rnd)
                with run.span("bench.submit"):
                    ack = svc.submit(blob)
                submitted += 1
                refused += not ack.accepted
                del blob
            inflight.append((rnd, opened, cids))
            r += 1
            while len(inflight) > 1:
                self._finish(*inflight.popleft())
        while inflight:
            self._finish(*inflight.popleft())
        if run.trace:
            spans = [e for e in obs.get_tracer().events if e.get("ph") == "X"]
            run.counters["obs_spans"] = [(e["name"], e["dur"] / 1e6)
                                         for e in spans]
            run.host_spans += [(e["name"], (e["ts"] - offset_us) / 1e6,
                                (e["ts"] + e["dur"] - offset_us) / 1e6)
                               for e in spans]
            obs.configure(enabled=False)
        run.counters.update(attempted=submitted,
                            failed=refused + self.rejected,
                            folded=self.folded, rounds=r)

    def metrics(self, run) -> dict:
        return {"agg_rate": self.folded / run.window_s}

    def release(self):
        self.svc.stop()
        self.svc = self.agg = self.sk = self.base = self.ctx = None
        self.fleet = None

    def check(self) -> dict:
        kept, cfg = self.kept, self.cfg
        ref = judge.Reference(cfg, self.ck, self.p, self.run)
        g = self.run.geometry
        blob = kept.pop("downlink")
        nums = {"downlink_len_err": abs(len(blob) - frames.downlink_bytes(
            g["rows"], g["n_limbs"], g["n_poly"], g["n_plain"]))}
        try:
            down = frames.parse_downlink(blob)
            nums["downlink_layout_err"] = int(
                down["codec"] != "f32"
                or down["ct"].shape != (g["rows"], g["n_limbs"], 2,
                                        g["n_poly"])
                or down["plain"].shape != (g["n_plain"],))
        except (frames.LayoutError, KeyError, ValueError):
            nums["downlink_layout_err"] = 1
        nums["folded_err"] = abs(kept["folded"] - self.per_round)
        if nums["downlink_layout_err"]:
            nums["enc_err"] = nums["plain_err"] = float("inf")
            return nums
        # the round's clients are templates: weight each template by the
        # summed sample counts of the clients minted from it
        fleet_n = inputs.n_samples(self.run.seed, "fleet",
                                   int(self.traffic["fleet"]),
                                   *self.traffic["n_samples"])
        w = inputs.fedavg_weights([fleet_n[c] for c in kept["cids"]])
        n_t = int(self.traffic["templates"])
        wt = [sum(wi for wi, c in zip(w, kept["cids"]) if c % n_t == t)
              for t in range(n_t)]
        base = ref.base()
        vecs = [ref.client(base, "template", t, self.offset_std)
                for t in range(n_t)]
        del base
        mask = ref.mask
        want_enc = fedavg.weighted_mean((v[mask] for v in vecs), wt)
        want_plain = fedavg.weighted_mean(
            (judge.quantized(v[~mask], self.traffic["plain_codec"])
             for v in vecs), wt)
        del vecs
        plain = torch.from_numpy(down["plain"].copy()).to(ref.ring.device)
        nums["plain_err"] = fedavg.max_abs_err(plain, want_plain)
        del plain, want_plain
        ct = down["ct"]
        nums["enc_err"] = ref.enc_err(ct[:, :, 0], ct[:, :, 1],
                                      down["scale"], want_enc)
        return nums

