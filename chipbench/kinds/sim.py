"""FedML-style simulation on one card: the paper's Algorithm 1 round in
memory, every round

    K x client_protect (public-key encrypt of the top-p masked part)
    server_aggregate   (FedAvg weights from the clients' sample counts)
    client_recover_params

Set-up builds the context, the keys (from seeded samples), the global model
and the top-p mask over a seeded sensitivity map, and runs one round to
warm every shape.  Rounds start while the window's clock is under
`--seconds`, and the window ends with the last round.  Round r's client i
sends the global model plus its own seeded offset.  One of the first
`checked_rounds` rounds, drawn from the seed, is kept and checked after
the window.
"""
from __future__ import annotations

import torch

import inputs
from harness import quantile
from kinds import common
from reference import fedavg, judge

METRICS = ("round_s", "round_p95_s")
NUMBERS = ("leaves_wrong", "rec_enc_err", "rec_plain_err", "enc_err")
# lower-precision controls: the CKKS scale 2**20 below the stated 2**26;
# the reference's FedAvg in bfloat16 in the place of the recovered model,
# whose plain part is float32
CONTROLS = {"delta20": {"delta_bits": 20},
            "bf16": {"substitute": "bfloat16"}}


class Cell:
    def __init__(self, cfg, traffic, run, delta_bits=None, substitute=None):
        self.cfg, self.traffic, self.run = cfg, traffic, run
        self.ck = common.ckks_params(cfg, delta_bits)
        self.k = int(traffic["clients"])
        self.p = float(traffic["p_ratio"])
        self.offset_std = float(traffic["offset_std"])
        self.pick = inputs.sub_seed(run.seed, "pick") % int(
            traffic["checked_rounds"])
        self.kept = None
        # the lower-precision control puts the reference's FedAvg, computed
        # in this dtype, in the place of the recovered model
        self.substitute = (getattr(torch, substitute) if substitute
                           else None)

    def setup(self):
        run = self.run
        self.ctx, self.sk, self.pk, self.base, self.agg = common.build(
            self.cfg, self.ck, self.p, run)
        run.geometry.update(kind="sim", clients=self.k)
        self.round("warm")
        run.sync()

    def round(self, rnd):
        run, cfg, k = self.run, self.cfg, self.k
        weights = inputs.fedavg_weights(inputs.n_samples(
            run.seed, rnd, k, *self.traffic["n_samples"]))
        updates = []
        for i in range(k):
            vec = inputs.client_vector(self.base, run.seed, rnd, i,
                                       self.offset_std)
            with run.span("bench.protect", sync=True):
                updates.append(self.agg.client_protect(
                    inputs.tree(cfg, vec), self.pk,
                    inputs.generator(run.device, run.seed, "noise", rnd, i)))
            del vec
        with run.span("bench.aggregate", sync=True):
            glob = self.agg.server_aggregate(updates, weights)
        del updates
        with run.span("bench.recover", sync=True):
            rec = self.agg.client_recover_params(glob, self.sk)
        if rnd != "warm" and (rnd == self.pick or self.kept is None):
            self.kept = {"round": rnd, "weights": weights,
                         "ct": glob.ct.data, "scale": glob.ct.scale,
                         "recovered": rec}
        del glob, rec

    def window(self, run):
        common.loop(run, self.round)

    def metrics(self, run) -> dict:
        return {"round_s": run.window_s / len(run.units),
                "round_p95_s": quantile(run.units, 0.95)}

    def release(self):
        """Free the program's state but for what the check reads."""
        self.agg = self.pk = self.sk = self.base = self.ctx = None

    def check(self) -> dict:
        kept = self.kept
        ref = judge.Reference(self.cfg, self.ck, self.p, self.run)
        base = ref.base()
        want = fedavg.weighted_mean(
            (ref.client(base, kept["round"], i, self.offset_std)
             for i in range(self.k)), kept["weights"])
        del base
        rec = kept.pop("recovered")
        if self.substitute is not None:
            rec = inputs.tree(self.cfg, want.to(self.substitute).float())
        nums = judge.recovered_numbers(self.cfg, rec, want, ref.mask)
        del rec
        ct = kept.pop("ct")
        nums["enc_err"] = ref.enc_err(ct[:, :, 0], ct[:, :, 1],
                                      kept["scale"], want[ref.mask])
        return nums
