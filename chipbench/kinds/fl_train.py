"""FedML-style federated training on one card: the paper's Algorithm 1
round after real local training, every round

    K x (FLClient.local_train: `local_steps` AdamW steps of the port's
         model from the global model on the client's own seeded batches;
         client_protect: public-key encrypt of the top-p masked part)
    server_aggregate       (FedAvg weights from seeded sample counts)
    client_recover_params  (the next round's global model)

Set-up builds the port's model of the configuration's `name` from its
registry (`configs.get_config`; a configuration with `"smoke": true` takes
the registry's smoke model of that family) and checks that its parameter
tree has the configuration's leaves, paths and shapes.  The first global
model is the configuration's seeded vector (`inputs.base_vector`), in the
model's parameter dtype; the context, keys and top-p mask come from
`common.build`.  A warm-up runs one local step, three protects, the
aggregate and the recover.  The window always runs `checked_rounds`
rounds; a later round starts only while the window's clock plus the last
round's time is under `--seconds`.  One of the first `checked_rounds`
rounds and one of its clients, drawn from the seed, are kept: the round's
incoming global model, every client's local model, the aggregate and the
recovered model.  The batches' tokens are uniform over the configuration's
`vocab_size`.

The check: the reference of the model's family (`reference/mamba2.py`
for mamba2-370m, float32) trains the kept client from the same incoming
global model on the same batches, with the configuration's vocabulary and
RMSNorm epsilon, and the recovered model is held against the float64
FedAvg of the program's local models.  A kept round after the first
starts from the program's own recovered model of the round before (the
reference follows the program there); the first round starts from the
seeded vector, made again.
"""
from __future__ import annotations

import dataclasses
import importlib
import statistics
import time

import torch

import batches
import faults
import inputs
from harness import quantile
from kinds import common
from reference import fedavg, judge

from repro_torch import configs, models
from repro_torch.core import packing
from repro_torch.fl import ClientConfig, FLClient
from repro_torch.optim import AdamWConfig

METRICS = ("round_s", "round_p95_s")
NUMBERS = ("leaves_wrong", "change_err", "sign_err", "rec_enc_err",
           "rec_plain_err", "enc_err")
# lower-precision controls: the CKKS scale 2**20 below the stated 2**26;
# the program's own bfloat16 master weights below the stated float32; the
# reference's FedAvg in bfloat16 in the place of the recovered model,
# whose plain part is float32
CONTROLS = {"delta20": {"delta_bits": 20},
            "param_bf16": {"param_dtype": "bfloat16"},
            "bf16": {"substitute": "bfloat16"}}
# faults planted in the program (`faults.py`), for the readings that set
# the limits (calibrate.py)
FAULTS = {"one_step": faults.one_step, "half_batch": faults.half_batch,
          "one_left_out": faults.one_left_out,
          "grad_flip": faults.grad_flip}


def port_config(cfg: dict, param_dtype=None):
    """The port's model configuration of `cfg`, its master weights in
    `param_dtype` where given."""
    port = configs.get_config(cfg["name"], smoke=bool(cfg.get("smoke")))
    if param_dtype is not None:
        port = dataclasses.replace(port, param_dtype=param_dtype)
    return port


def reference_of(port):
    """The plain reference of the port's model family:
    `reference/<family module>.py` (`mamba2` for the ssm family), whose
    `train` runs the local steps again."""
    name = models.family_module(port).__name__.rsplit(".", 1)[-1]
    return importlib.import_module(f"reference.{name}")


def tree_shapes(tree, prefix="") -> list:
    """[(path, shape)] of a nested dict's leaves, in pytree order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += tree_shapes(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, tuple(v.shape)))
    return out


def by_path(cfg: dict, tree) -> dict:
    """{path: leaf} of a nested dict, over the configuration's leaves."""
    out = {}
    for path, _, _, _ in inputs.leaves(cfg):
        node = tree
        for p in path.split("/"):
            node = node[p]
        out[path] = node
    return out


def adamw(traffic: dict) -> dict:
    """The traffic's optimizer: lr, moments, eps, decay and clip."""
    return {"lr": float(traffic["lr"]),
            **{k: float(v) for k, v in traffic["adamw"].items()}}


class Cell:
    def __init__(self, cfg, traffic, run, delta_bits=None, param_dtype=None,
                 substitute=None):
        self.cfg, self.traffic, self.run = cfg, traffic, run
        self.ck = common.ckks_params(cfg, delta_bits)
        self.port = port_config(cfg, param_dtype)
        self.k = int(traffic["clients"])
        self.steps = int(traffic["local_steps"])
        self.rows, self.seq = int(traffic["rows"]), int(traffic["seq"])
        self.p = float(traffic["p_ratio"])
        self.checked = int(traffic["checked_rounds"])
        self.pick = inputs.sub_seed(run.seed, "pick") % self.checked
        self.pick_client = inputs.sub_seed(run.seed, "pick_client") % self.k
        self.opt = adamw(traffic)
        self.substitute = (getattr(torch, substitute) if substitute
                           else None)
        self.kept = None

    # -- set-up ----------------------------------------------------------

    def setup(self):
        run, cfg, port = self.run, self.cfg, self.port
        opt = self.opt
        if AdamWConfig(**opt) != AdamWConfig(
                lr=opt["lr"], weight_decay=0.0):
            raise ValueError("the traffic's optimizer is not FLClient's")
        self.model = models.build_model(port, device=run.device)
        want = [(path, shape) for path, shape, _, _ in inputs.leaves(cfg)]
        got = tree_shapes(self.model.init_abstract())
        if got != want:
            raise ValueError(f"the port's {port.name} tree is not the "
                             f"configuration's leaves: {got} != {want}")
        if cfg["vocab_size"] > port.vocab:
            raise ValueError(f"the configuration's {cfg['vocab_size']} "
                             f"tokens exceed the port's {port.vocab}")
        self.ctx, self.sk, self.pk, base, self.agg = common.build(
            cfg, self.ck, self.p, run)
        self.glob = self._as_params(inputs.tree(cfg, base))
        self.clients = [
            FLClient(i, self.model, batches.Stream(
                run.seed, i, self.rows, self.seq, cfg["vocab_size"]),
                ClientConfig(local_steps=self.steps, lr=opt["lr"]))
            for i in range(self.k)]
        run.geometry.update(
            kind="fl", clients=self.k, local_steps=self.steps,
            rows=self.rows, seq=self.seq, family=port.family,
            ssm_chunk=port.ssm_chunk,
            leaves=[[p, list(s)] for p, s in want],
            param_dtype=port.param_dtype, dtype=port.dtype)
        self.warm()
        run.sync()

    def _as_params(self, tree):
        dt = getattr(torch, self.port.param_dtype)
        return packing.tree_map(lambda t: t.to(dt), tree)

    def warm(self):
        """One local step of a client (every local step has the same
        shapes), K protects, the aggregate and the recover: every shape of
        a round."""
        run = self.run
        c = FLClient(0, self.model, self.clients[0].stream,
                     ClientConfig(local_steps=1, lr=self.opt["lr"]))
        c.stream.begin("warm")
        local, _ = c.local_train(self.glob)
        ups = [self.agg.client_protect(local, self.pk, inputs.generator(
            run.device, run.seed, "noise", "warm", i)) for i in range(self.k)]
        del local
        w = [1.0 / self.k] * self.k
        rec = self.agg.client_recover_params(
            self.agg.server_aggregate(ups, w), self.sk)
        del ups, rec

    # -- the window ------------------------------------------------------

    def round(self, rnd):
        run, k = self.run, self.k
        weights = inputs.fedavg_weights(inputs.n_samples(
            run.seed, rnd, k, *self.traffic["n_samples"]))
        keep = rnd == self.pick
        glob, updates, local_models = self.glob, [], []
        for i, client in enumerate(self.clients):
            client.stream.begin(rnd)
            with run.span("bench.local_train", sync=True):
                local, _ = client.local_train(glob)
            with run.span("bench.protect", sync=True):
                updates.append(self.agg.client_protect(
                    local, self.pk, inputs.generator(
                        run.device, run.seed, "noise", rnd, i)))
            if keep:
                local_models.append(local)
            del local
        with run.span("bench.aggregate", sync=True):
            agg = self.agg.server_aggregate(updates, weights)
        del updates
        with run.span("bench.recover", sync=True):
            rec = self.agg.client_recover_params(agg, self.sk)
        if keep:
            self.kept = {"round": rnd, "weights": weights, "global": glob,
                         "locals": local_models, "ct": agg.ct.data,
                         "scale": agg.ct.scale, "recovered": rec}
        del agg
        self.glob = self._as_params(rec)

    def window(self, run):
        n, t0 = 0, time.perf_counter()
        while n < self.checked or \
                time.perf_counter() - t0 + run.units[-1] < run.seconds:
            t = time.perf_counter()
            self.round(n)
            run.sync()
            run.units.append(time.perf_counter() - t)
            n += 1
        run.counters.update(attempted=n, failed=0)

    def metrics(self, run) -> dict:
        return {"round_s": run.window_s / len(run.units),
                "round_p95_s": quantile(run.units, 0.95)}

    def release(self):
        """Free the program's state but for what the check reads."""
        self.clients = self.model = self.glob = None
        self.agg = self.pk = self.sk = self.ctx = None

    # -- the check -------------------------------------------------------

    def check(self) -> dict:
        kept, cfg, run = self.kept, self.cfg, self.run
        nums = self._training(kept)
        ref = judge.Reference(cfg, self.ck, self.p, run)
        want = fedavg.weighted_mean(
            (judge.flat(cfg, t) for t in kept.pop("locals")),
            kept["weights"])
        rec = kept.pop("recovered")
        if self.substitute is not None:
            rec = inputs.tree(cfg, want.to(self.substitute).float())
        nums.update(judge.recovered_numbers(cfg, rec, want, ref.mask))
        del rec
        ct = kept.pop("ct")
        nums["enc_err"] = ref.enc_err(ct[:, :, 0], ct[:, :, 1],
                                      kept["scale"], want[ref.mask])
        return {k: nums[k] for k in NUMBERS}

    def _training(self, kept) -> dict:
        """The kept client's local training against the reference's, leaf
        by leaf over the local steps' change (local - global): the norm of
        the change (`change_err`: the worst leaf's gap of norms over the
        reference's norm or the median leaf's, whichever is larger), and
        its direction (`sign_err`: the worst leaf's share of entries whose
        change has another sign than the reference's).  Adam's update is
        about lr * sign(g) an entry, so its norm is close to lr * sqrt(n)
        whatever the gradient's size, and a gradient wrong in direction
        shows in the signs; where a gradient entry is round-off small the
        two sides' signs part by round-off, a few per cent of a leaf.
        Leaves whose reference gradient is under a thousandth of the median
        leaf's move under Adam by round-off alone, and are left out."""
        run, cfg = self.run, self.cfg
        start = {p: t.float() for p, t in by_path(cfg, kept["global"])
                 .items()}
        bs = []
        for s in range(self.steps):
            b = batches.batch(run.seed, kept["round"], self.pick_client, s,
                              self.rows, self.seq, cfg["vocab_size"])
            bs.append((torch.from_numpy(b["tokens"]).to(run.device),
                       torch.from_numpy(b["labels"]).to(run.device)))
        ref = reference_of(self.port).train(cfg, start, bs, **self.opt)
        del bs
        g_ref = ref["grad_norms"]
        moved = [p for p, g in g_ref.items()
                 if g >= 1e-3 * statistics.median(g_ref.values())]
        local = by_path(cfg, kept["locals"][self.pick_client])
        change, signs = {}, []
        for p in moved:
            d, d_ref = local[p].float() - start[p], ref["params"][p] - start[p]
            change[p] = (float(d.double().norm()),
                         float(d_ref.double().norm()))
            signs.append(float((torch.sign(d) != torch.sign(d_ref))
                               .float().mean()))
            del d, d_ref
        med = statistics.median(r for _, r in change.values())
        return {"change_err": max(abs(a - b) / max(b, med)
                                  for a, b in change.values()),
                "sign_err": max(signs)}
