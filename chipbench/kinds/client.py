"""A client's own turn over the wire, round after round.

Set-up folds `setup_clients` seeded uploads into one aggregate on the
server's streaming path (`StreamIngest.ingest_update`), serializes its
downlink and recovers it once, which warms the protect and recover
kernels; the host's framing and parsing build nothing and get no warm-up.
Each turn then does what a client does in a round: protect a fresh update
with a new `a_seed` (`client_protect_seeded`), compress and frame it for
the uplink (`seed_compress`, `pack_update_frames` with the traffic's plain
codec), parse the downlink (`wire.format.deserialize`) and recover the
global model (`client_recover_params`).  Turns start while the window's
clock is under `--seconds`, and the window ends with the last turn.  One
of the first `checked_rounds` turns, drawn from the seed, is kept and
checked after the window.
"""
from __future__ import annotations

import torch

import inputs
from kinds import common
from reference import fedavg, frames, judge

from repro_torch.wire import compress, stream
from repro_torch.wire import format as wf

METRICS = ("client_s",)
NUMBERS = ("leaves_wrong", "rec_enc_err", "rec_plain_err", "uplink_len_err",
           "uplink_layout_err", "uplink_plain_err", "uplink_enc_err")
# lower-precision controls: the CKKS scale 2**20 below the stated 2**26;
# the i8 plain codec below the stated f16; the reference's FedAvg in
# bfloat16 in the place of the recovered model (float32 plain part)
CONTROLS = {"delta20": {"delta_bits": 20}, "i8": {"plain_codec": "i8"},
            "bf16": {"substitute": "bfloat16"}}
CLIENT_ID = 7


class Cell:
    def __init__(self, cfg, traffic, run, delta_bits=None, plain_codec=None,
                 substitute=None):
        self.cfg, self.traffic, self.run = cfg, traffic, run
        self.ck = common.ckks_params(cfg, delta_bits)
        self.p = float(traffic["p_ratio"])
        self.offset_std = float(traffic["offset_std"])
        self.codec = plain_codec or traffic["plain_codec"]
        self.n_setup = int(traffic["setup_clients"])
        self.pick = inputs.sub_seed(run.seed, "pick") % int(
            traffic["checked_rounds"])
        self.kept = None
        # the lower-precision control for the downlink's float32 plain
        # part: the reference's FedAvg in this dtype in the place of the
        # recovered model
        self.substitute = (getattr(torch, substitute) if substitute
                           else None)

    def _protect(self, rnd, i):
        run = self.run
        vec = inputs.client_vector(self.base, run.seed, rnd, i,
                                   self.offset_std)
        seed = inputs.a_seed(run.seed, rnd, i)
        upd = self.agg.client_protect_seeded(
            inputs.tree(self.cfg, vec), self.sk,
            inputs.generator(run.device, run.seed, "noise", rnd, i), seed)
        return upd, seed

    def setup(self):
        run = self.run
        self.ctx, self.sk, _, self.base, self.agg = common.build(
            self.cfg, self.ck, self.p, run)
        run.geometry.update(kind="client", clients=1)
        self.weights = inputs.fedavg_weights(inputs.n_samples(
            run.seed, "setup", self.n_setup, *self.traffic["n_samples"]))
        ingest = stream.StreamIngest(self.ctx)
        for i, w in enumerate(self.weights):
            upd, _ = self._protect("setup", i)
            ingest.ingest_update(upd, w)
            del upd
        glob = ingest.finalize()
        del ingest
        self.downlink = wf.serialize_update(glob)
        # with this, every device shape of a turn has run once
        self.agg.client_recover_params(glob, self.sk)
        del glob
        run.sync()

    def turn(self, t):
        run = self.run
        with run.span("bench.protect", sync=True):
            upd, seed = self._protect(t, CLIENT_ID)
        with run.span("bench.pack"):
            blob = stream.pack_update_frames(
                upd, cid=CLIENT_ID, n_samples=1, rnd=t,
                seeded=compress.seed_compress(upd.ct, seed),
                plain_codec=self.codec)
        del upd
        with run.span("bench.parse", sync=True):
            glob, _ = wf.deserialize(self.downlink, self.ctx)
        with run.span("bench.recover", sync=True):
            rec = self.agg.client_recover_params(glob, self.sk)
        del glob
        if t == self.pick or self.kept is None:
            self.kept = {"turn": t, "a_seed": seed, "uplink": blob,
                         "recovered": rec}
        del blob, rec

    def window(self, run):
        common.loop(run, self.turn)

    def metrics(self, run) -> dict:
        return {"client_s": run.window_s / len(run.units)}

    def release(self):
        self.agg = self.sk = self.base = self.ctx = self.downlink = None

    def check(self) -> dict:
        kept, cfg, run = self.kept, self.cfg, self.run
        g = run.geometry
        ref = judge.Reference(cfg, self.ck, self.p, run)
        mask = ref.mask
        base = ref.base()
        want = fedavg.weighted_mean(
            (ref.client(base, "setup", i, self.offset_std)
             for i in range(self.n_setup)), self.weights)
        rec = kept.pop("recovered")
        if self.substitute is not None:
            rec = inputs.tree(cfg, want.to(self.substitute).float())
        nums = judge.recovered_numbers(cfg, rec, want, mask)
        del rec, want
        # the uplink: its layout, its plain segment and its ciphertext
        mine = ref.client(base, kept["turn"], CLIENT_ID, self.offset_std)
        del base
        blob = kept.pop("uplink")
        nums["uplink_len_err"] = abs(len(blob) - frames.uplink_bytes(
            g["rows"], g["n_limbs"], g["n_poly"], g["n_plain"],
            self.traffic["plain_codec"]))
        try:
            up = frames.parse_uplink(blob)
            nums["uplink_layout_err"] = layout_faults(
                up, kept, g, float(2 ** self.ck["delta_bits"]))
        except (frames.LayoutError, KeyError, ValueError):
            up, nums["uplink_layout_err"] = None, 1
        if up is None or "plain" not in up or not up["rows"]:
            nums["uplink_plain_err"] = nums["uplink_enc_err"] = float("inf")
            return nums
        plain = torch.from_numpy(up["plain"].astype("float32")).to(
            ref.ring.device).to(torch.float64) * up["qscale"]
        nums["uplink_plain_err"] = fedavg.max_abs_err(
            plain, judge.quantized(mine[~mask], self.traffic["plain_codec"]))
        del plain
        nums["uplink_enc_err"] = ref.seeded_enc_err(
            [row[6][0] for row in up["rows"]], kept["a_seed"],
            up["rows"][0][1], mine[mask])
        return nums


def layout_faults(up, kept, g, scale) -> int:
    """Fields of the uplink stream that differ from what the turn sent."""
    bad = 0
    cid, _, _, n_chunks, kind = up.get("begin", (None,) * 5)
    bad += cid != CLIENT_ID
    bad += n_chunks != g["rows"] or kind != frames.SEEDED_KIND
    bad += not up["end"] or up.get("codec") is None
    bad += len(up["rows"]) != g["rows"]
    for b, (idx, sc, seed, off, derive, ver, c0) in enumerate(up["rows"]):
        bad += (idx != b or off != b or seed != kept["a_seed"]
                or derive != frames.DERIVE_FOLD_CHUNK or ver != 2
                or sc != scale or c0.shape != (1, g["n_limbs"], g["n_poly"]))
    return int(bad)
