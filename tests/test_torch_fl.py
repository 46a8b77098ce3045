"""The port's FL loop (serve.quorum, fl.server, fl.client, fl.orchestrator)
against the JAX package's, on the CPU, at N = 256 (delta 2^20) with
tests/test_fl.py's one-layer model.

  * quorum weights bit for bit; FLServer's synchronous, wire and FedBuff
    aggregates of JAX's protected updates and blobs bit for bit (the
    plaintext part to 1e-6), and sharded over a CPU mesh bit-identical to
    unsharded;
  * FLClient.local_train (FedAvg, FedProx, sgd) from JAX's parameters on
    the same batches: loss to rtol 1e-5, parameters to rtol 1e-4 (PR 19's
    gradient tolerance) and atol 1e-3 x lr: AdamW divides each gradient
    element by its running RMS, so an element near zero, whose float32
    sums differ between the packages by 1e-4 of its size, can move its
    step by that share of lr (1e-6 at the FedAvg client's lr of 1e-3);
  * sensitivity_map_from_probes with JAX's probes, for the dense, ssm and
    hybrid families (rtol 1e-5, atol 1e-6 of the map's largest entry);
  * protect_and_pack in all four uplink modes, each blob folded by the
    port's server and by JAX's StreamIngest; no environment variable read;
  * FLTask: the same sampled, dropped and straggling clients as JAX's and
    the same measured wire bytes, the recovered model within FEDAVG_BOUND
    of the plaintext FedAvg and within twice that of JAX's; total dropout,
    checkpoint resume, elasticity, and threshold mode at t = n and, through
    Shamir, at t < n, where the reference cannot decrypt;
  * agree_sensitivity folding in blocks smaller than the map.

FEDAVG_BOUND is the quickstart's 1e-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.core import packing as jpacking
from repro.core import sensitivity as jsens
from repro.core import secure_agg as jsecure_agg
from repro.core.ckks import cipher as jcipher
from repro.core.ckks import params as jparams
from repro.core.ckks import threshold as jthreshold
from repro.core.ckks import transcipher as jtranscipher
from repro.data import make_client_streams as jstreams
from repro.fl import client as jclient
from repro.fl import orchestrator as jorch
from repro.fl import server as jserver
from repro.serve import quorum as jquorum
from repro.wire import compress as jcompress
from repro.wire import stream as jstream

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch import models as tmodels
from repro_torch.core import packing as tpacking
from repro_torch.core import secure_agg as tsecure_agg
from repro_torch.core.ckks import cipher as tcipher
from repro_torch.core.ckks import params as tparams
from repro_torch.core.ckks import sharded as tsharded
from repro_torch.core.ckks import transcipher as ttranscipher
from repro_torch.data import make_client_streams as tstreams
from repro_torch.fl import (ClientConfig, FLClient, FLRunConfig, FLServer,
                            FLTask, WirePolicy)
from repro_torch.fl import client as tclient
from repro_torch.fl.server import ReceivedUpdate
from repro_torch.launch import mesh as tmesh
from repro_torch.serve import quorum as tquorum
from repro_torch.wire import budget as tbudget
from repro_torch.wire import stream as tstream

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

FEDAVG_BOUND = 1e-2
RTOL_LOSS, RTOL_PARAMS, ATOL_PARAMS_PER_LR = 1e-5, 1e-4, 1e-3
RTOL_MAP, ATOL_OF_MAX = 1e-5, 1e-6
CTX_ARGS = dict(n_poly=256, n_limbs=2, delta_bits=20)
CPU = torch.device("cpu")
# XLA's CPU backend compiles these graphs faster without its expensive
# passes, which do not reassociate float math (tests/test_torch_models.py)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jit_call(fn, *args):
    """fn(*args) through one XLA compile: the JAX package's functions run
    op by op where they are not jitted, which compiles every primitive
    apart and takes tens of seconds on the CPU."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


@functools.lru_cache(maxsize=None)
def _jctx():
    return jparams.make_test_context(**CTX_ARGS)


@functools.lru_cache(maxsize=None)
def _tctx():
    ctx = tparams.make_test_context(**CTX_ARGS, device="cpu")
    interop.check_context(ctx, _jctx().primes, 256, 20)
    return ctx


def _tiny(pkg):
    """tests/test_fl.py's tiny_task model config, from either package."""
    return dataclasses.replace(pkg.get_config("qwen1.5-0.5b", smoke=True),
                               n_layers=1, d_model=32, n_heads=2,
                               n_kv_heads=2, d_ff=64, vocab=61)


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    """(JAX model, numpy params of init(PRNGKey(0))) for "tiny" or a smoke
    config."""
    cfg = _tiny(jconfigs) if arch == "tiny" else jconfigs.get_config(
        arch, smoke=True)
    jm = jmodels.build_model(cfg)
    return jm, jax.tree_util.tree_map(np.asarray,
                                      jax.jit(jm.init)(jax.random.PRNGKey(0)))


def _torch_model(arch):
    cfg = _tiny(tconfigs) if arch == "tiny" else tconfigs.get_config(
        arch, smoke=True)
    return tmodels.build_model(cfg, device="cpu")


# ---------------------------------------------------------------------------
# serve.quorum
# ---------------------------------------------------------------------------


def test_quorum_weights_and_seal_reasons_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        k = rng.randint(1, 9)
        n = rng.randint(1, 1000, k).tolist()
        sent = rng.randint(0, 6, k).tolist()
        assert tquorum.normalized_weights(n) == jquorum.normalized_weights(n)
        for hl in (0.5, 4.0):
            assert tquorum.staleness_weights(n, sent, 6, hl) == \
                jquorum.staleness_weights(n, sent, 6, hl)
    for kw in (dict(min_clients=2), dict(min_clients=2, target_clients=3),
               dict(min_clients=1, deadline_s=1.0),
               dict(min_clients=3, target_clients=4, deadline_s=2.0)):
        tp, jp = tquorum.QuorumPolicy(**kw), jquorum.QuorumPolicy(**kw)
        for acc in range(6):
            for el in (0.0, 1.5, 2.5):
                assert tp.should_seal(acc, el) == jp.should_seal(acc, el)
                assert tp.late(el) == jp.late(el) and tp.met(acc) == \
                    jp.met(acc)
    # below the quorum floor a round never seals, only fails
    pol = tquorum.QuorumPolicy(min_clients=3, deadline_s=1.0)
    assert pol.should_seal(2, 5.0) == tquorum.FAIL_DEADLINE
    for bad in (dict(min_clients=0), dict(min_clients=3, target_clients=2),
                dict(deadline_s=0.0)):
        with pytest.raises(ValueError):
            tquorum.QuorumPolicy(**bad)
    with pytest.raises(ValueError):
        tquorum.normalized_weights([])


# ---------------------------------------------------------------------------
# fl.server on JAX's protected updates
# ---------------------------------------------------------------------------

N_SAMPLES = (3, 5, 8)


@pytest.fixture(scope="module")
def jax_updates():
    """A JAX aggregator over a two-leaf model, three clients' public-key
    updates, their seeded blobs, and JAX FLServer's results on them."""
    jctx = _jctx()
    sk, pk = jcipher.keygen(jctx, jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    model = {"w1": rng.randn(40, 30).astype(np.float32),
             "w2": rng.randn(30, 5).astype(np.float32)}
    agg = jsecure_agg.SelectiveHEAggregator.build(
        jctx, model, np.abs(rng.randn(1350)),
        jsecure_agg.AggregatorConfig(p_ratio=0.3, strategy="top_p"))
    clients = [{k: v + 0.1 * i for k, v in model.items()} for i in range(3)]
    ups = [agg.client_protect(m, pk, jax.random.PRNGKey(10 + i))
           for i, m in enumerate(clients)]
    blobs = []
    for i, m in enumerate(clients):
        u = agg.client_protect_seeded(m, sk, jax.random.PRNGKey(20 + i),
                                      a_seed=100 + i)
        blobs.append(jstream.pack_update_frames(
            u, cid=i, n_samples=N_SAMPLES[i], rnd=0,
            seeded=jcompress.seed_compress(u.ct, 100 + i),
            plain_codec="f16"))
    received = [jserver.ReceivedUpdate(cid=i, update=u, n_samples=n,
                                       round_sent=i)
                for i, (u, n) in enumerate(zip(ups, N_SAMPLES))]
    srv = jserver.FLServer(agg)
    sync = srv.aggregate_sync(received)
    wire = jserver.FLServer(agg).aggregate_wire(blobs)
    fedbuff = jserver.FLServer(agg, buffer_size=2)
    assert fedbuff.submit_async(received[0], current_round=3) is None
    buffered = fedbuff.submit_async(received[2], current_round=3)
    return dict(sk=sk, agg=agg, ups=ups, blobs=blobs, sync=sync, wire=wire,
                buffered=buffered)


def _jax_mask(part):
    """A JAX MaskPartition's boolean mask, as a tensor."""
    mask = torch.zeros(part.n_total, dtype=torch.bool)
    mask[torch.from_numpy(part.enc_idx.astype(np.int64))] = True
    return mask


def _port_server_inputs(j):
    ctx = _tctx()
    part = tpacking.make_partition(_jax_mask(j["agg"].part), 128)
    spec = tpacking.make_flat_spec({"w1": torch.zeros(40, 30),
                                    "w2": torch.zeros(30, 5)})
    agg = tsecure_agg.SelectiveHEAggregator(
        ctx, spec, part, tsecure_agg.AggregatorConfig(p_ratio=0.3))
    received = [ReceivedUpdate(
        cid=i, n_samples=n, round_sent=i,
        update=interop.protected_update_from_np(
            np.asarray(u.ct.data), u.ct.scale, np.asarray(u.plain), "cpu"))
        for i, (u, n) in enumerate(zip(j["ups"], N_SAMPLES))]
    return agg, received


def _assert_same_update(got, want):
    assert got.ct.scale == want.ct.scale
    data = got.ct.data
    if isinstance(data, tsharded.BlockGrid):
        data = data.assemble(CPU)
    np.testing.assert_array_equal(interop.residues_to_np(data),
                                  np.asarray(want.ct.data))
    np.testing.assert_allclose(got.plain.numpy(), np.asarray(want.plain),
                               rtol=0, atol=1e-6)


def test_server_aggregates_match_jax(jax_updates):
    j = jax_updates
    agg, received = _port_server_inputs(j)
    srv = FLServer(agg)
    _assert_same_update(srv.aggregate_sync(received), j["sync"])
    ledger = tbudget.BandwidthLedger()
    wsrv = FLServer(agg, ledger=ledger)
    _assert_same_update(wsrv.aggregate_wire(j["blobs"]), j["wire"])
    assert ledger.per_client_uplink(0) == {
        i: len(b) for i, b in enumerate(j["blobs"])}
    assert wsrv.last_ingest.accum_launches == 3
    fedbuff = FLServer(agg, buffer_size=2)
    assert fedbuff.submit_async(received[0], current_round=3) is None
    _assert_same_update(fedbuff.submit_async(received[2], current_round=3),
                        j["buffered"])
    assert fedbuff.rounds_aggregated == 1 and not fedbuff._buffer
    with pytest.raises(ValueError):
        srv.aggregate_sync([])
    with pytest.raises(ValueError):
        srv.aggregate_wire([])
    # the recovered sync aggregate equals JAX's recovered one
    tsk = interop.keys_from_np({k: np.asarray(v)
                                for k, v in j["sk"].items()}, "cpu")
    rec = agg.client_recover(srv.aggregate_sync(received), tsk)
    jrec = j["agg"].client_recover(j["sync"], j["sk"])
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), rtol=0,
                               atol=1e-5)


def test_server_sharded_equals_unsharded(jax_updates):
    j = jax_updates
    agg, received = _port_server_inputs(j)
    eng = tsharded.ShardedHe(_tctx(), tmesh.make_he_mesh(2, devices=[CPU] * 4))
    srv = FLServer(agg, sharded=eng)
    sync = srv.aggregate_sync(received)
    assert isinstance(sync.ct.data, tsharded.BlockGrid)
    assert sync.ct.data.equals(FLServer(agg).aggregate_sync(received).ct.data)
    wire = srv.aggregate_wire(j["blobs"])
    _assert_same_update(wire, j["wire"])
    buf = FLServer(agg, buffer_size=2, sharded=eng)
    buf.submit_async(received[0], current_round=3)
    _assert_same_update(buf.submit_async(received[2], current_round=3),
                        j["buffered"])


# ---------------------------------------------------------------------------
# fl.client
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fedavg", "fedprox", "sgd"])
def test_local_train_matches_jax(mode):
    ccfg = {"fedavg": dict(local_steps=2),
            "fedprox": dict(local_steps=2, lr=5e-2, prox_mu=1.0),
            "sgd": dict(local_steps=2, lr=5e-2, optimizer="sgd")}[mode]
    jm, jp = _jax_init("tiny")
    jc = jclient.FLClient(0, jm, jstreams(1, 61, seq_len=8, batch_size=2,
                                          seed=3)[0],
                          jclient.ClientConfig(**ccfg))
    jlocal, jloss = jc.local_train(jax.tree_util.tree_map(jnp.asarray, jp))
    tc = FLClient(0, _torch_model("tiny"),
                  tstreams(1, 61, seq_len=8, batch_size=2, seed=3)[0],
                  ClientConfig(**ccfg))
    tlocal, tloss = tc.local_train(interop.params_from_np(jp, "cpu"))
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL_LOSS)
    assert tc.n_samples == jc.n_samples == 4
    for g, w in zip(tpacking.tree_leaves(tlocal),
                    jax.tree_util.tree_leaves(jlocal)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL_PARAMS,
                                   atol=ATOL_PARAMS_PER_LR * tc.cfg.lr)
    moved = sum(float((a - torch.from_numpy(b)).abs().sum()) for a, b in zip(
        tpacking.tree_leaves(tlocal), jax.tree_util.tree_leaves(jp)))
    assert moved > 0


def _jax_probes(key, y, n):
    return [torch.from_numpy(np.array(jax.random.normal(k, y.shape,
                                                        dtype=y.dtype)))
            for k in jax.random.split(key, n)]


@pytest.mark.parametrize("arch", ["tiny", "mamba2-370m", "zamba2-7b"])
def test_sensitivity_map_from_jax_probes_matches_jax(arch, monkeypatch):
    real = jsens.sensitivity_jvp
    monkeypatch.setattr(jsens, "sensitivity_jvp", lambda fn, p, x, y, k, n_probes: _jit_call(
        lambda p_, x_, y_, k_: real(fn, p_, x_, y_, k_, n_probes=n_probes),
        p, x, y, k))
    jm, jp = _jax_init(arch)
    vocab = jm.cfg.vocab
    jc = jclient.FLClient(1, jm, jstreams(2, vocab, seq_len=8, batch_size=2,
                                          seed=4)[1],
                          jclient.ClientConfig(sensitivity_probes=2))
    jmap = jc.sensitivity_map(jax.tree_util.tree_map(jnp.asarray, jp))
    stream = tstreams(2, vocab, seq_len=8, batch_size=2, seed=4)[1]
    tc = FLClient(1, _torch_model(arch), stream,
                  ClientConfig(sensitivity_probes=2))
    batch = {k: torch.from_numpy(v) for k, v in stream.next_batch().items()}
    y = jax.nn.one_hot(jnp.asarray(batch["labels"].numpy()), vocab,
                       dtype=jnp.float32)
    tmap = tc.sensitivity_map_from_probes(
        interop.params_from_np(jp, "cpu"), batch,
        _jax_probes(jax.random.PRNGKey(1), y, 2))
    assert tmap.shape == jmap.shape and bool((tmap >= 0).all())
    np.testing.assert_allclose(tmap.numpy(), jmap, rtol=RTOL_MAP,
                               atol=ATOL_OF_MAX * np.abs(jmap).max())
    # the sampler: one more batch, probes from a generator seeded with cid
    a = tc.sensitivity_map(interop.params_from_np(jp, "cpu"))
    assert a.shape == tmap.shape and bool(torch.isfinite(a).all())


class _OneBatch:
    """A stream that yields copies of one fixed batch."""

    def __init__(self, batch):
        self.batch = batch

    def next_batch(self):
        return {k: v.copy() for k, v in self.batch.items()}


def test_sensitivity_map_with_ignored_labels_matches_jax(monkeypatch):
    """A label < 0 (an ignored position of both losses) or >= vocab gets a
    zero one-hot row in both packages: the maps agree, where the port's
    soft labels once raised."""
    real = jsens.sensitivity_jvp
    monkeypatch.setattr(jsens, "sensitivity_jvp", lambda fn, p, x, y, k, n_probes: _jit_call(
        lambda p_, x_, y_, k_: real(fn, p_, x_, y_, k_, n_probes=n_probes),
        p, x, y, k))
    jm, jp = _jax_init("tiny")
    vocab = jm.cfg.vocab
    batch = jstreams(1, vocab, seq_len=8, batch_size=2, seed=5)[0] \
        .next_batch()
    batch["labels"][:, 2] = -1
    batch["labels"][:, 5] = vocab
    jc = jclient.FLClient(0, jm, _OneBatch(batch),
                          jclient.ClientConfig(sensitivity_probes=2))
    jmap = jc.sensitivity_map(jax.tree_util.tree_map(jnp.asarray, jp))
    assert np.isfinite(jmap).all()
    tc = FLClient(0, _torch_model("tiny"), _OneBatch(batch),
                  ClientConfig(sensitivity_probes=2))
    y = jax.nn.one_hot(jnp.asarray(batch["labels"]), vocab,
                       dtype=jnp.float32)
    assert not np.asarray(y)[:, 2].any() and not np.asarray(y)[:, 5].any()
    params = interop.params_from_np(jp, "cpu")
    tmap = tc.sensitivity_map_from_probes(
        params, {k: torch.from_numpy(v) for k, v in batch.items()},
        _jax_probes(jax.random.PRNGKey(0), y, 2))
    np.testing.assert_allclose(tmap.numpy(), jmap, rtol=RTOL_MAP,
                               atol=ATOL_OF_MAX * np.abs(jmap).max())
    a = tc.sensitivity_map(params)
    assert a.shape == tmap.shape and bool(torch.isfinite(a).all())


@pytest.fixture(scope="module")
def port_round():
    """A port aggregator over the tiny model (its own keys), the local
    model, and the transcipher materials of client 2 in round 1."""
    ctx = _tctx()
    sk, pk = tcipher.keygen(ctx, torch.Generator().manual_seed(0))
    _, jp = _jax_init("tiny")
    params = interop.params_from_np(jp, "cpu")
    agg = tsecure_agg.SelectiveHEAggregator.build(
        ctx, params, torch.rand(tpacking.make_flat_spec(params).total,
                                generator=torch.Generator().manual_seed(1)),
        tsecure_agg.AggregatorConfig(p_ratio=0.2))
    cm, sm = ttranscipher.provision(
        ctx, sk, torch.Generator().manual_seed(2),
        tclient.uplink_a_seed(1, 2), agg.part.n_chunks)
    return dict(ctx=ctx, sk=sk, pk=pk, agg=agg, params=params, cm=cm, sm=sm)


@pytest.mark.parametrize("mode", ["auto", "full", "seeded", "transcipher"])
def test_protect_and_pack_blobs_fold_in_both_packages(port_round, mode):
    r = port_round
    ctx, agg = r["ctx"], r["agg"]
    client = FLClient(2, _torch_model("tiny"), None)
    client.n_samples = 7
    blob = client.protect_and_pack(agg, r["params"], rnd=1,
                                   policy=WirePolicy(plain_codec="f32"),
                                   pk=r["pk"], sk=r["sk"], mode=mode,
                                   transcipher_materials=r["cm"])
    meta = tstream.peek_update_meta(blob)
    assert (meta.cid, meta.round, meta.n_samples) == (2, 1, 7)
    assert meta.seeded == (mode in ("auto", "seeded"))
    assert meta.transcipher == (mode == "transcipher")
    want = tpacking.flatten_params(r["params"])[0]
    # the port's server
    if mode == "transcipher":
        ing = tstream.StreamIngest(
            ctx, transcipher_materials={(2, 1): r["sm"]})
        ing.ingest(blob, 1.0)
        out = ing.finalize()
    else:
        out = FLServer(agg).aggregate_wire([blob])
    assert float((agg.client_recover(out, r["sk"]) - want).abs().max()) \
        < FEDAVG_BOUND
    # JAX's StreamIngest takes the port's blob
    jmats = None
    if mode == "transcipher":
        sm = r["sm"]
        jmats = {(2, 1): jtranscipher.ServerMaterials(
            d=interop.residues_to_np(sm.d), a_seed=sm.a_seed,
            chunk_offset=sm.chunk_offset, n_chunks=sm.n_chunks,
            derive=sm.derive, scale=sm.scale)}
    jing = jstream.StreamIngest(_jctx(), transcipher_materials=jmats)
    jing.ingest(blob, 1.0)
    jout = jing.finalize()
    tout = interop.protected_update_from_np(
        np.asarray(jout.ct.data), jout.ct.scale, np.asarray(jout.plain),
        "cpu")
    assert float((agg.client_recover(tout, r["sk"]) - want).abs().max()) \
        < FEDAVG_BOUND


def test_uplink_mode_is_an_argument_only(port_round, monkeypatch):
    """REPRO_UPLINK_MODE switches the JAX client; the port reads no
    environment variable: "auto" with sk stays seeded."""
    r = port_round
    monkeypatch.setenv("REPRO_UPLINK_MODE", "full")
    client = FLClient(0, _torch_model("tiny"), None)
    blob = client.protect_and_pack(r["agg"], r["params"], rnd=0,
                                   policy=WirePolicy(), pk=r["pk"],
                                   sk=r["sk"])
    assert tstream.peek_update_meta(blob).seeded
    with pytest.raises(ValueError, match="uplink mode"):
        client.protect_and_pack(r["agg"], r["params"], rnd=0,
                                policy=WirePolicy(), pk=r["pk"], mode="bogus")
    with pytest.raises(ValueError, match="transcipher_materials"):
        client.protect_and_pack(r["agg"], r["params"], rnd=0,
                                policy=WirePolicy(), mode="transcipher")
    assert tclient.uplink_a_seed(3, 4) == jclient.uplink_a_seed(3, 4)


# ---------------------------------------------------------------------------
# fl.orchestrator
# ---------------------------------------------------------------------------

RUN = dict(n_rounds=3, dropout_prob=0.3, straggler_prob=0.3, deadline_s=2.0,
           seed=0, wire_policy=None)


def _jax_task(n_clients, **run_kw):
    jm, _ = _jax_init("tiny")
    streams = jstreams(n_clients, 61, seq_len=8, batch_size=2, seed=0)
    clients = [jclient.FLClient(i, jm, streams[i],
                                jclient.ClientConfig(local_steps=1,
                                                     sensitivity_probes=1))
               for i in range(n_clients)]
    return jorch.FLTask(jm, clients,
                        jsecure_agg.AggregatorConfig(p_ratio=0.2,
                                                     strategy="random"),
                        jorch.FLRunConfig(**run_kw), ctx=_jctx())


def _port_task(n_clients, strategy="top_p", **run_kw):
    model = _torch_model("tiny")
    streams = tstreams(n_clients, 61, seq_len=8, batch_size=2, seed=0)
    clients = [FLClient(i, model, streams[i],
                        ClientConfig(local_steps=1, sensitivity_probes=1))
               for i in range(n_clients)]
    return FLTask(model, clients,
                  tsecure_agg.AggregatorConfig(p_ratio=0.2,
                                               strategy=strategy),
                  FLRunConfig(**run_kw), ctx=_tctx())


def _record_recovered(task, out):
    """Wrap the task's _recover: out gets each round's flat global."""
    real = task._recover

    def recover(agg):
        params = real(agg)
        out.append(_flat(params))
        return params
    task._recover = recover


def _flat(params):
    """A tree of either package -> its flat numpy vector."""
    if isinstance(tpacking.tree_leaves(params)[0], torch.Tensor):
        return tpacking.flatten_params(params)[0].numpy()
    return np.asarray(jpacking.flatten_params(params)[0])


@pytest.fixture(scope="module")
def jax_fltask():
    """One JAX FLTask over the wire (4 clients, dropout and stragglers on,
    the random mask, 3 rounds): its initial model, logs, uplink senders
    and recovered models."""
    from repro.wire import WirePolicy as JWirePolicy
    task = _jax_task(4, **{**RUN, "wire_policy": JWirePolicy(
        plain_codec="f16")})
    init = jax.tree_util.tree_map(np.asarray, task.global_params)
    recovered = []
    _record_recovered(task, recovered)
    logs = task.run()
    return dict(init=init, logs=logs, recovered=recovered,
                uplink=[task.ledger.per_client_uplink(r) for r in range(3)],
                mask=_jax_mask(task.aggregator.part))


def test_fltask_matches_jax_clients_bytes_and_fedavg(jax_fltask):
    j = jax_fltask
    task = _port_task(4, strategy="random",
                      **{**RUN, "wire_policy": WirePolicy(plain_codec="f16")})
    task.global_params = interop.params_from_np(j["init"], "cpu")
    task.agree_encryption_mask()
    assert torch.equal(task.aggregator.part.mask, j["mask"])
    sent = []      # (round, n_samples, flat local params) of each uplink
    real_pack = FLClient.protect_and_pack

    def pack(self, aggregator, local_params, **kw):
        sent.append((kw["rnd"], self.n_samples,
                     tpacking.flatten_params(local_params)[0].double()))
        return real_pack(self, aggregator, local_params, **kw)

    recovered = []
    _record_recovered(task, recovered)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FLClient, "protect_and_pack", pack)
        logs = task.run()
    assert [(l.n_participating, l.n_dropped) for l in logs] == \
        [(l.n_participating, l.n_dropped) for l in j["logs"]]
    assert sum(l.n_dropped for l in logs) > 0
    assert sum(l.n_participating for l in logs) > 0
    for rnd, (log, jlog) in enumerate(zip(logs, j["logs"])):
        assert task.ledger.per_client_uplink(rnd) == j["uplink"][rnd]
        assert (log.comm_up_bytes, log.comm_down_bytes, log.comm_bytes) == \
            (jlog.comm_up_bytes, jlog.comm_down_bytes, jlog.comm_bytes)
        assert log.comm_measured
        np.testing.assert_allclose(log.loss, jlog.loss, rtol=1e-3)
    # each aggregated round: the plaintext FedAvg of the uplinked models
    assert len(recovered) == len(j["recovered"]) == sum(
        1 for l in logs if l.n_participating)
    rounds = sorted({r for r, _, _ in sent})
    for got, want_jax, rnd in zip(recovered, j["recovered"], rounds):
        ups = [(n, v) for r, n, v in sent if r == rnd]
        w = np.asarray([n for n, _ in ups], np.float64)
        fedavg = sum(wi / w.sum() * v for wi, (_, v) in zip(w, ups))
        assert np.abs(got - fedavg.numpy()).max() < FEDAVG_BOUND
        assert np.abs(got - want_jax).max() < 2 * FEDAVG_BOUND


def _fedavg_capture(task):
    """Wrap each client's local_train (no dropout, no stragglers): the
    list gets (round order) flat local params and n_samples."""
    out = []
    for c in task.clients:
        real = c.local_train

        def train(glob, real=real, c=c):
            params, loss = real(glob)
            out.append((c.n_samples,
                        tpacking.flatten_params(params)[0].double()))
            return params, loss
        c.local_train = train
    return out


def _fedavg(ups):
    w = np.asarray([n for n, _ in ups], np.float64)
    return sum(wi / w.sum() * v for wi, (_, v) in zip(w, ups))


def test_fltask_total_dropout_keeps_the_global_model():
    task = _port_task(2, n_rounds=2, dropout_prob=1.0)
    task.agree_encryption_mask()
    before = [t.clone() for t in tpacking.tree_leaves(task.global_params)]
    log = task.run_round(0)
    assert log.n_participating == 0 and log.n_dropped == 2
    assert np.isnan(log.loss) and not task.logs
    for a, b in zip(before, tpacking.tree_leaves(task.global_params)):
        assert torch.equal(a, b)


def test_fltask_checkpoint_resume_is_bit_for_bit(tmp_path):
    d = str(tmp_path / "ck")
    t1 = _port_task(3, n_rounds=2, ckpt_dir=d)
    logs = t1.run()
    assert [l.round for l in logs] == [0, 1]
    assert all(np.isfinite(l.loss) and l.n_participating == 3 for l in logs)
    t2 = _port_task(3, n_rounds=2, ckpt_dir=d)
    assert t2.run() == []                      # resumes at round 2
    assert t2._start_round == 2
    for a, b in zip(tpacking.tree_leaves(t1.global_params),
                    tpacking.tree_leaves(t2.global_params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_fltask_elastic_add_and_remove_client():
    task = _port_task(2, n_rounds=3)
    task.agree_encryption_mask()
    assert task.run_round(0).n_participating == 2
    cfg = task.model.cfg
    from repro_torch.data import SyntheticLM, dirichlet_partition
    prior = dirichlet_partition(1, cfg.vocab, seed=9)[0]
    newc = FLClient(99, task.model,
                    SyntheticLM(vocab=cfg.vocab, seq_len=8, batch_size=2,
                                client_prior=prior, seed=9),
                    ClientConfig(local_steps=1))
    task.add_client(newc)
    assert newc.ledger is task.ledger
    assert task.run_round(1).n_participating == 3
    task.remove_client(99)
    assert task.run_round(2).n_participating == 2


@pytest.mark.parametrize("wire", [False, True])
def test_fltask_threshold_t_equals_n(wire):
    task = _port_task(3, n_rounds=1, threshold_mode=True,
                      wire_policy=WirePolicy() if wire else None)
    assert task.sk is None and task._shamir is None
    ups = _fedavg_capture(task)
    recovered = []
    _record_recovered(task, recovered)
    logs = task.run()
    assert logs[0].n_participating == 3 and logs[0].comm_measured == wire
    assert np.abs(recovered[0] - _fedavg(ups).numpy()).max() < FEDAVG_BOUND


def test_fltask_threshold_t_below_n_decrypts_through_shamir():
    """2-of-3: the port combines two parties' Shamir partials and recovers
    the FedAvg; the reference's FLTask combines two of three additive
    partials there and cannot decrypt."""
    task = _port_task(3, n_rounds=1, threshold_mode=True, threshold_t=2)
    assert len(task._shamir) == 3
    ups = _fedavg_capture(task)
    recovered = []
    _record_recovered(task, recovered)
    task.run()
    assert np.abs(recovered[0] - _fedavg(ups).numpy()).max() < FEDAVG_BOUND
    # the reference at the same t: its _recover on an aggregate of known
    # parameters decrypts to garbage (keygen, partial decryptions and
    # combine jitted: the same functions)
    real_keygen = jthreshold.threshold_keygen

    def keygen(ctx, key, n_parties):
        def body(k):
            parties, pk = real_keygen(ctx, k, n_parties)
            return [p.s_mont for p in parties], pk
        shares, pk = _jit_call(body, key)
        return [jthreshold.ThresholdParty(i, s)
                for i, s in enumerate(shares)], pk

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jthreshold, "threshold_keygen", keygen)
        jtask = _jax_task(3, n_rounds=1, threshold_mode=True, threshold_t=2)
    auth = jtask.authority
    real_pd, real_combine = auth.partial_decrypt, auth.combine
    auth.partial_decrypt = lambda i, ct, key: _jit_call(
        lambda k: real_pd(i, ct, k), key)
    auth.combine = lambda ct, parts: _jit_call(
        lambda ps: real_combine(ct, ps), parts)
    jtask.agree_encryption_mask()
    params = jtask.global_params
    upd = jtask.aggregator.client_protect(params, jtask.pk,
                                          jax.random.PRNGKey(5))
    glob = jtask.aggregator.server_aggregate([upd], [1.0])
    got = jpacking.flatten_params(jtask._recover(glob))[0]
    want = jpacking.flatten_params(params)[0]
    assert float(jnp.abs(got - want).max()) > 1.0
    with pytest.raises(ValueError, match="threshold_t"):
        _port_task(3, threshold_mode=True, threshold_t=4)


# ---------------------------------------------------------------------------
# secure_agg.agree_sensitivity in blocks
# ---------------------------------------------------------------------------


def test_agree_sensitivity_folds_in_blocks(monkeypatch):
    """10 ciphertexts of 128 slots in blocks of 3 (the last of 1): the
    global map is the plaintext weighted mean within FEDAVG_BOUND, and
    weighted_sum ran once a block on at most 3 rows."""
    ctx = _tctx()
    sk, pk = tcipher.keygen(ctx, torch.Generator().manual_seed(3))
    n = 10 * ctx.slots - 37
    rng = np.random.RandomState(4)
    maps = [np.abs(rng.randn(n)).astype(np.float32) for _ in range(3)]
    weights = [0.2, 0.3, 0.5]
    rows = []
    real = tcipher.weighted_sum

    def spy(ctx_, cts, w):
        rows.append(tuple(cts.data.shape[:2]))
        return real(ctx_, cts, w)

    monkeypatch.setattr(tsecure_agg, "SENSITIVITY_BLOCK_ROWS", 3)
    monkeypatch.setattr(tcipher, "weighted_sum", spy)
    glob = tsecure_agg.agree_sensitivity(
        ctx, pk, sk, [torch.from_numpy(m) for m in maps], weights,
        torch.Generator().manual_seed(5))
    assert rows == [(3, 3), (3, 3), (3, 3), (3, 1)]
    assert glob.dtype == torch.float32 and glob.shape == (n,)
    want = sum(w * m.astype(np.float64) for w, m in zip(weights, maps))
    assert np.abs(glob.numpy() - want).max() < FEDAVG_BOUND
