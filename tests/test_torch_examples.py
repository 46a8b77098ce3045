"""The flows of examples/{quickstart,threshold_fl,encrypted_finetune}.py
through the port, at smoke size on the CPU (small contexts and models,
few rounds), with the examples' own checks: the FedAvg within the
quickstart's 1e-2 in memory and over the wire with measured bytes, the
threshold microbenchmark and FL rounds, and the fine-tune pipeline with
dropout and checkpoints."""
import dataclasses
import os

import numpy as np
import torch

from repro_torch import configs, models, wire
from repro_torch.core import packing
from repro_torch.core.ckks import cipher, encoding, threshold
from repro_torch.core.ckks import params as ckks_params
from repro_torch.core.secure_agg import AggregatorConfig, SelectiveHEAggregator
from repro_torch.data import make_client_streams
from repro_torch.fl import ClientConfig, FLClient, FLRunConfig, FLTask
from repro_torch.wire import budget as wb
from repro_torch.wire import stream as ws

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

MAX_ERR = 1e-2


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _max_err(got, want):
    return max(float((a - b).abs().max()) for a, b in zip(
        packing.tree_leaves(got), packing.tree_leaves(want)))


def test_quickstart_flow():
    ctx = ckks_params.make_context(n_poly=1024, n_limbs=2, delta_bits=24,
                                   device="cpu")
    sk, pk = cipher.keygen(ctx, _gen(0))
    rng = np.random.RandomState(0)
    model = {"w1": torch.from_numpy(rng.randn(256, 64).astype(np.float32)),
             "w2": torch.from_numpy(rng.randn(64, 10).astype(np.float32))}
    sens = np.abs(rng.randn(256 * 64 + 64 * 10))
    agg = SelectiveHEAggregator.build(
        ctx, model, sens, AggregatorConfig(p_ratio=0.1, strategy="top_p"))
    rep = agg.overhead_report()
    assert (rep["n_enc"], rep["n_total"], rep["n_ciphertexts"]) == \
        (1702, 17024, 4)
    clients = [packing.tree_map(lambda x, i=i: x + 0.1 * i, model)
               for i in range(3)]
    expect = packing.tree_map(lambda *xs: sum(xs) / 3, *clients)
    updates = [agg.client_protect(m, pk, _gen(10 + i))
               for i, m in enumerate(clients)]
    recovered = agg.client_recover_params(
        agg.server_aggregate(updates, [1 / 3] * 3), sk)
    assert _max_err(recovered, expect) < MAX_ERR
    # step 5: the same round over the wire, measured bytes
    ledger = wb.BandwidthLedger()
    blobs = []
    for i, m in enumerate(clients):
        upd = agg.client_protect_seeded(m, sk, _gen(20 + i), a_seed=100 + i)
        blob = ws.pack_update_frames(upd, cid=i, n_samples=4, rnd=0,
                                     seeded=wire.seed_compress(upd.ct,
                                                               100 + i),
                                     plain_codec="f16")
        ledger.record_blob(blob, rnd=0, cid=i, direction=wb.UPLINK)
        blobs.append(blob)
    ingest = ws.StreamIngest(ctx)
    for blob in blobs:
        ingest.ingest(blob, 1 / 3)
    glob_wire = ingest.finalize()
    blob_down = wire.serialize_update(glob_wire)
    for i in range(3):
        ledger.record_blob(blob_down, rnd=0, cid=i, direction=wb.DOWNLINK)
    rec_wire = agg.client_recover_params(glob_wire, sk)
    assert _max_err(rec_wire, expect) < MAX_ERR
    assert ingest.peak_chunk_buffers == agg.part.n_chunks
    assert ingest.accum_launches == ingest.clients_ingested == 3
    s = ledger.round_summary(0)
    comp = ledger.compression_summary(ctx, agg.part, 0)
    assert s["uplink_bytes"] == sum(len(b) for b in blobs)
    assert s["downlink_bytes"] == 3 * len(blob_down)
    assert s["by_kind"]["up/seeded_ciphertext"] > 0 and \
        s["by_kind"]["up/plain"] > 0
    assert comp["compression_ratio"] > 1


def test_threshold_fl_flow():
    ctx = ckks_params.make_context(n_poly=256, n_limbs=2, delta_bits=24,
                                   device="cpu")
    # the microbenchmark: single key against a two-party threshold decrypt
    vals = np.random.RandomState(0).randn(8, ctx.slots).astype(np.float32)
    coeffs = torch.from_numpy(encoding.encode_np(vals, ctx).view(np.int32))
    sk, pk = cipher.keygen(ctx, _gen(0))
    ct = cipher.encrypt_coeffs(ctx, pk, coeffs, _gen(1))
    err_single = np.abs(cipher.decrypt_values_np(ctx, sk, ct) - vals).max()
    parties, tpk = threshold.threshold_keygen(ctx, _gen(2), 2)
    ct = cipher.encrypt_coeffs(ctx, tpk, coeffs, _gen(3))
    partials = [threshold.partial_decrypt(ctx, p, ct, _gen(10 + i))
                for i, p in enumerate(parties)]
    out = encoding.decode_np(
        threshold.combine_partials(ctx, ct, partials).numpy().view(
            np.uint32), ctx, ct.scale)
    err_thresh = np.abs(out - vals).max()
    assert err_single < 1e-3 and err_single < err_thresh < 1.0
    # threshold-HE federated training
    cfg = dataclasses.replace(configs.get_config("qwen1.5-0.5b", smoke=True),
                              n_layers=2, d_model=64, d_ff=128, vocab=512)
    model = models.build_model(cfg, device="cpu")
    streams = make_client_streams(3, cfg.vocab, seq_len=16, batch_size=2)
    clients = [FLClient(i, model, streams[i], ClientConfig(local_steps=2))
               for i in range(3)]
    task = FLTask(model, clients,
                  AggregatorConfig(p_ratio=0.2, strategy="top_p"),
                  FLRunConfig(n_rounds=2, threshold_mode=True, seed=0),
                  ctx=ctx)
    logs = task.run()
    assert task.sk is None
    assert [l.n_participating for l in logs] == [3, 3]
    assert all(np.isfinite(l.loss) for l in logs)


def test_encrypted_finetune_flow(tmp_path):
    cfg = dataclasses.replace(configs.get_config("qwen1.5-0.5b", smoke=True),
                              n_layers=2, d_model=64, d_ff=128, vocab=512)
    model = models.build_model(cfg, device="cpu")
    streams = make_client_streams(4, cfg.vocab, seq_len=16, batch_size=2,
                                  alpha=0.5, seed=0)
    clients = [FLClient(i, model, streams[i],
                        ClientConfig(local_steps=2, lr=1e-3,
                                     sensitivity_probes=2))
               for i in range(4)]
    ctx = ckks_params.make_context(n_poly=256, n_limbs=2, delta_bits=24,
                                   device="cpu")
    ckpt = str(tmp_path / "finetune")
    task = FLTask(model, clients,
                  AggregatorConfig(p_ratio=0.1, strategy="top_p"),
                  FLRunConfig(n_rounds=4, dropout_prob=0.05, ckpt_dir=ckpt,
                              ckpt_every=2, seed=0),
                  ctx=ctx)
    task.agree_encryption_mask()
    rep = task.aggregator.overhead_report()
    assert rep["n_total"] == cfg.param_count()
    assert rep["n_enc"] == round(0.1 * cfg.param_count())
    assert rep["comm_ratio"] > 1          # ciphertexts cost more than floats
    logs = task.run()
    assert [l.round for l in logs] == [0, 1, 2, 3]
    assert all(np.isfinite(l.loss) for l in logs if l.n_participating)
    assert sorted(os.listdir(ckpt)) == ["step_00000001", "step_00000003"]
