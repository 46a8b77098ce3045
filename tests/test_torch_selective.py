"""Packing, selection and the whole Algorithm 1 round: port vs JAX package.

The round is the quickstart's steps 1-4 (N=1024, delta=2^24, a 256x64 +
64x10 model, 3 clients, top 10% encrypted).  Carried across from a JAX run,
the clients' updates aggregate to a bit-identical ciphertext in the port and
recover to JAX's parameters within DECODE_ATOL; run wholly in the port, the
round recovers the plaintext FedAvg within the quickstart's 1e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import packing as jpacking
from repro.core import selection as jselection
from repro.core import secure_agg as jsecure_agg
from repro.core.ckks import cipher as jcipher
from repro.core.ckks import params as jparams

from repro_torch import interop
from repro_torch.core import packing as tpacking
from repro_torch.core import secure_agg as tsecure_agg
from repro_torch.core import selection as tselection
from repro_torch.core.ckks import cipher as tcipher
from repro_torch.core.ckks import params as tparams
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# recovered parameters: float32 FFT rounding of the decode (measured 4.8e-7)
DECODE_ATOL = 1e-5
FEDAVG_BOUND = 1e-2


def _nested(rng):
    """Nested dict with keys out of sorted order and a scalar-ish leaf."""
    return {"z": rng.randn(3, 2).astype(np.float32),
            "a": {"y": rng.randn(4).astype(np.float32),
                  "b": rng.randn(2, 2, 2).astype(np.float32)},
            "m": [rng.randn(5).astype(np.float32),
                  rng.randn(1).astype(np.float32)]}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def test_flatten_order_and_round_trip_match_jax():
    params = _nested(np.random.RandomState(0))
    jvec, jspec = jpacking.flatten_params(_tree_map(jnp.asarray, params))
    tvec, tspec = tpacking.flatten_params(_tree_map(torch.from_numpy, params))
    np.testing.assert_array_equal(tvec.numpy(), np.asarray(jvec))
    assert (tspec.shapes, tspec.sizes, tspec.offsets) == \
        (jspec.shapes, jspec.sizes, jspec.offsets)
    back = tpacking.unflatten_params(tvec, tspec)
    jback = jpacking.unflatten_params(jvec, jspec)
    for got, want in zip(tpacking.tree_leaves(back),
                         jax.tree_util.tree_leaves(jback)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert list(back) == ["a", "m", "z"] and isinstance(back["m"], list)


@pytest.mark.parametrize("p", [0.0, 0.05, 0.1, 0.37, 1.0])
def test_masks_equal_jax_including_ties(p):
    rng = np.random.RandomState(1)
    # heavy ties, signs and zeros: only the index tie-break separates them
    s = (rng.randint(-3, 4, 3000) * 0.5).astype(np.float32)
    offsets, sizes = (0, 1000, 1700), (1000, 700, 1300)
    ts = torch.from_numpy(s)
    for strategy in ("top_p", "per_layer", "recipe", "random", "all",
                     "none"):
        want = jselection.build_mask(s, strategy, p, offsets=offsets,
                                     sizes=sizes, seed=3)
        got = tselection.build_mask(ts, strategy, p, offsets=offsets,
                                    sizes=sizes, seed=3)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want, err_msg=strategy)
    with pytest.raises(ValueError):
        tselection.build_mask(ts, "per_layer", p)


def test_split_and_merge_match_jax():
    rng = np.random.RandomState(2)
    vec = rng.randn(1000).astype(np.float32)
    mask = jselection.top_p_mask(np.abs(rng.randn(1000)), 0.3)
    jpart = jpacking.make_partition(mask, 128)
    tpart = tpacking.make_partition(torch.from_numpy(mask), 128)
    assert (tpart.n_enc, tpart.n_plain, tpart.n_chunks, tpart.n_enc_padded) \
        == (jpart.n_enc, jpart.n_plain, jpart.n_chunks, jpart.n_enc_padded)
    np.testing.assert_array_equal(tpart.enc_idx.numpy(), jpart.enc_idx)
    np.testing.assert_array_equal(tpart.plain_idx.numpy(), jpart.plain_idx)
    jenc, jplain = jpacking.split_by_mask(jnp.asarray(vec), jpart)
    tenc, tplain = tpacking.split_by_mask(torch.from_numpy(vec), tpart)
    np.testing.assert_array_equal(tenc.numpy(), np.asarray(jenc))
    np.testing.assert_array_equal(tplain.numpy(), np.asarray(jplain))
    np.testing.assert_array_equal(
        tpacking.merge_by_mask(tenc, tplain, tpart).numpy(), vec)


# ---------------------------------------------------------------------------
# the whole slice: the quickstart's round
# ---------------------------------------------------------------------------


def _quickstart_model():
    rng = np.random.RandomState(0)
    model = {"w1": rng.randn(256, 64).astype(np.float32),
             "w2": rng.randn(64, 10).astype(np.float32)}
    sens = np.abs(rng.randn(256 * 64 + 64 * 10))
    return model, sens


def _fedavg(clients):
    return {k: sum(c[k] for c in clients) / 3 for k in clients[0]}


@pytest.fixture(scope="module")
def jax_round():
    ctx = jparams.make_context(n_poly=1024, n_limbs=2, delta_bits=24)
    sk, pk = jcipher.keygen(ctx, jax.random.PRNGKey(0))
    model, sens = _quickstart_model()
    agg = jsecure_agg.SelectiveHEAggregator.build(
        ctx, _tree_map(jnp.asarray, model), sens,
        jsecure_agg.AggregatorConfig(p_ratio=0.1, strategy="top_p"))
    clients = [_tree_map(lambda x: jnp.asarray(x) + 0.1 * i, model)
               for i in range(3)]
    updates = [agg.client_protect(m, pk, jax.random.PRNGKey(10 + i))
               for i, m in enumerate(clients)]
    glob = agg.server_aggregate(updates, [1 / 3] * 3)
    rec = agg.client_recover_params(glob, sk)
    return dict(ctx=ctx, sk=sk, agg=agg, updates=updates, glob=glob, rec=rec)


def test_jax_updates_aggregate_bit_identically_in_the_port(jax_round):
    j = jax_round
    tctx = tparams.make_context(n_poly=1024, n_limbs=2, delta_bits=24,
                                device="cpu")
    interop.check_context(tctx, j["ctx"].primes, 1024, 24)
    model, sens = _quickstart_model()
    agg = tsecure_agg.SelectiveHEAggregator.build(
        tctx, _tree_map(torch.from_numpy, model), sens,
        tsecure_agg.AggregatorConfig(p_ratio=0.1, strategy="top_p"))
    np.testing.assert_array_equal(agg.part.enc_idx.numpy(),
                                  j["agg"].part.enc_idx)
    assert agg.overhead_report() == j["agg"].overhead_report()
    updates = [tsecure_agg.ProtectedUpdate(
        ct=interop.ciphertext_from_np(np.asarray(u.ct.data), u.ct.scale,
                                      "cpu"),
        plain=torch.from_numpy(np.array(u.plain))) for u in j["updates"]]
    glob = agg.server_aggregate(updates, [1 / 3] * 3)
    assert glob.ct.scale == j["glob"].ct.scale
    np.testing.assert_array_equal(interop.residues_to_np(glob.ct.data),
                                  np.asarray(j["glob"].ct.data))
    np.testing.assert_allclose(glob.plain.numpy(),
                               np.asarray(j["glob"].plain), rtol=0,
                               atol=1e-6)
    sk = interop.keys_from_np({k: np.asarray(v) for k, v in j["sk"].items()},
                              "cpu")
    rec = agg.client_recover_params(glob, sk)
    assert sorted(rec) == sorted(j["rec"])
    for k in rec:
        np.testing.assert_allclose(rec[k].numpy(), np.asarray(j["rec"][k]),
                                   rtol=0, atol=DECODE_ATOL, err_msg=k)


def test_round_wholly_in_the_port_recovers_fedavg():
    ctx = tparams.make_context(n_poly=1024, n_limbs=2, delta_bits=24,
                               device="cpu")
    sk, pk = tcipher.keygen(ctx, torch.Generator().manual_seed(0))
    model, sens = _quickstart_model()
    model = _tree_map(torch.from_numpy, model)
    agg = tsecure_agg.SelectiveHEAggregator.build(
        ctx, model, sens, tsecure_agg.AggregatorConfig(p_ratio=0.1))
    assert agg.part.n_chunks == 4
    clients = [_tree_map(lambda x: x + 0.1 * i, model) for i in range(3)]
    updates = [agg.client_protect(m, pk, torch.Generator().manual_seed(10 + i))
               for i, m in enumerate(clients)]
    for u in updates:
        assert u.ct.data.shape == (4, 2, 2, 1024)
        assert u.ct.data.dtype == torch.int32
    glob = agg.server_aggregate(updates, [1 / 3] * 3)
    rec = agg.client_recover_params(glob, sk)
    expect = _fedavg(clients)
    err = max(float((rec[k] - expect[k]).abs().max()) for k in expect)
    assert err < FEDAVG_BOUND


def test_dp_noise_and_mask_agreement_in_the_port():
    ctx = tparams.make_context(n_poly=256, n_limbs=2, delta_bits=20,
                               device="cpu")
    sk, pk = tcipher.keygen(ctx, torch.Generator().manual_seed(4))
    rng = np.random.RandomState(5)
    # well separated sensitivities: decrypted aggregate keeps their order
    local = [np.arange(300, dtype=np.float32) / 300 + 0.001 * rng.rand(300)
             for _ in range(2)]
    mask = tsecure_agg.agree_mask(ctx, pk, sk, local, [0.5, 0.5], 0.2,
                                  torch.Generator().manual_seed(6))
    clear = tselection.top_p_mask(torch.from_numpy(
        (local[0] + local[1]) / 2), 0.2)
    assert torch.equal(mask, clear)
    agg = tsecure_agg.SelectiveHEAggregator.build(
        ctx, {"w": torch.zeros(300)}, local[0],
        tsecure_agg.AggregatorConfig(p_ratio=0.2, dp_b=0.5))
    upd = agg.client_protect({"w": torch.zeros(300)}, pk,
                             torch.Generator().manual_seed(7))
    assert upd.plain.shape == (240,) and float(upd.plain.abs().sum()) > 0
