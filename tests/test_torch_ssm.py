"""The port's SSM pieces (mamba2, zamba2) against the JAX package's and
against a step-by-step recurrence, on the CPU.

  * `ssd_chunked` at 1, 2 and 4 chunks against JAX's (its associative scan
    against the port's loop over chunks) and against the recurrence
    h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t in float64,
    with and without an initial state h0.  With h0 the port's first chunk
    reads it, as the recurrence does; JAX's first chunk reads zeros there
    (only its final state carries h0), so JAX is held on the later chunks
    and the final state only;
  * `block` at a sequence that is not a chunk multiple (the dt = 0 padding)
    against JAX's and against the same block run unpadded (one chunk of
    the whole sequence): the padded steps change neither the outputs nor
    the final state;
  * `causal_conv` and `block_decode` against JAX's;
  * decode against prefill for both families;
  * zamba2's shared block: one invocation after every shared_attn_every-th
    mamba layer, one KV cache per invocation, each holding its own
    activations.
Float32 throughout, at rtol 1e-5 / atol 1e-6 (the tolerances of
tests/test_torch_models.py); the float64 recurrence at rtol 1e-4 / atol
1e-5 (the chunked form sums exp(cum) products in float32).
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
from repro.models import mamba2 as jmamba2
from repro.models import sharding as jsharding
from repro.models import zamba2 as jzamba2

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch import models as tmodels
from repro_torch.models import CPU_ENV
from repro_torch.models import mamba2 as tmamba2
from repro_torch.models import zamba2 as tzamba2

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-6
RTOL_REC, ATOL_REC = 1e-4, 1e-5
B, NH, HD, ST = 2, 3, 4, 5


def _ssd_inputs(seed, s, with_h0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, s, NH, HD).astype(np.float32)
    dtv = (0.05 + 0.2 * rng.rand(B, s, NH)).astype(np.float32)
    a = -np.arange(1, NH + 1, dtype=np.float32)
    b = rng.randn(B, s, ST).astype(np.float32)
    c = rng.randn(B, s, ST).astype(np.float32)
    h0 = rng.randn(B, NH, HD, ST).astype(np.float32) if with_h0 else None
    return x, dtv, a, b, c, h0


def _recurrence(x, dtv, a, b, c, h0=None):
    """The SSM step by step in float64: (y [B,S,nh,hd], h [B,nh,hd,st])."""
    x, dtv, a, b, c = (np.asarray(t, np.float64) for t in (x, dtv, a, b, c))
    h = np.zeros((B, NH, HD, ST)) if h0 is None else h0.astype(np.float64)
    ys = []
    for t in range(x.shape[1]):
        decay = np.exp(dtv[:, t] * a)                           # [B, nh]
        h = decay[..., None, None] * h + np.einsum(
            "bh,bhd,bt->bhdt", dtv[:, t], x[:, t], b[:, t])
        ys.append(np.einsum("bhdt,bt->bhd", h, c[:, t]))
    return np.stack(ys, axis=1), h


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax_and_the_recurrence(n_chunks, with_h0):
    chunk = 6
    x, dtv, a, b, c, h0 = _ssd_inputs(n_chunks, chunk * n_chunks, with_h0)
    y, h = tmamba2.ssd_chunked(*_t(x, dtv, a, b, c), chunk,
                               h0=None if h0 is None else torch.from_numpy(h0))
    jy, jh = jmamba2.ssd_chunked(x, dtv, a, b, c, chunk, h0=h0)
    ry, rh = _recurrence(x, dtv, a, b, c, h0)
    np.testing.assert_allclose(y.numpy(), ry, rtol=RTOL_REC, atol=ATOL_REC)
    np.testing.assert_allclose(h.numpy(), rh, rtol=RTOL_REC, atol=ATOL_REC)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
    first = 0 if h0 is None else chunk
    np.testing.assert_allclose(y.numpy()[:, first:],
                               np.asarray(jy)[:, first:], rtol=RTOL,
                               atol=ATOL)
    if h0 is not None:
        # the reference's first chunk leaves h0 out of its outputs
        gap = np.abs(np.asarray(jy)[:, :chunk] - ry[:, :chunk]).max()
        assert gap > 1e-2


def _smoke(arch, **changes):
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True), **changes)
    t = dataclasses.replace(tconfigs.get_config(arch, smoke=True), **changes)
    return j, t


FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    """(JAX model, its numpy params from PRNGKey(0))."""
    jm = jmodels.build_model(jconfigs.get_config(arch, smoke=True))
    key = jax.random.PRNGKey(0)
    jp = jax.jit(jm.init).lower(key).compile(FAST_COMPILE)(key)
    return jm, jax.tree_util.tree_map(np.asarray, jp)


def _jax_params(arch):
    """(JAX model, JAX params, the same params in the port)."""
    jm, nparams = _jax_model(arch)
    return (jm, jax.tree_util.tree_map(jnp.asarray, nparams),
            interop.params_from_np(nparams, "cpu"))


def test_block_pads_to_the_chunk_and_keeps_the_final_state():
    """S = 13 with chunk 8: three padded steps of dt = 0."""
    jcfg, tcfg = _smoke("mamba2-370m")
    _, jp, tp = _jax_params("mamba2-370m")
    rng = np.random.RandomState(3)
    u = rng.randn(B, 13, jcfg.d_model).astype(np.float32)
    y, h = tmamba2.block(tp["layers"], 1, torch.from_numpy(u), tcfg, CPU_ENV)
    jy, jh = jmamba2.block(jp["layers"], 1, jnp.asarray(u), jcfg,
                           jsharding.CPU_ENV)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
    # the same block unpadded (chunk = S) has the same final state
    y1, h1 = tmamba2.block(tp["layers"], 1, torch.from_numpy(u),
                           dataclasses.replace(tcfg, ssm_chunk=13), CPU_ENV)
    np.testing.assert_allclose(h.numpy(), h1.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y.numpy(), y1.numpy(), rtol=RTOL, atol=ATOL)


def test_causal_conv_and_block_decode_match_jax():
    jcfg, tcfg = _smoke("mamba2-370m")
    _, jp, tp = _jax_params("mamba2-370m")
    rng = np.random.RandomState(4)
    x = rng.randn(B, 7, 10).astype(np.float32)
    k = rng.randn(4, 10).astype(np.float32)
    np.testing.assert_allclose(
        tmamba2.causal_conv(torch.from_numpy(x), torch.from_numpy(k)).numpy(),
        np.asarray(jmamba2.causal_conv(x, k)), rtol=RTOL, atol=ATOL)
    ch = jcfg.d_inner + 2 * jcfg.ssm_groups * jcfg.ssm_state
    u = rng.randn(B, jcfg.d_model).astype(np.float32)
    conv = rng.randn(B, jcfg.conv_width - 1, ch).astype(np.float32)
    ssm = rng.randn(B, jcfg.ssm_heads, jcfg.ssm_head_dim,
                    jcfg.ssm_state).astype(np.float32)
    got = tmamba2.block_decode(tp["layers"], 0, *_t(u, conv, ssm), tcfg,
                               CPU_ENV)
    want = jmamba2.block_decode(jp["layers"], 0, u, conv, ssm, jcfg,
                                jsharding.CPU_ENV)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_decode_matches_prefill(arch):
    """A prefill of 7 tokens and 5 decode steps against one prefill of all
    12: the recurrent and chunked forms of the same model (chunk 8, so the
    long prefill crosses a chunk boundary)."""
    _, tcfg = _smoke(arch)
    model = tmodels.build_model(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(5))
    toks = torch.from_numpy(np.random.RandomState(6).randint(
        0, tcfg.vocab, (B, 12)).astype(np.int32))
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks[:, :7]},
                                      cache_len=12)
        for t in range(7, 12):
            logits, cache = model.decode_step(params, cache,
                                              {"tokens": toks[:, t]})
        want, want_cache = model.prefill(params, {"tokens": toks},
                                         cache_len=12)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert int(cache["pos"]) == 12
    for got, ref in zip(cache["ssm"], want_cache["ssm"]):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_zamba2_shared_block_invocations_and_caches(monkeypatch):
    jcfg, tcfg = _smoke("zamba2-7b")
    ns = tzamba2.n_shared_invocations(tcfg)
    assert ns == jzamba2.n_shared_invocations(jcfg) == 2
    assert [i for i in range(tcfg.n_layers)
            if tzamba2._is_shared_layer(i, tcfg)] == [1, 3]
    jm, jp, tp = _jax_params("zamba2-7b")
    model = tmodels.build_model(tcfg, device="cpu")
    calls = []
    real = tzamba2._shared_block

    def counted(ps, h, *args, **kw):
        calls.append(h.shape)
        return real(ps, h, *args, **kw)

    monkeypatch.setattr(tzamba2, "_shared_block", counted)
    toks = np.random.RandomState(7).randint(0, jcfg.vocab,
                                            (B, 10)).astype(np.int32)
    with torch.no_grad():
        model.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                           "labels": torch.from_numpy(toks)})
    assert len(calls) == ns                      # one per invocation
    calls.clear()
    _, cache = model.prefill(tp, {"tokens": torch.from_numpy(toks)},
                             cache_len=14)
    assert len(calls) == ns
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=14)
    assert len(cache["attn_k"]) == len(cache["attn_v"]) == ns
    for name in ("attn_k", "attn_v"):
        for got, want in zip(cache[name], jcache[name]):
            assert tuple(got.shape) == (B, 14, tcfg.n_kv_heads, tcfg.hd)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)
            assert float(got[:, 10:].abs().max()) == 0.0    # unwritten
        # each invocation caches its own activations
        assert not torch.allclose(cache[name][0][:, :10],
                                  cache[name][1][:, :10])
    # the shared weights are views of one leaf each: [2d, H*hd] for wq
    shared = tp["shared"]
    assert tuple(shared["wq"].shape) == (2 * tcfg.d_model,
                                         tcfg.n_heads * tcfg.hd)
    assert tuple(shared["wo"].shape) == (tcfg.n_heads * tcfg.hd,
                                         tcfg.d_model)
    stacked = tzamba2._stacked(shared, ("wq",))
    assert stacked["wq"].data_ptr() == shared["wq"].data_ptr()
