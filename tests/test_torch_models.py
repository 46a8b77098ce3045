"""The port's model families against the JAX package's, on the CPU.

For each of the 10 smoke configs (the transformer families, mamba2 and
zamba2), JAX's `init(PRNGKey(0))`
goes through `interop.params_from_np` into the port, and the same numpy
batch (B = 2, S = 16) goes through both packages:

  * loss to rtol 1e-5 and every gradient leaf to rtol 1e-4 / atol 1e-6
    (float32; the port with remat on, through torch's checkpoint; the
    mamba2 scan's inter-chunk loop sums in another order than JAX's
    associative scan);
  * `param_count` and the flat vectors of `packing.flatten_params`
    (offsets and values, exactly);
  * prefill logits and the logits of 3 decode steps after a 9-token
    prefill, and every cache buffer (KV, conv and SSM state), to rtol 1e-5
    / atol 1e-6;
  * bfloat16 compute on the Qwen smoke config, at rtol 1e-3 on the loss
    and 5e-2 relative L2 error per gradient leaf (bfloat16 keeps 8 bits:
    each rounding is up to 2^-9 relative, and the two packages round at
    different points inside fused ops; measured 6e-6 and 1.0e-2).

The FULL Qwen1.5-0.5B tree from `init_abstract` (meta tensors) has the
leaf shapes that chip_smoke.py's QWEN_LEAVES restates.
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
from repro.models import sharding as jsharding

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch import models as tmodels
from repro_torch.core import packing as tpacking
from repro_torch.models import sharding as tsharding

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = list(jconfigs.ARCHS)
CAUSAL = [a for a in ARCHS if jconfigs.get_config(a).has_decode]
B, S = 2, 16
RTOL_LOSS, RTOL_GRAD, ATOL_GRAD = 1e-5, 1e-4, 1e-6
RTOL_LOGITS, ATOL_LOGITS = 1e-5, 1e-6
# XLA's CPU backend compiles these smoke graphs 2x faster without its
# expensive LLVM passes; the passes do not reassociate float math
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jit_call(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _np_batch(cfg, seed, b=B, s=S, labels=True):
    rng = np.random.RandomState(seed)
    if cfg.family == "encoder":
        out = {"frames": rng.randn(b, s, cfg.frame_dim).astype(np.float32)}
    elif cfg.family == "vlm":
        s = s - cfg.n_patches
        out = {"tokens": rng.randint(0, cfg.vocab, (b, s)).astype(np.int32),
               "patches": rng.randn(b, cfg.n_patches,
                                    cfg.patch_dim).astype(np.float32)}
    else:
        out = {"tokens": rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)}
    if labels:
        out["labels"] = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _configs(arch, **changes):
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True), **changes)
    t = dataclasses.replace(tconfigs.get_config(arch, smoke=True), **changes)
    return j, t


@functools.lru_cache(maxsize=None)
def _jax_case(arch, dtype="float32"):
    """(numpy params, numpy batch, loss, numpy grads) of the JAX package,
    without remat (the same values; it compiles faster)."""
    jcfg, _ = _configs(arch, dtype=dtype)
    model = jmodels.build_model(jcfg)
    params = _jit_call(model.init, jax.random.PRNGKey(0))
    batch = _np_batch(jcfg, seed=1)
    loss, grads = _jit_call(jax.value_and_grad(model.loss_fn), params,
                            _jax(batch))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return as_np(params), batch, float(loss), as_np(grads)


def _torch_model(arch, **changes):
    _, tcfg = _configs(arch, **changes)
    return tmodels.build_model(tcfg, device="cpu")


def _assert_tree_close(got, want, rtol, atol):
    got_l = tpacking.tree_leaves(got)
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jp, batch, jloss, jgrads = _jax_case(arch)
    model = _torch_model(arch, remat=True)
    params = interop.params_from_np(jp, "cpu")
    loss, grads = tmodels.value_and_grad(model.loss_fn)(params,
                                                        _torch(batch))
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL_LOSS)
    _assert_tree_close(grads, jgrads, RTOL_GRAD, ATOL_GRAD)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_flat_layout_match_jax(arch):
    jp, _, _, _ = _jax_case(arch)
    jcfg, tcfg = _configs(arch)
    params = interop.params_from_np(jp, "cpu")
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    tvec, tspec = tpacking.flatten_params(params)
    jvec, jspec = jpacking.flatten_params(jp)
    assert tspec.total == jspec.total == tcfg.param_count()
    assert tspec.offsets == tuple(jspec.offsets)
    assert tspec.shapes == tuple(tuple(s) for s in jspec.shapes)
    np.testing.assert_array_equal(tvec.numpy(), np.asarray(jvec))
    # the same parameters through the module: names follow JAX's paths
    model = _torch_model(arch)
    model.module.set_tree(params)
    mvec, _ = tpacking.flatten_params(model.params())
    np.testing.assert_array_equal(mvec.numpy(), np.asarray(jvec))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_and_specs_match_jax(arch):
    jcfg, tcfg = _configs(arch)
    jm = jmodels.build_model(jcfg)
    model = tmodels.build_model(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    jabs = jm.init_abstract()
    got = [tuple(t.shape) for t in tpacking.tree_leaves(params)]
    assert got == [tuple(s.shape) for s in jax.tree_util.tree_leaves(jabs)]
    assert all(t.device.type == "meta"
               for t in tpacking.tree_leaves(model.init_abstract()))
    # the module's parameters are the returned tree's storage
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(
        tpacking.tree_leaves(model.params()), tpacking.tree_leaves(params)))
    # weights are drawn within the +-2 std truncation
    w = params["layers"]["in_x" if tcfg.family in ("ssm", "hybrid")
                         else "wq"]
    assert 0 < float(w.abs().max()) <= 2 * 0.02
    ax4 = (jsharding.AxisEnv(data_size=2, model_size=2),
           tsharding.AxisEnv(data_size=2, model_size=2))
    for jax_ax, t_ax in [(jsharding.CPU_ENV, tsharding.CPU_ENV), ax4]:
        for mode in ("train", "serve_tp"):
            jspecs = jsharding.param_specs(jabs, jax_ax, mode=mode)
            tspecs = tsharding.param_specs(model.init_abstract(), t_ax,
                                           mode=mode)
            jl = jax.tree_util.tree_leaves(
                jspecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))
            assert [tuple(s) for s in jl] == _spec_leaves(tspecs)
        for b in (1, 4):
            assert tuple(jsharding.kv_cache_spec(jax_ax, b)) == \
                tsharding.kv_cache_spec(t_ax, b)
            assert tuple(jsharding.batch_spec(jax_ax, b)) == \
                tsharding.batch_spec(t_ax, b)


def _spec_leaves(tree):
    """Spec tuples in sorted-key order (packing would recurse into them)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_spec_leaves(v) if isinstance(v, dict) else [v])
    return out


@pytest.mark.parametrize("arch", CAUSAL)
def test_prefill_and_decode_match_jax(arch):
    jcfg, _ = _configs(arch)
    jp, _, _, _ = _jax_case(arch)
    jm = jmodels.build_model(jcfg)
    model = _torch_model(arch)
    params = interop.params_from_np(jp, "cpu")
    full = _np_batch(jcfg, seed=2, s=12 + jcfg.n_patches, labels=False)
    n_pre = 9
    pre = {**full, "tokens": full["tokens"][:, :n_pre]}
    cache_len = full["tokens"].shape[1] + jcfg.n_patches + 2
    jl, jc = _jit_call(functools.partial(jm.prefill, cache_len=cache_len),
                       jp, _jax(pre))
    jdecode = None
    tl, tc = model.prefill(params, _torch(pre), cache_len=cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL_LOGITS,
                               atol=ATOL_LOGITS)
    for t in range(n_pre, full["tokens"].shape[1]):
        tok = full["tokens"][:, t]
        tok_j = {"tokens": jnp.asarray(tok)}
        if jdecode is None:
            jdecode = jax.jit(jm.decode_step).lower(jp, jc, tok_j).compile(
                FAST_COMPILE)
        jl, jc = jdecode(jp, jc, tok_j)
        tl, tc = model.decode_step(params, tc, {"tokens": torch.from_numpy(
            tok)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=RTOL_LOGITS, atol=ATOL_LOGITS)
        assert int(tc["pos"]) == int(jc["pos"])
    assert sorted(tc) == sorted(jc)
    for name in sorted(tc):
        if name == "pos":
            continue
        assert len(tc[name]) == len(jc[name]), name
        for got, want in zip(tc[name], jc[name]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL_LOGITS, atol=ATOL_LOGITS,
                                       err_msg=name)


def test_encoder_forward_matches_jax():
    arch = "hubert-xlarge"
    jcfg, _ = _configs(arch)
    jp, _, _, _ = _jax_case(arch)
    batch = _np_batch(jcfg, seed=3, labels=False)
    jl, jcache = _jit_call(jmodels.build_model(jcfg).prefill, jp,
                           _jax(batch))
    model = _torch_model(arch)
    tl, tcache = model.prefill(interop.params_from_np(jp, "cpu"),
                               _torch(batch))
    assert jcache is None and tcache is None and model.decode_step is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL_LOGITS,
                               atol=ATOL_LOGITS)


def test_bf16_loss_and_grads_match_jax():
    arch = "qwen1.5-0.5b"
    jp, batch, jloss, jgrads = _jax_case(arch, "bfloat16")
    model = _torch_model(arch, dtype="bfloat16", remat=True)
    loss, grads = tmodels.value_and_grad(model.loss_fn)(
        interop.params_from_np(jp, "cpu"), _torch(batch))
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-3)
    for g, w in zip(tpacking.tree_leaves(grads),
                    jax.tree_util.tree_leaves(jgrads)):
        g = g.numpy().astype(np.float64)
        w = np.asarray(w, np.float64)
        assert np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w)


def test_full_qwen_tree_is_the_chip_round_layout():
    """chip_smoke.py's QWEN_LEAVES: 14 leaves, 463,987,712 values."""
    d, f, nl, v = 1024, 2816, 24, 151936
    want = {
        "embed": (v, d),
        "layers": {
            "bk": (nl, d), "bq": (nl, d), "bv": (nl, d),
            "ln1": (nl, d), "ln2": (nl, d),
            "w_down": (nl, f, d), "w_gate": (nl, d, f), "w_up": (nl, d, f),
            "wk": (nl, d, d), "wo": (nl, d, d), "wq": (nl, d, d),
            "wv": (nl, d, d),
        },
        "ln_f": (d,),
    }
    cfg = tconfigs.get_config("qwen1.5-0.5b")
    abstract = tmodels.build_model(cfg, device="cpu").init_abstract()
    got = tpacking.tree_map(lambda t: tuple(t.shape), abstract)
    assert got == want
    assert sum(t.numel() for t in tpacking.tree_leaves(abstract)) == \
        463_987_712 == cfg.param_count()


def test_build_model_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the guard cannot trip")
    cfg = tconfigs.get_config("qwen1.5-0.5b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.build_model(cfg)
    assert tmodels.build_model(cfg, device="cpu").device.type == "cpu"


def test_configs_and_shapes_match_jax():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    for arch in jconfigs.ARCHS:
        for smoke in (False, True):
            assert dataclasses.asdict(tconfigs.get_config(arch, smoke)) == \
                dataclasses.asdict(jconfigs.get_config(arch, smoke))
    assert tconfigs.all_cells() == jconfigs.all_cells()
    for arch in ARCHS:
        jcfg, tcfg = _configs(arch)
        jm = jmodels.build_model(jcfg)
        tm = tmodels.build_model(tcfg, device="cpu")
        for shape in tconfigs.cells_for(tcfg):
            js = jconfigs.input_specs(jcfg, shape, jm)
            ts = tconfigs.input_specs(tcfg, shape, tm)
            jl = jax.tree_util.tree_leaves(js)
            tl = tpacking.tree_leaves(ts)
            assert [tuple(s.shape) for s in jl] == [tuple(t.shape)
                                                    for t in tl]
            assert [str(s.dtype) for s in jl] == \
                [str(t.dtype).replace("torch.", "") for t in tl]
            assert all(t.device.type == "meta" for t in tl)


def test_moe_capacity_drops_match_jax_and_are_counted():
    """A tiny capacity factor drops token-expert assignments: the loss
    still matches JAX's, and with obs enabled each layer's call counts its
    kept and dropped assignments (T * top_k in all)."""
    from repro_torch import obs

    arch = "phi3.5-moe-42b-a6.6b"
    jcfg, tcfg = _configs(arch, capacity_factor=0.25)
    jm = jmodels.build_model(jcfg)
    jp = _jit_call(jm.init, jax.random.PRNGKey(2))
    batch = _np_batch(jcfg, seed=4)
    jloss = float(_jit_call(jm.loss_fn, jp, _jax(batch)))
    model = tmodels.build_model(tcfg, device="cpu")
    series = [(obs.counter("moe_token_assignments_total", layer=i,
                           kept="true"),
               obs.counter("moe_token_assignments_total", layer=i,
                           kept="false")) for i in range(tcfg.n_layers)]
    before = [(k.value, d.value) for k, d in series]
    obs.configure(enabled=True)
    try:
        loss = float(model.loss_fn(interop.params_from_np(
            jax.tree_util.tree_map(np.asarray, jp), "cpu"), _torch(batch)))
    finally:
        obs.configure(enabled=False)
    np.testing.assert_allclose(loss, jloss, rtol=RTOL_LOSS)
    for (k, d), (k0, d0) in zip(series, before):
        n_kept, n_dropped = k.value - k0, d.value - d0
        assert n_kept + n_dropped == B * S * tcfg.top_k   # one call a layer
        assert n_dropped > 0 and n_kept > 0
