"""The port's sensitivity maps against the JAX package's, on the CPU.

`sensitivity_exact` (jacrev over grad) on tests/test_core.py's MLP toy,
and `sensitivity_jvp_from_probes` fed JAX's own probe draws
(`jax.random.split(key, n)`, then `jax.random.normal` per key) on the toy
and on the Qwen smoke model with the FL client's soft-label loss
(`src/repro/fl/client.py` `sensitivity_map`: log-softmax of the logits'
real-vocab columns against one-hot labels).  Maps agree to rtol 1e-5,
with an atol of 1e-6 of the map's largest entry for entries that cancel
to near zero.  The sampler draws its probes from a torch.Generator.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro import models as jmodels
from repro.core import packing as jpacking
from repro.core import sensitivity as jsens
from repro.models import transformer as jtransformer

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import packing as tpacking
from repro_torch.core import sensitivity as tsens
from repro_torch.models import CPU_ENV
from repro_torch.models import transformer as ttransformer
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL_OF_MAX = 1e-5, 1e-6
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _toy(seed):
    r = np.random.RandomState(seed)
    return {"w1": (r.randn(40, 30) * 0.1).astype(np.float32),
            "b1": (r.randn(30) * 0.1).astype(np.float32),
            "w2": (r.randn(30, 5) * 0.1).astype(np.float32)}


def _toy_data(seed, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 40).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.randint(0, 5, n)]
    return x, y


def _jax_mlp_loss(params, x, y_soft):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    logp = jax.nn.log_softmax(h @ params["w2"])
    return -jnp.mean(jnp.sum(y_soft * logp, axis=-1))


def _torch_mlp_loss(params, x, y_soft):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    logp = F.log_softmax(h @ params["w2"], dim=-1)
    return -torch.mean(torch.sum(y_soft * logp, dim=-1))


def _jax_probes(key, y, n):
    return [np.array(jax.random.normal(k, y.shape, dtype=y.dtype))
            for k in jax.random.split(key, n)]


def _assert_maps_close(tmap, jmap):
    tvec, _ = tpacking.flatten_params(tmap)
    jvec, _ = jpacking.flatten_params(jmap)
    jvec = np.asarray(jvec)
    assert (tvec.numpy() >= 0).all()
    np.testing.assert_allclose(tvec.numpy(), jvec, rtol=RTOL,
                               atol=ATOL_OF_MAX * np.abs(jvec).max())


def test_exact_map_matches_jax_on_the_mlp_toy():
    p, (x, y) = _toy(7), _toy_data(8, 16)
    jmap = jsens.sensitivity_exact(_jax_mlp_loss,
                                   jax.tree_util.tree_map(jnp.asarray, p),
                                   jnp.asarray(x), jnp.asarray(y))
    tmap = tsens.sensitivity_exact(_torch_mlp_loss,
                                   interop.params_from_np(p, "cpu"),
                                   torch.from_numpy(x), torch.from_numpy(y))
    _assert_maps_close(tmap, jmap)


@pytest.mark.parametrize("n_probes", [1, 4])
def test_jvp_map_from_jax_probes_matches_jax_on_the_mlp_toy(n_probes):
    p, (x, y) = _toy(9), _toy_data(10, 8)
    key = jax.random.PRNGKey(11)
    jmap = jsens.sensitivity_jvp(_jax_mlp_loss,
                                 jax.tree_util.tree_map(jnp.asarray, p),
                                 jnp.asarray(x), jnp.asarray(y), key,
                                 n_probes=n_probes)
    probes = [torch.from_numpy(v) for v in
              _jax_probes(key, jnp.asarray(y), n_probes)]
    tmap = tsens.sensitivity_jvp_from_probes(
        _torch_mlp_loss, interop.params_from_np(p, "cpu"),
        torch.from_numpy(x), torch.from_numpy(y), probes)
    _assert_maps_close(tmap, jmap)


def test_sampled_jvp_map_ranks_like_the_exact_map():
    """The port's own sampler: the Hutchinson map ranks parameters like the
    exact map (the JAX package's test_core criterion)."""
    p, (x, y) = _toy(7), _toy_data(8, 16)
    tp = interop.params_from_np(p, "cpu")
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    exact, _ = tpacking.flatten_params(
        tsens.sensitivity_exact(_torch_mlp_loss, tp, xs, ys))
    est, _ = tpacking.flatten_params(tsens.sensitivity_jvp(
        _torch_mlp_loss, tp, xs, ys, torch.Generator().manual_seed(9),
        n_probes=32))
    ra = np.argsort(np.argsort(exact.numpy()))
    rb = np.argsort(np.argsort(est.numpy()))
    assert np.corrcoef(ra, rb)[0, 1] > 0.8
    mag, _ = tpacking.flatten_params(tsens.sensitivity_magnitude_proxy(tp))
    np.testing.assert_array_equal(mag.numpy(), np.abs(
        tpacking.flatten_params(tp)[0].numpy()))


def _client_loss(forward_logits, log_softmax, cfg, ax, to_f32):
    """src/repro/fl/client.py's soft-label loss in either package."""
    def loss_of_y(p, feats, y):
        logits, _ = forward_logits(p, dict(feats), cfg, ax)
        logp = log_softmax(to_f32(logits[..., :cfg.vocab]))
        return -(y * logp).sum(-1).mean()
    return loss_of_y


def test_jvp_map_from_jax_probes_matches_jax_on_qwen_smoke():
    jcfg = jconfigs.get_config("qwen1.5-0.5b", smoke=True)
    # torch.func refuses checkpoint: the port's map runs with remat off
    tcfg = dataclasses.replace(tconfigs.get_config("qwen1.5-0.5b",
                                                   smoke=True), remat=False)
    jm = jmodels.build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = np.random.RandomState(12)
    tokens = rng.randint(0, jcfg.vocab, (2, 8)).astype(np.int32)
    y = np.eye(jcfg.vocab, dtype=np.float32)[
        rng.randint(0, jcfg.vocab, (2, 8))]
    key = jax.random.PRNGKey(13)
    jloss = _client_loss(jtransformer.forward_logits,
                         lambda z: jax.nn.log_softmax(z, axis=-1), jcfg,
                         jm.ax, lambda z: z.astype(jnp.float32))
    jfn = lambda p, f, yy, k: jsens.sensitivity_jvp(jloss, p, f, yy, k,
                                                    n_probes=2)
    args = (jp, {"tokens": jnp.asarray(tokens)}, jnp.asarray(y), key)
    jmap = jax.jit(jfn).lower(*args).compile(FAST_COMPILE)(*args)
    tloss = _client_loss(ttransformer.forward_logits,
                         lambda z: F.log_softmax(z, dim=-1), tcfg, CPU_ENV,
                         lambda z: z.float())
    probes = [torch.from_numpy(v) for v in
              _jax_probes(key, jnp.asarray(y), 2)]
    tmap = tsens.sensitivity_jvp_from_probes(
        tloss, interop.params_from_np(jax.tree_util.tree_map(np.asarray, jp),
                                      "cpu"),
        {"tokens": torch.from_numpy(tokens)}, torch.from_numpy(y), probes)
    _assert_maps_close(tmap, jmap)


def test_probe_sampler_draws_from_the_generator():
    y = torch.zeros(3, 4)
    a = tsens.sample_probes(y, torch.Generator().manual_seed(1), 2)
    b = tsens.sample_probes(y, torch.Generator().manual_seed(1), 2)
    assert len(a) == 2 and all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], a[1])
