"""The port's optimiser against the JAX package's, on the CPU.

AdamW runs 3 steps with the global-norm clip active (gradients scaled so
their norm exceeds clip_norm) from the same numpy parameters and
gradients in both packages: parameters, moments and norms to rtol 1e-6 /
atol 1e-8 (float32 elementwise chains of the same order; XLA may fuse a
multiply-add into one rounding, which leaves up to an ulp of the 0.1-sized
operands, about 1e-8, where the result cancels to near zero).  `cosine_lr`
over a step range through warmup and decay to rtol 1e-6.  DoubleSqueeze
on tie-free inputs gives the same kept indices, values and error;
with ties (`jax.lax.top_k` and `torch.topk` may keep different indices
among equal magnitudes) only the kept magnitudes and the error-feedback
identity are held.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim

from repro_torch import interop
from repro_torch import optim as toptim
from repro_torch.core import packing as tpacking
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-6, 1e-8


def _tree(rng, scale=1.0):
    return {"w": (rng.randn(6, 5) * scale).astype(np.float32),
            "blk": {"b": (rng.randn(5) * scale).astype(np.float32),
                    "a": (rng.randn(3, 2, 4) * scale).astype(np.float32)}}


def _close(got, want):
    for g, w in zip(tpacking.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_three_clipped_steps_match_jax(weight_decay):
    rng = np.random.RandomState(0)
    p0 = _tree(rng)
    grads = [_tree(rng, scale=3.0) for _ in range(3)]
    cfg_j = joptim.AdamWConfig(lr=1e-2, weight_decay=weight_decay)
    cfg_t = toptim.AdamWConfig(lr=1e-2, weight_decay=weight_decay)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = joptim.adamw_init(jp)
    tp = interop.params_from_np(p0, "cpu")
    ts = toptim.adamw_init(tp)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    for g in grads:
        assert float(joptim.global_norm(g)) > cfg_j.clip_norm   # clips
        jp, js, jn = joptim.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, g), js, jp, cfg_j)
        tp, ts, tn = toptim.adamw_update(interop.params_from_np(g, "cpu"),
                                         ts, tp, cfg_t)
        np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
        _close(tp, jp)
        _close(ts["m"], js["m"])
        _close(ts["v"], js["v"])
        assert int(ts["step"]) == int(js["step"])
    # AdamW state crosses through interop both ways
    back = interop.params_from_np(
        jax.tree_util.tree_map(np.asarray, js), "cpu")
    _close(back["m"], js["m"])
    assert back["step"].dtype == torch.int32
    as_np = interop.params_to_np(ts)
    assert as_np["step"].dtype == np.int32
    np.testing.assert_allclose(as_np["v"]["w"], np.asarray(js["v"]["w"]),
                               rtol=RTOL, atol=ATOL)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.RandomState(1)
    for scale in (0.01, 5.0):           # below and above clip_norm = 1
        g = _tree(rng, scale)
        jg, jn = joptim.adamw.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, g), 1.0)
        tg, tn = toptim.clip_by_global_norm(interop.params_from_np(g, "cpu"),
                                            1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
        _close(tg, jg)


def test_cosine_lr_matches_jax():
    steps = np.arange(0, 130, dtype=np.int32)
    for warmup, total in [(10, 100), (0, 50), (1, 1)]:
        want = np.asarray([joptim.cosine_lr(s, 3e-4, warmup, total)
                           for s in steps])
        got = np.asarray([float(toptim.cosine_lr(int(s), 3e-4, warmup,
                                                 total)) for s in steps])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)
    got = toptim.cosine_lr(torch.from_numpy(steps), 1e-3, 10, 100)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(joptim.cosine_lr(jnp.asarray(steps), 1e-3,
                                                 10, 100)), rtol=RTOL)


def test_double_squeeze_matches_jax_without_ties():
    rng = np.random.RandomState(2)
    n, k = 1000, 37
    js = joptim.double_squeeze_init(n)
    ts = toptim.double_squeeze_init(n, device="cpu")
    for _ in range(3):
        vec = rng.randn(n).astype(np.float32)   # continuous: no ties
        jd, (jv, ji), js = joptim.double_squeeze_compress(jnp.asarray(vec),
                                                          js, k)
        td, (tv, ti), ts = toptim.double_squeeze_compress(
            torch.from_numpy(vec), ts, k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ts.error.numpy(), np.asarray(js.error))


def test_double_squeeze_with_ties_keeps_the_same_magnitudes():
    """Ties: the kept index sets may differ; the kept magnitudes and
    corrected = compressed + new_error hold in both packages."""
    vec = np.array([3, -3, 3, 1, -1, 1, 2, -2, 0, 0], np.float32)
    k = 4
    _, (jv, _), js = joptim.double_squeeze_compress(
        jnp.asarray(vec), joptim.double_squeeze_init(vec.size), k)
    td, (tv, ti), ts = toptim.double_squeeze_compress(
        torch.from_numpy(vec), toptim.double_squeeze_init(vec.size, "cpu"),
        k)
    np.testing.assert_array_equal(np.sort(np.abs(tv.numpy())),
                                  np.sort(np.abs(np.asarray(jv))))
    np.testing.assert_array_equal((td + ts.error).numpy(), vec)
    assert int((td != 0).sum()) == k
    np.testing.assert_array_equal(td.numpy()[ti.numpy()], vec[ti.numpy()])


def test_double_squeeze_init_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the guard cannot trip")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        toptim.double_squeeze_init(8)
