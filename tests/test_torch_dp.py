"""The port's DP accounting and mask statistics against the JAX package's.

The epsilon functions and `selection_advantage` take the same numpy (or
torch) sensitivity vectors in both packages and must agree to rtol 1e-12;
`mask_stats` must give the same dict.  `laplace_noise_tree` keeps the
tree's structure and its noise passes a Kolmogorov-Smirnov test against
Laplace(b).
"""
import numpy as np
import pytest
import scipy.stats
import torch

from repro.core import dp as jdp
from repro.core import selection as jsel

from repro_torch.core import dp as tdp
from repro_torch.core import selection as tsel
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-12


def _sens(seed, n=5000):
    return np.random.RandomState(seed).rand(n) * 3.0 - 1.0   # signed


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_epsilons_equal_jax(p, as_tensor):
    s = _sens(1)
    mask = np.random.RandomState(2).rand(s.size) < p
    ts = torch.from_numpy(s) if as_tensor else s
    tm = torch.from_numpy(mask) if as_tensor else mask
    b = 0.7
    np.testing.assert_allclose(tdp.epsilon_total(ts, tm, b),
                               jdp.epsilon_total(s, mask, b), rtol=RTOL)
    j = jdp.epsilon_all_plaintext(s, b)
    np.testing.assert_allclose(tdp.epsilon_all_plaintext(ts, b), j,
                               rtol=RTOL)
    assert tdp.epsilon_uniform_random(j, p) == jdp.epsilon_uniform_random(j,
                                                                          p)
    assert tdp.epsilon_uniform_selective(j, p) == \
        jdp.epsilon_uniform_selective(j, p)


@pytest.mark.parametrize("p", [0.0, 0.05, 0.3, 1.0])
def test_selection_advantage_equals_jax(p):
    s = np.abs(_sens(3))
    s[::7] = s[3]                       # ties: top-p breaks them by index
    got = tdp.selection_advantage(s, p, b=0.5, seed=4)
    want = jdp.selection_advantage(s, p, b=0.5, seed=4)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)
    assert got["eps_selective"] <= got["eps_random"] + 1e-12 <= \
        got["eps_none"] + 2e-12
    tensor = tdp.selection_advantage(torch.from_numpy(s), p, b=0.5, seed=4)
    assert tensor == got


@pytest.mark.parametrize("p", [0.0, 0.2, 1.0])
def test_mask_stats_equals_jax(p):
    s = _sens(5, 1000)
    jm = jsel.top_p_mask(s, p)
    tm = tsel.top_p_mask(torch.from_numpy(s), p)
    assert tsel.mask_stats(tm) == jsel.mask_stats(jm)
    assert tsel.mask_stats(np.asarray(jm)) == jsel.mask_stats(jm)


def test_laplace_noise_tree_structure_and_distribution():
    b = 0.25
    tree = {"w": torch.zeros(200, 250), "layers": [torch.zeros(10),
                                                    torch.zeros(3, 4)],
            "bias": (torch.zeros(5, dtype=torch.float64),)}
    gen = torch.Generator().manual_seed(0)
    out = tdp.laplace_noise_tree(tree, gen, b)
    assert sorted(out) == sorted(tree)
    assert isinstance(out["layers"], list) and isinstance(out["bias"], tuple)
    for got, like in ((out["w"], tree["w"]), (out["layers"][1],
                                              tree["layers"][1]),
                      (out["bias"][0], tree["bias"][0])):
        assert got.shape == like.shape and got.dtype == like.dtype
    noise = out["w"].reshape(-1).double().numpy()            # 50,000 ...
    more = tdp.laplace_noise_tree({"x": torch.zeros(50_000)}, gen, b)
    noise = np.concatenate([noise, more["x"].double().numpy()])  # ... 1e5
    res = scipy.stats.kstest(noise, "laplace", args=(0.0, b))
    assert res.pvalue > 1e-3, res
    # the leaves are noised from one generator in pytree order (sorted
    # keys): the same seed gives the same tree
    again = tdp.laplace_noise_tree(tree, torch.Generator().manual_seed(0), b)
    assert torch.equal(again["w"], out["w"])
    assert torch.equal(again["layers"][0], out["layers"][0])
    first = tdp.laplace_noise_vec(torch.zeros(5, dtype=torch.float64),
                                  torch.Generator().manual_seed(0), b)
    assert torch.equal(out["bias"][0], first)
