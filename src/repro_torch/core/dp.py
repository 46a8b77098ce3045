"""Laplace-mechanism DP for partially encrypted FL (paper §3).

Encrypting parameter i spends no privacy budget (Theorem 3.9); leaving it
plaintext with Laplace(b) noise spends eps_i = Delta f_i / b (Lemma 3.8);
budgets add by sequential composition (Lemma 3.10), so a partial
encryption scheme spends

    eps_total = sum_{i not in S} Delta f_i / b          (Theorem 3.11)

Under Delta f ~ U(0,1): all-plaintext J, random-p (1-p) J, and sensitivity-
ordered top-p selection (1-p)^2 J (Remarks 3.12-3.14).

The noise is drawn from a `torch.Generator` on the tensors' device; the
accounting takes tensors or numpy arrays and sums in float64 on the host.
"""
from __future__ import annotations

import numpy as np
import torch


def laplace_noise_vec(vec, gen: torch.Generator, b: float):
    """vec + Laplace(0, b) noise drawn from `gen` (inverse CDF of a uniform
    in (-1, 1), the JAX sampler's construction; not its bits)."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=vec.dtype),
                         torch.tensor(0.0, dtype=vec.dtype)).item()
    u = torch.empty_like(vec).uniform_(lo, 1.0, generator=gen)
    return vec - b * torch.sign(u) * torch.log1p(-u.abs())


def laplace_noise_tree(tree, gen: torch.Generator, b: float):
    """Add Laplace(0, b) to every leaf of a nested dict / list / tuple of
    tensors (the optional DP step in Algorithm 1), the leaves noised in
    pytree order (sorted dict keys) from one generator."""
    if isinstance(tree, dict):
        return {k: laplace_noise_tree(tree[k], gen, b) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(laplace_noise_tree(t, gen, b) for t in tree)
    return laplace_noise_vec(tree, gen, b)


def _host(x, dtype) -> np.ndarray:
    """A tensor (on any device) or array-like as a flat numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype).ravel()


# ---------------------------------------------------------------------------
# epsilon accounting
# ---------------------------------------------------------------------------


def epsilon_total(sens_vec, mask, b: float) -> float:
    """Theorem 3.11: sum of Delta f_i / b over UNENCRYPTED parameters."""
    s = np.abs(_host(sens_vec, np.float64))
    m = _host(mask, bool)
    return float(s[~m].sum() / b)


def epsilon_all_plaintext(sens_vec, b: float) -> float:
    """Remark 3.12: J = sum_i Delta f_i / b."""
    return float(np.abs(_host(sens_vec, np.float64)).sum() / b)


def epsilon_uniform_random(j_total: float, p: float) -> float:
    """Remark 3.13 closed form (Delta f ~ U(0,1)): (1-p) J."""
    return (1.0 - p) * j_total


def epsilon_uniform_selective(j_total: float, p: float) -> float:
    """Remark 3.14 closed form (Delta f ~ U(0,1)): (1-p)^2 J.

    Top-p selection removes the largest mass: residual = integral of the
    lowest (1-p) quantile of U(0,1) = (1-p)^2 / 2, vs total mass 1/2.
    """
    return (1.0 - p) ** 2 * j_total


def selection_advantage(sens_vec, p: float, b: float, seed: int = 0) -> dict:
    """Empirical eps for {selective, random, none} at ratio p (the paper's
    key observation)."""
    from repro_torch.core import selection

    s = _host(sens_vec, np.float64)
    sel = selection.top_p_mask(torch.from_numpy(s), p)
    rnd = selection.random_mask(p, s.size, seed=seed, device="cpu")
    return {
        "eps_none": epsilon_all_plaintext(s, b),
        "eps_random": epsilon_total(s, rnd, b),
        "eps_selective": epsilon_total(s, sel, b),
    }
