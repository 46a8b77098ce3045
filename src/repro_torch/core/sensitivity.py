"""Per-parameter privacy sensitivity maps (paper §2.4 Step 1).

For model W and K samples (X, y) the paper defines, per parameter w_m,

    S_m = (1/K) sum_k | d/dy_k ( dl(X, y, W) / dw_m ) |

i.e. how strongly each parameter's gradient reacts to perturbing the true
output — a cheap proxy for gradient-inversion attackability.

Losses here take *soft* targets (one-hot / distribution y) so d/dy exists.
Both evaluators differentiate with torch.func, which refuses
torch.utils.checkpoint: the loss must run its model with remat off (the
values are the same; only memory differs).

  * ``sensitivity_exact``   — full Jacobian d(grad_w)/dy via jacrev over the
    y->grad map.  O(P * K * n_out) memory; for tests and small models.
  * ``sensitivity_jvp``     — Hutchinson-style estimator: for probe vectors
    v ~ N(0, I) in y-space, jvp(y -> grad_w, v) gives J v in one
    forward-over-reverse pass; E_v |J v| ~ sqrt(2/pi) ||J_m||_2 per row.
    The sampler draws the probes from a torch.Generator;
    ``sensitivity_jvp_from_probes`` takes given probes (a JAX peer's draws
    in the tests).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import packing


def sensitivity_exact(loss_fn, params, x, y_soft):
    """loss_fn(params, x, y_soft) -> scalar. Returns a tree like params.

    S = mean_k |d(grad_w)/dy_k| where k ranges over every element of y_soft.
    """
    grad_of_y = lambda y: torch.func.grad(loss_fn)(params, x, y)
    jac = torch.func.jacrev(grad_of_y)(y_soft)   # leaves [*w_shape, *y_shape]
    ndim_y = y_soft.ndim

    def reduce_leaf(j):
        return torch.mean(torch.abs(j),
                          dim=tuple(range(j.ndim - ndim_y, j.ndim)))

    return packing.tree_map(reduce_leaf, jac)


def sample_probes(y_soft, gen: torch.Generator, n_probes: int) -> list:
    """n_probes draws of N(0, I) shaped like y_soft, from `gen`."""
    return [torch.randn(y_soft.shape, generator=gen, dtype=y_soft.dtype,
                        device=y_soft.device) for _ in range(n_probes)]


def sensitivity_jvp_from_probes(loss_fn, params, x, y_soft, probes):
    """The Hutchinson estimate of the exact map from the given probes (a
    tree like params): sum_v |J v| / (n sqrt(2/pi))."""
    grad_of_y = lambda y: torch.func.grad(loss_fn)(params, x, y)

    def one_probe(v):
        _, jv = torch.func.jvp(grad_of_y, (y_soft,), (v,))
        return packing.tree_map(torch.abs, jv)

    acc = one_probe(probes[0])
    for v in probes[1:]:
        acc = packing.tree_map(torch.add, acc, one_probe(v))
    scale = 1.0 / (len(probes) * math.sqrt(2.0 / math.pi))
    return packing.tree_map(lambda a: a * scale, acc)


def sensitivity_jvp(loss_fn, params, x, y_soft, gen: torch.Generator,
                    n_probes: int = 8):
    """Hutchinson estimator of the exact map above (same tree output), its
    probes drawn from `gen`.  Selection only needs the ranking."""
    return sensitivity_jvp_from_probes(loss_fn, params, x, y_soft,
                                       sample_probes(y_soft, gen, n_probes))


def sensitivity_magnitude_proxy(grads):
    """|grad| fallback proxy (used when y is not differentiable, e.g. pure
    token-id pipelines)."""
    return packing.tree_map(torch.abs, grads)
