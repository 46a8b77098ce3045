"""AdamW with global-norm clipping, as functions on trees of tensors (the
JAX package's `optim/adamw.py`: the same formula and order of operations).

Optimizer state is a tree shaped like params (m, v in float32) plus an
int32 step.  `torch.optim.AdamW` is not this: it applies the decay before
the moment step and has no global-norm clip.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import packing


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = packing.tree_leaves(params)[0].device
    return {
        "m": packing.tree_map(zeros, params),
        "v": packing.tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree):
    """sqrt of the float32 sum of squares, leaf sums added in pytree
    order."""
    total = 0
    for g in packing.tree_leaves(tree):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return packing.tree_map(lambda g: (g.float() * scale).to(g.dtype),
                            grads), norm


def adamw_update(grads, opt_state, params, cfg: AdamWConfig, lr=None):
    """Returns (new_params, new_opt_state, grad_norm)."""
    lr = cfg.lr if lr is None else lr
    grads, norm = clip_by_global_norm(grads, cfg.clip_norm)
    step = opt_state["step"] + 1
    t = step.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    def upd(g, m, v, p):
        g32 = g.float()
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        mh = m / bc1
        vh = v / bc2
        p32 = p.float()
        p32 = p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * p32)
        return p32.to(p.dtype), m, v

    spec = packing.make_flat_spec(params)
    out = [upd(g, m, v, p) for g, m, v, p in
           zip(packing.tree_leaves(grads), packing.tree_leaves(opt_state["m"]),
               packing.tree_leaves(opt_state["v"]),
               packing.tree_leaves(params))]
    new_p = packing.unflatten_leaves([o[0] for o in out], spec)
    new_m = packing.unflatten_leaves([o[1] for o in out], spec)
    new_v = packing.unflatten_leaves([o[2] for o in out], spec)
    return new_p, {"m": new_m, "v": new_v, "step": step}, norm
