"""Mixture-of-Experts FFN with sort-based capacity dispatch (the JAX
package's `models/moe.py`, local path).

Tokens are stably argsorted by expert id, packed into [E, C] capacity
slots (C = ceil(T*k/E * capacity_factor), rounded up to 8; a token past
its expert's capacity goes to a sink row e*C and is dropped), run through
three batched matmuls, and scatter-added back with their renormalized
router weights.  The Switch load-balancing aux loss comes with it.

Distribution: on plain tensors (one card) `moe_ffn` runs `_moe_local`
directly.  On DTensors it runs `_moe_local` per data shard under
`local_map`, the JAX package's `shard_map` path: tokens never cross the
data axis, the expert weights are sharded on d_ff over 'model', and the
in-placements are JAX's in_specs (x over dp, the router replicated,
`expert_gate`/`expert_up` on their last dim, `expert_down` on its middle
dim).  JAX's `psum(out, model)` is the out-placement `Partial()` over
'model', and its `pmean(aux, model | dp)` is `Partial()` over every mesh
dim of aux / mesh size: `Partial("avg")` would give the same value, but
`DTensor.from_local` hands each rank the whole gradient of a partial
output, which is right for a sum and n times too large for a mean.  Both
are redistributed (to the residual's placement and to `Replicate()`)
after the call, so the gradient stays in DTensor's hands.  The combine's
`index_add` sums each token's top_k rows in an unspecified order on the
card, so the output equals the CPU's only within float rounding.

While obs is enabled, each call counts its token-expert assignments kept
and dropped in `moe_token_assignments_total{layer=i, kept="true"|"false"}`
(a host sync per layer; a remat recompute counts again, which leaves the
dropped shares unchanged).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.models import layers as L
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig


def init(gen, cfg: ModelConfig, n_layers: int, device):
    dt = L.dtype_of(cfg.param_dtype)
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": L.trunc_normal(gen, (n_layers, d, e), 0.02, dt, device),
        "expert_gate": L.trunc_normal(gen, (n_layers, e, d, ff), 0.02, dt,
                                      device),
        "expert_up": L.trunc_normal(gen, (n_layers, e, d, ff), 0.02, dt,
                                    device),
        "expert_down": L.trunc_normal(
            gen, (n_layers, e, ff, d), 0.02 / math.sqrt(2 * n_layers), dt,
            device),
    }


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


def _moe_local(x, router_w, w_gate, w_up, w_down, cfg: ModelConfig,
               layer: int = 0):
    """x: [T, d]. Returns (out [T, d], aux scalar)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(t, cfg)
    dev = x.device
    logits = x @ router_w.to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)                # [T, k]
    # load-balance aux (Switch): E * sum_e f_e * P_e
    me = torch.mean(probs, dim=0)
    flat_e = top_e.reshape(-1)                                 # [T*k]
    # index_add, not bincount: the same integer counts, and it also runs on
    # meta tensors (the dry-run)
    counts = torch.zeros(e, dtype=torch.int64, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    fe = counts.float() / (t * k)
    aux = e * torch.sum(fe * me)

    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = order // k
    offsets = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(t * k, device=dev) - offsets[sorted_e]
    keep = ranks < c
    slot = torch.where(keep, sorted_e * c + ranks, e * c)     # drop -> sink
    if obs.enabled():
        n_kept = int(keep.sum())
        obs.counter("moe_token_assignments_total", layer=layer,
                    kept="true").inc(n_kept)
        obs.counter("moe_token_assignments_total", layer=layer,
                    kept="false").inc(t * k - n_kept)

    keep_x = keep[:, None].to(x.dtype)
    xg = x[sorted_tok] * keep_x
    disp = torch.zeros((e * c + 1, d), dtype=x.dtype, device=dev) \
        .index_add(0, slot, xg)[:-1]
    h = disp.reshape(e, c, d)
    g = torch.bmm(h, w_gate.to(x.dtype))
    u = torch.bmm(h, w_up.to(x.dtype))
    y = torch.bmm(F.silu(g) * u, w_down.to(x.dtype))
    yf = y.reshape(e * c, d)
    back = yf[slot.clamp(max=e * c - 1)] * keep_x
    w = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    w_sorted = w.reshape(-1)[order].to(x.dtype)
    out = torch.zeros((t, d), dtype=x.dtype, device=dev) \
        .index_add(0, sorted_tok, back * w_sorted[:, None])
    return out, aux


def moe_ffn(p, i, x, cfg: ModelConfig, ax: sharding.AxisEnv):
    """x: [B, S, d] -> ([B, S, d], aux); local_map'd on DTensors."""
    b, s, d = x.shape
    args = (p["router"][i], p["expert_gate"][i], p["expert_up"][i],
            p["expert_down"][i])
    if not sharding.is_dtensor(x):
        x, *args = sharding.contiguous_grads(x, *args)
        out, aux = _moe_local(x.reshape(-1, d), *args, cfg, layer=i)
        return out.reshape(b, s, d), aux

    from torch.distributed.tensor import Partial, Replicate
    mesh = x.device_mesh
    dp = ax.dp if ax.data_size > 1 else None
    mp = ax.model if ax.model_size > 1 else None
    pl = lambda *spec: sharding.placements(spec, mesh)
    model_dims = [j for j, n in enumerate(mesh.mesh_dim_names)
                  if n == ax.model]
    out_pl = [Partial() if j in model_dims else r
              for j, r in enumerate(pl(dp, None, None))]
    body = lambda x, *w: _moe_body(x, *w, cfg=cfg, layer=i,
                                   n_ranks=mesh.size())
    out, aux = sharding.local_map(
        body, mesh,
        (pl(dp, None, None), pl(None, None), pl(None, None, mp),
         pl(None, None, mp), pl(None, mp, None)),
        (out_pl, [Partial()] * mesh.ndim))(x, *args)
    return (out.redistribute(mesh, pl(dp, None, None)),
            aux.redistribute(mesh, [Replicate()] * mesh.ndim))


def _moe_body(x, *weights, cfg: ModelConfig, layer: int, n_ranks: int):
    """The per-shard body: x [B_local, S, d] -> (out [B_local, S, d],
    aux / n_ranks)."""
    b, s, d = x.shape
    out, aux = _moe_local(x.reshape(-1, d), *weights, cfg, layer=layer)
    return out.reshape(b, s, d), aux / n_ranks
