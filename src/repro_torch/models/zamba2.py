"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention block
(arXiv:2411.15242), the JAX package's `models/zamba2.py`.

The shared block's weights exist once; it is invoked after every
``shared_attn_every``-th mamba layer on concat(hidden, original embedding)
(the Zamba "global shared attention" pattern).  Each invocation sees
different activations, so serving keeps one KV cache *per invocation*
([n_shared, B, S, KH, hd]).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig


def n_shared_invocations(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every


def init_model(cfg: ModelConfig, gen, device):
    dt = L.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    ones = lambda n: torch.ones((n,), dtype=dt, device=device)
    p = L.init_embed(gen, cfg, device)
    p["layers"] = mamba2.init(gen, cfg, cfg.n_layers, device)
    p["shared"] = {
        "ln1": ones(2 * d),
        **{k: v[0] for k, v in
           L.init_attn(gen, cfg, 1, device, d_in=2 * d).items()},
        "ln2": ones(d),
        **{k: v[0] for k, v in L.init_mlp(gen, cfg, 1, device).items()},
    }
    p["ln_f"] = ones(d)
    return p


def init_abstract(cfg: ModelConfig):
    """The parameter tree on the meta device."""
    return init_model(cfg, None, "meta")


def _stacked(ps, prefixes):
    """The shared weights with a fake leading layer axis (views), for the
    per-layer helpers of `layers`."""
    return {k: v[None] for k, v in ps.items() if k.startswith(prefixes)}


def _shared_block(ps, h, x0, cfg: ModelConfig, ax, positions,
                  kv_cache=None, pos=None):
    """h: [B, S, d] hidden; x0: [B, S, d] original embeddings.

    Returns (new h, (k, v)) — k/v returned for cache capture at prefill.
    kv_cache: optional (k_cache, v_cache) [B, Smax, KH, hd] for decode,
    with pos the 0-d write position.
    """
    xcat = torch.cat([h, x0], dim=-1)
    a = sharding.gather(L.rms_norm(xcat, ps["ln1"]), 1)
    pstack = _stacked(ps, ("wq", "wk", "wv", "wo"))
    q, k, v = L.attn_qkv(pstack, 0, a, cfg, ax, positions)
    if kv_cache is None:
        o = L.blocked_attention(q, k, v, cfg, ax, causal=True)
    else:
        k = L.cache_write(kv_cache[0], k, pos)
        v = L.cache_write(kv_cache[1], v, pos)
        o = L.decode_attention(q[:, 0], k, v, pos)[:, None]
    h = h + sharding.gather_grad(L.attn_out(pstack, 0, o, h.dtype), 1)
    m = sharding.gather(L.rms_norm(h, ps["ln2"]), 1)
    h = h + sharding.gather_grad(L.mlp(_stacked(ps, "w_"), 0, m), 1)
    return h, (k, v)


def _is_shared_layer(i: int, cfg: ModelConfig) -> bool:
    return (i + 1) % cfg.shared_attn_every == 0 \
        and (i + 1) // cfg.shared_attn_every <= n_shared_invocations(cfg)


def forward_logits(params, batch, cfg: ModelConfig, ax):
    h = _hidden(params, batch, cfg, ax)
    return L.logits_fn(params, h, cfg), 0.0


def _hidden(params, batch, cfg: ModelConfig, ax):
    dtype = L.dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    x0 = L.embed_tokens(params, tokens, cfg, dtype)
    positions = torch.arange(tokens.shape[1], device=x0.device)
    h = x0
    p = params["layers"]
    for i in range(cfg.n_layers):
        h = sharding.constrain(h, ax.dp, ax.mp(h.shape[1]), None)
        y, _ = mamba2.remat_block(p, i, h, cfg, ax)
        h = h + sharding.gather_grad(y, 1)
        if _is_shared_layer(i, cfg):
            if cfg.remat:
                h, _ = checkpoint(_shared_block, params["shared"], h, x0, cfg,
                                  ax, positions, use_reentrant=False)
            else:
                h, _ = _shared_block(params["shared"], h, x0, cfg, ax,
                                     positions)
    return sharding.gather(L.rms_norm(h, params["ln_f"]), 1)


def loss_fn(params, batch, cfg: ModelConfig, ax):
    h = _hidden(params, batch, cfg, ax)
    w = L.unembed_weight(params, cfg).to(h.dtype)
    return L.chunked_softmax_xent(h, w, batch["labels"], cfg.vocab)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device):
    dtype = L.dtype_of(dtype) if isinstance(dtype, str) else dtype
    m = mamba2.init_cache(cfg, batch, dtype, device)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    ns = n_shared_invocations(cfg)
    zeros = lambda: torch.zeros(shape, dtype=dtype, device=device)
    m["attn_k"] = [zeros() for _ in range(ns)]
    m["attn_v"] = [zeros() for _ in range(ns)]
    return m


def abstract_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype):
    """The cache on the meta device."""
    return init_cache(cfg, batch, cache_len, dtype, "meta")


def prefill(params, batch, cfg: ModelConfig, ax, cache_len: int | None = None):
    dtype = L.dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    bsz, s = tokens.shape
    cache_len = cache_len or s
    x0 = L.embed_tokens(params, tokens, cfg, dtype)
    cache = init_cache(cfg, bsz, cache_len, dtype, x0.device)
    positions = torch.arange(s, device=x0.device)
    h = x0
    p = params["layers"]
    si = 0
    for i in range(cfg.n_layers):
        h = sharding.constrain(h, ax.dp, ax.mp(h.shape[1]), None)
        y, h_final = mamba2.block(p, i, h, cfg, ax)
        cache["conv"][i] = mamba2.conv_tail(p, i, h, s, cfg)
        cache["ssm"][i] = h_final
        h = h + y
        if _is_shared_layer(i, cfg):
            h, (k, v) = _shared_block(params["shared"], h, x0, cfg, ax,
                                      positions)
            cache["attn_k"][si] = L.pad_seq(k, cache_len)
            cache["attn_v"][si] = L.pad_seq(v, cache_len)
            si += 1
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=h.device)
    h = sharding.gather(L.rms_norm(h, params["ln_f"]), 1)
    logits = L.logits_fn(params, h[:, -1:], cfg)[:, 0]
    return logits, cache


def decode_step(params, cache, batch, cfg: ModelConfig, ax):
    """One token for every sequence; returns (logits [B, V], a new cache;
    the given one is not modified)."""
    dtype = L.dtype_of(cfg.dtype)
    cache = {"conv": list(cache["conv"]), "ssm": list(cache["ssm"]),
             "attn_k": list(cache["attn_k"]),
             "attn_v": list(cache["attn_v"]), "pos": cache["pos"]}
    pos = cache["pos"]
    tok = batch["tokens"]
    x0 = L.embed_tokens(params, tok[:, None], cfg, dtype)     # [B, 1, d]
    h = x0[:, 0]
    p = params["layers"]
    si = 0
    for i in range(cfg.n_layers):
        y, conv_s, ssm_s = mamba2.block_decode(
            p, i, h, cache["conv"][i], cache["ssm"][i], cfg, ax)
        cache["conv"][i] = conv_s
        cache["ssm"][i] = ssm_s
        h = h + y
        if _is_shared_layer(i, cfg):
            h2, (kc, vc) = _shared_block(
                params["shared"], h[:, None], x0, cfg, ax, pos[None],
                kv_cache=(cache["attn_k"][si], cache["attn_v"][si]), pos=pos)
            cache["attn_k"][si] = kc
            cache["attn_v"][si] = vc
            h = h2[:, 0]
            si += 1
    cache["pos"] = pos + 1
    h = L.rms_norm(h, params["ln_f"])
    logits = L.logits_fn(params, h[:, None], cfg)[:, 0]
    return logits, cache
