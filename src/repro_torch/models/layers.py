"""Shared neural-net building blocks (plain torch functions on nested dicts
of tensors).

Conventions, as in the JAX package's `models/layers.py`:
  * params are nested dicts of tensors; per-layer weights are stacked on a
    leading L axis and indexed with python ints (layers are unrolled);
  * attention is blocked-causal: a python loop over query chunks, each
    materializing one [B, KH, G, qc, kv_len] logits tile in float32.

The casts are the JAX package's: every weight is cast to the activation
dtype before its product, logits and softmax run in float32, and the
attention output goes back to the query's dtype.  No `torch.autocast`,
whose cast points differ.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30     # the mask fill before every softmax


def dtype_of(name: str) -> torch.dtype:
    """"float32" / "bfloat16" (a config's dtype string) -> torch dtype."""
    return getattr(torch, name)


def trunc_normal(gen, shape, std, dtype, device):
    """std * N(0, 1) truncated to [-2, 2] (in units of std), drawn in float32
    from `gen`.  Not the JAX package's draws: port tests load JAX's
    parameters through `interop.params_from_np`."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                                generator=gen)
    return t.to(dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] or [S] int.  Split halves:
    (x1, x2) = the first and second half of hd."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta).astype(np.float32)) \
        .to(x.device)
    ang = positions.float()[..., None] * freqs                 # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                         # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _gqa_logits(q, k, scale):
    """q: [B, Sq, KH, G, hd], k: [B, Sk, KH, hd] -> [B, KH, G, Sq, Sk] f32
    (JAX's preferred_element_type=float32: float32 products of the
    activation-dtype values)."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale


def _gqa_out(probs, v):
    """probs: [B, KH, G, Sq, Sk], v: [B, Sk, KH, hd] -> [B, Sq, KH, G, hd]."""
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(probs.dtype))


def blocked_attention(q, k, v, cfg: ModelConfig, ax: sharding.AxisEnv,
                      causal: bool, q_start: int = 0):
    """Blocked (causal) attention.

    q: [B, Sq, H, hd]; k, v: [B, Sk, KH, hd].  Returns [B, Sq, H, hd].
    Python loop over query chunks of cfg.attn_chunk; for causal attention
    each chunk only reads k/v up to its last row.

    On DTensors it runs per (batch, head) shard under `local_map`, on the
    layout `attn_qkv` constrains q/k/v to: batch over dp, heads over
    'model' when both H and KH divide by its size (else heads replicated,
    so that every shard keeps whole GQA groups).  No value crosses a shard
    in attention, and the shard bodies are the one-card code.
    """
    if sharding.is_dtensor(q):
        shard_heads = ax.mp(q.shape[2]) is not None and \
            ax.mp(k.shape[2]) is not None
        mp = ax.model if shard_heads else None
        pl = sharding.placements((ax.dp, None, mp, None), q.device_mesh)
        body = lambda q, k, v: _blocked_attention(q, k, v, cfg, causal,
                                                  q_start)
        return sharding.local_map(body, q.device_mesh, (pl, pl, pl),
                                  pl)(q, k, v)
    return _blocked_attention(*sharding.contiguous_grads(q, k, v), cfg,
                              causal, q_start)


def _blocked_attention(q, k, v, cfg: ModelConfig, causal: bool,
                       q_start: int = 0):
    """blocked_attention on plain tensors."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kh, g, hd)
    chunk = min(cfg.attn_chunk, sq)
    n_chunks = -(-sq // chunk)
    outs = []
    for ci in range(n_chunks):
        s0 = ci * chunk
        s1 = min(sq, s0 + chunk)
        qc = qg[:, s0:s1]
        kv_end = (q_start + s1) if causal else k.shape[1]
        kc, vc = k[:, :kv_end], v[:, :kv_end]
        logits = _gqa_logits(qc, kc, scale)        # [B, KH, G, qc, kv_end]
        if causal:
            q_pos = q_start + torch.arange(s0, s1, device=q.device)
            k_pos = torch.arange(kv_end, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        oc = _gqa_out(probs, vc)                   # [B, qc, KH, G, hd]
        outs.append(oc.to(q.dtype))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(b, sq, h, hd)


def pad_seq(kv, cache_len: int):
    """A prompt's k or v [B, S, KH, hd] as a cache of cache_len rows, the
    tail zero (a new tensor, so DTensor propagates its placement; the JAX
    package writes the prompt into a zero cache)."""
    return F.pad(kv, (0, 0, 0, 0, 0, cache_len - kv.shape[1]))


def cache_write(cache, new, pos):
    """The cache [B, S, ...] with row `pos` (a 0-d int tensor) of dim 1
    replaced by new [B, 1, ...]: a new tensor, the values copied exactly.
    A select by mask rather than `index_copy`, which DTensor has no
    sharding rule for on torch 2.11."""
    rows = torch.arange(cache.shape[1], device=cache.device) == pos
    return torch.where(rows.reshape(1, -1, *(1,) * (cache.dim() - 2)), new,
                       cache)


def decode_attention(q, k_cache, v_cache, pos):
    """Single-token attention against a cache.

    q: [B, H, hd]; k_cache/v_cache: [B, S, KH, hd]; pos: 0-d int tensor
    (the new token's position).  Masked full-cache read.
    """
    b, h, hd = q.shape
    kh = k_cache.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(hd)
    qg = sharding.whole_blocks(q, 1, kh).reshape(b, kh, g, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          k_cache.float()) * scale
    s = k_cache.shape[1]
    mask = torch.arange(s, device=q.device) <= pos
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.to(probs.dtype))
    return out.reshape(b, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# attention block params / apply
# ---------------------------------------------------------------------------


def init_attn(gen, cfg: ModelConfig, n_layers: int, device,
              d_in: int | None = None):
    d = d_in or cfg.d_model
    hd = cfg.hd
    std = 0.02
    dt = dtype_of(cfg.param_dtype)
    p = {
        "wq": trunc_normal(gen, (n_layers, d, cfg.n_heads * hd), std, dt,
                           device),
        "wk": trunc_normal(gen, (n_layers, d, cfg.n_kv_heads * hd), std, dt,
                           device),
        "wv": trunc_normal(gen, (n_layers, d, cfg.n_kv_heads * hd), std, dt,
                           device),
        "wo": trunc_normal(gen, (n_layers, cfg.n_heads * hd, cfg.d_model),
                           std / math.sqrt(2 * cfg.n_layers), dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n_layers, cfg.n_heads * hd), dtype=dt,
                              device=device)
        p["bk"] = torch.zeros((n_layers, cfg.n_kv_heads * hd), dtype=dt,
                              device=device)
        p["bv"] = torch.zeros((n_layers, cfg.n_kv_heads * hd), dtype=dt,
                              device=device)
    return p


def attn_qkv(p, i, x, cfg: ModelConfig, ax: sharding.AxisEnv, positions):
    """x: [B, S, d_in] -> q [B,S,H,hd], k/v [B,S,KH,hd] (RoPE applied)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"][i].to(x.dtype)
    k = x @ p["wk"][i].to(x.dtype)
    v = x @ p["wv"][i].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"][i].to(x.dtype)
        k = k + p["bk"][i].to(x.dtype)
        v = v + p["bv"][i].to(x.dtype)
    q = sharding.whole_blocks(q, -1, cfg.n_heads).reshape(b, s, cfg.n_heads,
                                                          hd)
    k = sharding.whole_blocks(k, -1, cfg.n_kv_heads).reshape(
        b, s, cfg.n_kv_heads, hd)
    v = sharding.whole_blocks(v, -1, cfg.n_kv_heads).reshape(
        b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = sharding.constrain(q, *_qspec(ax, cfg.n_heads))
    k = sharding.constrain(k, *_kvspec(ax, cfg.n_kv_heads))
    v = sharding.constrain(v, *_kvspec(ax, cfg.n_kv_heads))
    return q, k, v


def _qspec(ax: sharding.AxisEnv, h):
    return (ax.dp, None, ax.mp(h), None)


def _kvspec(ax: sharding.AxisEnv, kh):
    return (ax.dp, None, ax.mp(kh), None)


def attn_out(p, i, o, x_dtype):
    """o: [B, S, H, hd] -> [B, S, d_model]."""
    b, s = o.shape[:2]
    return o.reshape(b, s, -1) @ p["wo"][i].to(x_dtype)


# ---------------------------------------------------------------------------
# MLP: SwiGLU (3 mats) or tanh-GELU (2 mats)
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, n_layers: int, device):
    d = cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    p = {}
    if cfg.mlp_gated:
        p["w_gate"] = trunc_normal(gen, (n_layers, d, cfg.d_ff), 0.02, dt,
                                   device)
    p["w_up"] = trunc_normal(gen, (n_layers, d, cfg.d_ff), 0.02, dt, device)
    p["w_down"] = trunc_normal(gen, (n_layers, cfg.d_ff, cfg.d_model),
                               0.02 / math.sqrt(2 * cfg.n_layers), dt, device)
    return p


def mlp(p, i, x):
    u = x @ p["w_up"][i].to(x.dtype)
    if "w_gate" in p:
        g = x @ p["w_gate"][i].to(x.dtype)
        h = F.silu(g) * u
    else:
        h = F.gelu(u, approximate="tanh")     # jax.nn.gelu's default
    return h @ p["w_down"][i].to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / logits / loss
# ---------------------------------------------------------------------------


def init_embed(gen, cfg: ModelConfig, device):
    dt = dtype_of(cfg.param_dtype)
    p = {"embed": trunc_normal(gen, (cfg.vocab_padded, cfg.d_model), 0.02, dt,
                               device)}
    if not cfg.tie_embeddings:
        p["unembed"] = trunc_normal(gen, (cfg.d_model, cfg.vocab_padded),
                                    0.02, dt, device)
    return p


def embed_tokens(p, tokens, cfg: ModelConfig, dtype):
    """Rows of the table in `dtype`: look up first, then cast (the JAX
    package casts the whole table first; the values are the same).
    `F.embedding` rather than indexing: DTensor places its lookup on a
    vocab-sharded table, and torch 2.11's DTensor fails the index's
    backward on a batch-sharded index.  Its masked partial sum is reduced
    at once: DTensor keeps one mask for it, so a second reduction of the
    same tensor (rms_norm reads it twice) would find none."""
    x = sharding.reduce_partial(F.embedding(tokens.long(), p["embed"]))
    return x.to(dtype)


def unembed_weight(p, cfg: ModelConfig):
    return p["embed"].T if cfg.tie_embeddings else p["unembed"]


def logits_fn(p, x, cfg: ModelConfig):
    return x @ unembed_weight(p, cfg).to(x.dtype)


def _xent_sums(logits, labels, vocab_real: int):
    """(sum of masked NLL, count of valid positions) for one chunk.  The
    padded vocab tail is masked out of the partition function."""
    logits = logits.float()
    v = logits.shape[-1]
    if vocab_real < v:
        tail = torch.arange(v, device=logits.device) >= vocab_real
        logits = logits.masked_fill(tail, NEG_INF)
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    labels = labels.long()
    valid = labels >= 0
    idx = labels.clamp(min=0)[..., None]
    if sharding.is_dtensor(logits):
        # on a mesh the label logit is a sum over the vocab with one
        # nonzero term, which is exact and gathers no vocab shard: DTensor
        # may place a gather on vocab shards, and its masked-partial
        # reduction fails on a [B, S, 1] index
        vocab = torch.arange(v, device=logits.device)
        label_logit = torch.where(vocab == idx, logits, 0.0).sum(-1)
    else:
        label_logit = torch.gather(logits, -1, idx)[..., 0]
    nll = (lse - label_logit) * valid
    return torch.sum(nll), torch.sum(valid)


def chunked_softmax_xent(hidden, unembed_w, labels, vocab_real: int,
                         chunk: int = 512):
    """Cross entropy over static chunks of S, so the live float32 logits are
    [B, chunk, V] instead of [B, S, V].

    hidden: [B, S, d]; unembed_w: [d, V] in hidden's dtype.
    """
    s = hidden.shape[1]
    chunk = min(chunk, s)
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    valid = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for s0 in range(0, s, chunk):
        s1 = min(s, s0 + chunk)
        lg = hidden[:, s0:s1] @ unembed_w
        dn, dv = _xent_sums(lg, labels[:, s0:s1], vocab_real)
        nll = nll + dn
        valid = valid + dv
    return nll / valid.clamp(min=1)
