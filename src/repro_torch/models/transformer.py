"""Decoder/encoder transformer backbones: dense, MoE, encoder-only (HuBERT),
and VLM (phi-3-vision with stubbed patch frontend).

The layer loop is a python loop over per-layer weights stacked on a
leading L axis.  cfg.remat wraps each layer in
`torch.utils.checkpoint.checkpoint(use_reentrant=False)` (the JAX
package's jax.checkpoint with no saving policy): memory only, the values
are the same.  torch.func's grad/jvp transforms refuse checkpoint's
saved-tensor hooks, so a caller that differentiates under torch.func (the
sensitivity maps) passes a config with remat off.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(cfg: ModelConfig, gen: torch.Generator | None, device):
    """Parameters drawn from `gen` on `device`; on the meta device (no
    storage, `gen` unused) they give the shapes alone."""
    dt = L.dtype_of(cfg.param_dtype)
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    p = {}
    if cfg.vocab:
        p.update(L.init_embed(gen, cfg, device))
    blk = {
        "ln1": ones(cfg.n_layers, cfg.d_model),
        "ln2": ones(cfg.n_layers, cfg.d_model),
        **L.init_attn(gen, cfg, cfg.n_layers, device),
    }
    if cfg.family == "moe":
        blk.update(moe_mod.init(gen, cfg, cfg.n_layers, device))
    else:
        blk.update(L.init_mlp(gen, cfg, cfg.n_layers, device))
    p["layers"] = blk
    p["ln_f"] = ones(cfg.d_model)
    if cfg.family == "vlm":
        p["patch_proj"] = L.trunc_normal(gen, (cfg.patch_dim, cfg.d_model),
                                         0.02, dt, device)
    if cfg.family == "encoder":
        p["frame_proj"] = L.trunc_normal(gen, (cfg.frame_dim, cfg.d_model),
                                         0.02, dt, device)
    return p


def init_abstract(cfg: ModelConfig):
    """The parameter tree on the meta device."""
    return init(cfg, None, "meta")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _layer(p, i, x, cfg: ModelConfig, ax, positions, causal: bool):
    h = sharding.gather(L.rms_norm(x, p["ln1"][i]), 1)
    q, k, v = L.attn_qkv(p, i, h, cfg, ax, positions)
    o = L.blocked_attention(q, k, v, cfg, ax, causal=causal)
    x = x + sharding.gather_grad(L.attn_out(p, i, o, x.dtype), 1)
    h = sharding.gather(L.rms_norm(x, p["ln2"][i]), 1)
    if cfg.family == "moe":
        y, aux = moe_mod.moe_ffn(p, i, h, cfg, ax)
    else:
        y, aux = L.mlp(p, i, h), 0.0
    return x + sharding.gather_grad(y, 1), aux


def backbone(params, x, cfg: ModelConfig, ax, positions, causal=None):
    """x: [B, S, d] -> (hidden [B, S, d], aux_loss)."""
    causal = cfg.is_causal if causal is None else causal
    p = params["layers"]
    aux_total = 0.0
    for i in range(cfg.n_layers):
        x = sharding.constrain(x, ax.dp, ax.mp(x.shape[1]), None)
        if cfg.remat:
            x, aux = checkpoint(_layer, p, i, x, cfg, ax, positions, causal,
                                use_reentrant=False)
        else:
            x, aux = _layer(p, i, x, cfg, ax, positions, causal)
        aux_total = aux_total + aux
    return sharding.gather(L.rms_norm(x, params["ln_f"]), 1), aux_total


def _inputs_to_hidden(params, batch, cfg: ModelConfig, dtype):
    """Family-specific input embedding. Returns (x [B,S,d], positions [S])."""
    if cfg.family == "encoder":
        x = batch["frames"].to(dtype) @ params["frame_proj"].to(dtype)
        return x, torch.arange(x.shape[1], device=x.device)
    if cfg.family == "vlm":
        tok = L.embed_tokens(params, batch["tokens"], cfg, dtype)
        img = batch["patches"].to(dtype) @ params["patch_proj"].to(dtype)
        x = torch.cat([img, tok], dim=1)
        return x, torch.arange(x.shape[1], device=x.device)
    x = L.embed_tokens(params, batch["tokens"], cfg, dtype)
    return x, torch.arange(x.shape[1], device=x.device)


def forward_logits(params, batch, cfg: ModelConfig, ax):
    """Full-sequence logits [B, S(, V)] (+ MoE aux loss)."""
    dtype = L.dtype_of(cfg.dtype)
    x, positions = _inputs_to_hidden(params, batch, cfg, dtype)
    h, aux = backbone(params, x, cfg, ax, positions)
    if cfg.family == "vlm":
        h = h[:, cfg.n_patches:]          # loss on text positions only
    return L.logits_fn(params, h, cfg), aux


def loss_fn(params, batch, cfg: ModelConfig, ax):
    dtype = L.dtype_of(cfg.dtype)
    x, positions = _inputs_to_hidden(params, batch, cfg, dtype)
    h, aux = backbone(params, x, cfg, ax, positions)
    if cfg.family == "vlm":
        h = h[:, cfg.n_patches:]
    labels = batch.get("labels", batch.get("targets"))
    w = L.unembed_weight(params, cfg).to(h.dtype)
    return L.chunked_softmax_xent(h, w, labels, cfg.vocab) + 0.01 * aux


# ---------------------------------------------------------------------------
# serving: prefill + KV-cache decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               device):
    """Per-layer list of buffers (not stacked: a stacked [L, ...] cache
    makes every layer's update copy the whole cache)."""
    dtype = L.dtype_of(dtype) if isinstance(dtype, str) else dtype
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    zeros = lambda: torch.zeros(shape, dtype=dtype, device=device)
    return {"k": [zeros() for _ in range(cfg.n_layers)],
            "v": [zeros() for _ in range(cfg.n_layers)],
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype):
    """The cache on the meta device."""
    return init_cache(cfg, batch, cache_len, dtype, "meta")


def _ffn(p, i, h, cfg: ModelConfig, ax):
    if cfg.family == "moe":
        return moe_mod.moe_ffn(p, i, h, cfg, ax)[0]
    return L.mlp(p, i, h)


def prefill(params, batch, cfg: ModelConfig, ax, cache_len: int | None = None):
    """Full forward over the prompt; returns (last-token logits, cache)."""
    dtype = L.dtype_of(cfg.dtype)
    x, positions = _inputs_to_hidden(params, batch, cfg, dtype)
    b, s, _ = x.shape
    cache_len = cache_len or s
    cache = {"k": [], "v": []}
    p = params["layers"]
    for i in range(cfg.n_layers):
        x = sharding.constrain(x, ax.dp, ax.mp(x.shape[1]), None)
        h = sharding.gather(L.rms_norm(x, p["ln1"][i]), 1)
        q, k, v = L.attn_qkv(p, i, h, cfg, ax, positions)
        o = L.blocked_attention(q, k, v, cfg, ax, causal=cfg.is_causal)
        x = x + L.attn_out(p, i, o, x.dtype)
        cache["k"].append(L.pad_seq(k, cache_len))
        cache["v"].append(L.pad_seq(v, cache_len))
        x = x + _ffn(p, i, sharding.gather(L.rms_norm(x, p["ln2"][i]), 1),
                     cfg, ax)
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    h = sharding.gather(L.rms_norm(x, params["ln_f"]), 1)
    logits = L.logits_fn(params, h[:, -1:], cfg)[:, 0]
    return logits, cache


def decode_step(params, cache, batch, cfg: ModelConfig, ax):
    """One token for every sequence in the batch.

    batch: {"tokens": int[B]}; cache["pos"] 0-d int32 = write position.
    Returns (logits [B, V], a new cache; the given one is not modified).
    """
    dtype = L.dtype_of(cfg.dtype)
    cache = {"k": list(cache["k"]), "v": list(cache["v"]),
             "pos": cache["pos"]}
    pos = cache["pos"]
    tok = batch["tokens"]
    x = L.embed_tokens(params, tok[:, None], cfg, dtype)      # [B, 1, d]
    p = params["layers"]
    positions = pos[None]
    for i in range(cfg.n_layers):
        h = L.rms_norm(x, p["ln1"][i])
        q, k, v = L.attn_qkv(p, i, h, cfg, ax, positions)
        kc = L.cache_write(cache["k"][i], k, pos)
        vc = L.cache_write(cache["v"][i], v, pos)
        cache["k"][i] = kc
        cache["v"][i] = vc
        o = L.decode_attention(q[:, 0], kc, vc, pos)
        x = x + L.attn_out(p, i, o[:, None], x.dtype)
        x = x + _ffn(p, i, L.rms_norm(x, p["ln2"][i]), cfg, ax)
    cache["pos"] = pos + 1
    h = L.rms_norm(x, params["ln_f"])
    logits = L.logits_fn(params, h, cfg)[:, 0]
    return logits, cache
