"""Mamba-2 (SSD, state-space duality — arXiv:2405.21060), the JAX
package's `models/mamba2.py`.

Training and prefill use the chunked SSD algorithm: an intra-chunk
quadratic term (einsums) and the inter-chunk linear recurrence
H_n = a_n H_{n-1} + S_n over the chunk axis.  JAX runs the recurrence as
`jax.lax.associative_scan`; PyTorch has no such scan, so here it is a loop
over the S / chunk chunks (2 at S = 512, chunk 256): the same recurrence,
its float sums in another order.  Decode is the O(1) recurrent update.

Projections are separate weights (z/x/B/C/dt), as in JAX, and the
`sharding.constrain` calls (the identity here) sit where JAX's do.  The SSD
scan (`ssd_chunked`) runs on CUDA tensors as hand-written kernels
(`kernels/ssd.py`, which JAX has no counterpart of: it computes the scan
with einsums), on any other tensor as the plain torch ops of
`ssd_chunked_plain`; the causal conv is plain torch ops.  cfg.remat wraps
each block in
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`; torch.func
refuses it, so a sensitivity loss runs with remat off (models/transformer).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.kernels import ssd as _ssd_kernels
from repro_torch.models import layers as L
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig


def init(gen, cfg: ModelConfig, n_layers: int, device):
    """Stacked [n_layers, ...] block parameters drawn from `gen` (on the
    meta device: shapes only)."""
    dt = L.dtype_of(cfg.param_dtype)
    d, din, st, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    g = cfg.ssm_groups
    w = cfg.conv_width
    tn = lambda shape, std: L.trunc_normal(gen, shape, std, dt, device)
    # dt bias so softplus(dt) spans ~[1e-3, 1e-1] at init (mamba2 default)
    u = torch.empty((n_layers, nh), dtype=torch.float32, device=device)
    u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
    dt_init = torch.log(torch.expm1(torch.exp(u)))
    a_log = torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                   device=device))
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    return {
        "in_z": tn((n_layers, d, din), 0.02),
        "in_x": tn((n_layers, d, din), 0.02),
        "in_B": tn((n_layers, d, g * st), 0.02),
        "in_C": tn((n_layers, d, g * st), 0.02),
        "in_dt": tn((n_layers, d, nh), 0.02),
        "conv_x": tn((n_layers, w, din), 0.2),
        "conv_B": tn((n_layers, w, g * st), 0.2),
        "conv_C": tn((n_layers, w, g * st), 0.2),
        "A_log": a_log[None].expand(n_layers, nh).to(dt).clone(),
        "D": ones(n_layers, nh),
        "dt_bias": dt_init.to(dt),
        "norm": ones(n_layers, din),
        "ln": ones(n_layers, d),     # pre-norm
        "out_proj": tn((n_layers, din, d), 0.02 / math.sqrt(2 * n_layers)),
    }


def causal_conv(x, kernel):
    """Depthwise causal conv. x: [B, S, ch], kernel: [w, ch]."""
    w = kernel.shape[0]
    pad = F.pad(x, (0, 0, w - 1, 0))
    s = x.shape[1]
    out = sum(pad[:, j:j + s] * kernel[j].to(x.dtype) for j in range(w))
    return F.silu(out)


def _gated_norm(y, scale, z):
    return L.rms_norm(y * F.silu(z), scale)


def _softplus(x):
    """jax.nn.softplus: log(1 + exp(x)) without torch's linear cut-off."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ---------------------------------------------------------------------------
# chunked SSD
# ---------------------------------------------------------------------------


def ssd_chunked(x, dtv, a, b, c, chunk: int, h0=None):
    """SSD over a full sequence (`ssd_chunked_plain`'s arguments and
    results), on the device's path: CUDA tensors through the kernels of
    `kernels/ssd.py` (which raise on a shape they do not take), under
    autograd and under the sensitivity maps' torch.func grad and jvp alike;
    any other tensor (CPU, or `meta` in the dry-run) through
    `ssd_chunked_plain`.  The span `model.ssd_fwd` times the forward on
    either path (`model.ssd_bwd` the kernels' backward)."""
    with obs.span("model.ssd_fwd", device=True):
        if x.device.type == "cuda":
            return _ssd_kernels.ssd(x, dtv, a, b, c, chunk, h0)
        return ssd_chunked_plain(x, dtv, a, b, c, chunk, h0)


def ssd_chunked_plain(x, dtv, a, b, c, chunk: int, h0=None):
    """SSD over a full sequence, as plain torch ops.

    x:   [B, S, nh, hd]   (conv'd, activated)
    dtv: [B, S, nh]       (softplus'd timestep)
    a:   [nh]             (negative decay rates)
    b,c: [B, S, st]       (single group, broadcast over heads)
    h0:  optional initial state [B, nh, hd, st]
    Returns (y [B, S, nh, hd], h_final [B, nh, hd, st]).

    With h0 the first chunk's outputs read it (C_q exp(cum_q) . h0), as the
    recurrence says; the JAX package's first chunk reads zeros there and
    only its final state carries h0 (no caller of either passes h0).
    It computes in float32, or in float64 for float64 inputs (the kernels'
    tests' reference).
    """
    bsz, s, nh, hd = x.shape
    st = b.shape[-1]
    q = min(chunk, s)
    n = s // q
    if n * q != s:
        raise ValueError(f"sequence {s} is not a multiple of chunk {q}")
    f32 = torch.promote_types(x.dtype, torch.float32)
    xc = x.reshape(bsz, n, q, nh, hd)
    dtc = dtv.reshape(bsz, n, q, nh).to(f32)
    bc = b.reshape(bsz, n, q, st).to(f32)
    cc = c.reshape(bsz, n, q, st).to(f32)
    da = dtc * a.to(f32)                              # [B, n, q, nh]
    cum = torch.cumsum(da, dim=2)                     # within-chunk cumulative
    # intra-chunk: Y[q'] = sum_{s'<=q'} C_q'.B_s' exp(cum_q'-cum_s') dt_s' x_s'
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,n,q,q,nh]
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: masked entries are positive and would overflow to inf,
    # poisoning gradients through the where.
    seg = torch.where(causal[None, None, :, :, None], seg, -math.inf)
    decay = torch.exp(seg)
    cb = torch.einsum("bnqt,bnst->bnqs", cc, bc)      # [B,n,q,q]
    m = cb[..., None] * decay                         # [B,n,q,q,nh]
    xdt = xc.to(f32) * dtc[..., None]                 # [B,n,q,nh,hd]
    y_intra = torch.einsum("bnqsh,bnshd->bnqhd", m, xdt)
    # chunk states: S_n = sum_q exp(cum_end - cum_q) dt_q B_q (x) x_q
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)    # [B,n,q,nh]
    states = torch.einsum("bnqh,bnqt,bnqhd->bnhdt", decay_out, bc, xdt)
    # inter-chunk recurrence H_n = a_n H_{n-1} + S_n, one step a chunk
    a_chunk = torch.exp(cum[:, :, -1, :])             # [B,n,nh]
    h = torch.zeros_like(states[:, 0]) if h0 is None else h0.to(f32)
    h_before = []
    for i in range(n):
        h_before.append(h)
        h = a_chunk[:, i][..., None, None] * h + states[:, i]
    h_before = torch.stack(h_before, dim=1)           # [B,n,nh,hd,st]
    # inter-chunk contribution: Y[q] = C_q exp(cum_q) . H_before
    y_inter = torch.einsum("bnqt,bnhdt,bnqh->bnqhd",
                           cc, h_before, torch.exp(cum))
    y = (y_intra + y_inter).reshape(bsz, s, nh, hd).to(x.dtype)
    return y, h.to(x.dtype)


# ---------------------------------------------------------------------------
# block forward / decode
# ---------------------------------------------------------------------------


def _in_proj(p, i, u, dtp):
    """The pre-conv projections of the pre-normed input u [..., d]."""
    return (u @ p["in_x"][i].to(dtp), u @ p["in_B"][i].to(dtp),
            u @ p["in_C"][i].to(dtp))


def block(p, i, u, cfg: ModelConfig, ax):
    """Full-sequence mamba2 block. u: [B, S, d] -> (y [B, S, d], state).

    The constrain calls mark JAX's sharding discipline: one seq all-gather
    at entry; z/x/dt inherit the 'model' shard from their projection
    out-dims; B/C stay replicated over 'model'."""
    dtp = u.dtype
    u = sharding.constrain(u, ax.dp, None, None)    # single AG from SP shard
    u = L.rms_norm(u, p["ln"][i])
    z = u @ p["in_z"][i].to(dtp)
    x, b_, c_ = _in_proj(p, i, u, dtp)
    dt_raw = u @ p["in_dt"][i].to(dtp)
    b_ = sharding.constrain(b_, ax.dp, None, None)
    c_ = sharding.constrain(c_, ax.dp, None, None)
    dt_raw = sharding.constrain(dt_raw, ax.dp, None, ax.mp(cfg.ssm_heads))
    x = causal_conv(x, p["conv_x"][i])
    b_ = causal_conv(b_, p["conv_B"][i])
    c_ = causal_conv(c_, p["conv_C"][i])
    dtv = _softplus(dt_raw.float() + p["dt_bias"][i].float())
    a = -torch.exp(p["A_log"][i].float())
    bsz, s, din = x.shape
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    # pad S to a chunk multiple; padded steps use dt=0 (decay 1, zero input)
    # so they neither contribute nor disturb the final state.
    pad = (-s) % min(cfg.ssm_chunk, max(s, 1))
    if pad:
        x, dtv, b_, c_ = (F.pad(t, (0, 0, 0, pad)) for t in (x, dtv, b_, c_))
    xh = x.reshape(bsz, s + pad, nh, hd)
    xh = sharding.constrain(xh, ax.dp, None, ax.mp(nh), None)
    y, h_final = _ssd(xh, dtv, a, b_, c_, cfg, ax)
    if pad:
        y = y[:, :s]
        xh = xh[:, :s]
    y = y + p["D"][i].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(bsz, s, din)
    y = _gated_norm(y, p["norm"][i], z)
    out = y @ p["out_proj"][i].to(dtp)
    return out, h_final


def _ssd(xh, dtv, a, b, c, cfg: ModelConfig, ax):
    """ssd_chunked; on DTensors per (batch, head) shard under `local_map`
    on the layout `block` constrains xh to (batch over dp, heads over
    'model'): the scan never mixes heads or sequences, and B/C are
    replicated over 'model'."""
    if not sharding.is_dtensor(xh):
        return ssd_chunked(*sharding.contiguous_grads(xh, dtv, a, b, c),
                           cfg.ssm_chunk)
    dp, mp = ax.dp, ax.mp(xh.shape[2])
    pl = lambda *spec: sharding.placements(spec, xh.device_mesh)
    return sharding.local_map(
        lambda *t: ssd_chunked(*t, cfg.ssm_chunk), xh.device_mesh,
        (pl(dp, None, mp, None), pl(dp, None, mp), pl(mp),
         pl(dp, None, None), pl(dp, None, None)),
        (pl(dp, None, mp, None), pl(dp, mp, None, None)),
    )(xh, dtv, a, b, c)


def block_decode(p, i, u, conv_state, ssm_state, cfg: ModelConfig, ax):
    """Single-token recurrent update.

    u: [B, d]; conv_state: [B, w-1, din + 2*g*st]; ssm_state: [B, nh, hd, st].
    Returns (y [B, d], conv_state, ssm_state).
    """
    dtp = u.dtype
    din, st, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    u = L.rms_norm(u, p["ln"][i])
    z = u @ p["in_z"][i].to(dtp)
    x, b_, c_ = _in_proj(p, i, u, dtp)
    dt_raw = u @ p["in_dt"][i].to(dtp)
    xbc = torch.cat([x, b_, c_], dim=-1)                       # [B, din+2gst]
    window = torch.cat([conv_state, xbc[:, None]], dim=1)      # [B, w, ch]
    kernel = torch.cat([p["conv_x"][i], p["conv_B"][i], p["conv_C"][i]],
                       dim=-1)
    conv_out = F.silu(torch.sum(window * kernel.to(dtp)[None], dim=1))
    x = conv_out[:, :din]
    b_ = conv_out[:, din:din + g * st]
    c_ = conv_out[:, din + g * st:]
    new_conv_state = window[:, 1:]
    dtv = _softplus(dt_raw.float() + p["dt_bias"][i].float())  # [B, nh]
    a = -torch.exp(p["A_log"][i].float())
    da = torch.exp(dtv * a)                                    # [B, nh]
    xh = x.reshape(-1, nh, hd).float()
    ssm_state = ssm_state.float() * da[..., None, None] \
        + torch.einsum("bh,bt,bhd->bhdt", dtv, b_.float(), xh)
    ssm_state = sharding.constrain(
        ssm_state, *sharding.ssm_state_spec(ax, ssm_state.shape[0], nh))
    y = torch.einsum("bhdt,bt->bhd", ssm_state, c_.float())
    y = y + p["D"][i].float()[None, :, None] * xh
    y = y.reshape(-1, din).to(dtp)
    y = _gated_norm(y, p["norm"][i], z)
    out = y @ p["out_proj"][i].to(dtp)
    return out, new_conv_state, ssm_state.to(dtp)


def remat_block(p, i, u, cfg: ModelConfig, ax):
    """`block` under cfg.remat's checkpoint (jax.checkpoint in JAX)."""
    if cfg.remat:
        return checkpoint(block, p, i, u, cfg, ax, use_reentrant=False)
    return block(p, i, u, cfg, ax)


# ---------------------------------------------------------------------------
# full model (ssm family)
# ---------------------------------------------------------------------------


def init_model(cfg: ModelConfig, gen, device):
    dt = L.dtype_of(cfg.param_dtype)
    p = L.init_embed(gen, cfg, device)
    p["layers"] = init(gen, cfg, cfg.n_layers, device)
    p["ln_f"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    return p


def init_abstract(cfg: ModelConfig):
    """The parameter tree on the meta device."""
    return init_model(cfg, None, "meta")


def _backbone(params, x, cfg: ModelConfig, ax):
    p = params["layers"]
    for i in range(cfg.n_layers):
        x = sharding.constrain(x, ax.dp, ax.mp(x.shape[1]), None)
        y, _ = remat_block(p, i, x, cfg, ax)
        x = x + sharding.gather_grad(y, 1)
    return sharding.gather(L.rms_norm(x, params["ln_f"]), 1)


def forward_logits(params, batch, cfg: ModelConfig, ax):
    dtype = L.dtype_of(cfg.dtype)
    x = L.embed_tokens(params, batch["tokens"], cfg, dtype)
    h = _backbone(params, x, cfg, ax)
    return L.logits_fn(params, h, cfg), 0.0


def loss_fn(params, batch, cfg: ModelConfig, ax):
    dtype = L.dtype_of(cfg.dtype)
    x = L.embed_tokens(params, batch["tokens"], cfg, dtype)
    h = _backbone(params, x, cfg, ax)
    w = L.unembed_weight(params, cfg).to(h.dtype)
    return L.chunked_softmax_xent(h, w, batch["labels"], cfg.vocab)


def init_cache(cfg: ModelConfig, batch: int, dtype, device):
    """Per-layer buffer lists (see transformer.init_cache)."""
    dtype = L.dtype_of(dtype) if isinstance(dtype, str) else dtype
    ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return {
        "conv": [zeros(batch, cfg.conv_width - 1, ch)
                 for _ in range(cfg.n_layers)],
        "ssm": [zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
                for _ in range(cfg.n_layers)],
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def abstract_cache(cfg: ModelConfig, batch: int, dtype):
    """The cache on the meta device."""
    return init_cache(cfg, batch, dtype, "meta")


def conv_tail(p, i, h, s: int, cfg: ModelConfig):
    """The conv state after a prompt: the last (w-1) pre-conv channel
    inputs of layer i (post-pre-norm) for hidden h [B, S, d], zero-padded on
    the left for short prompts (matches the causal conv's zero padding)."""
    hn = sharding.gather(L.rms_norm(h, p["ln"][i]), 1)
    xbc = torch.cat(_in_proj(p, i, hn, h.dtype), dim=-1)
    w = cfg.conv_width
    tail = xbc[:, max(0, s - w + 1):]
    short = (w - 1) - tail.shape[1]
    if short > 0:
        tail = F.pad(tail, (0, 0, short, 0))
    return tail


def prefill(params, batch, cfg: ModelConfig, ax, cache_len=None):
    """Prompt pass; returns (last-token logits, recurrent cache)."""
    dtype = L.dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    bsz, s = tokens.shape
    x = L.embed_tokens(params, tokens, cfg, dtype)
    cache = init_cache(cfg, bsz, dtype, x.device)
    p = params["layers"]
    for i in range(cfg.n_layers):
        x = sharding.constrain(x, ax.dp, ax.mp(x.shape[1]), None)
        y, h_final = block(p, i, x, cfg, ax)
        cache["conv"][i] = conv_tail(p, i, x, s, cfg)
        cache["ssm"][i] = h_final
        x = x + y
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    h = sharding.gather(L.rms_norm(x, params["ln_f"]), 1)
    logits = L.logits_fn(params, h[:, -1:], cfg)[:, 0]
    return logits, cache


def decode_step(params, cache, batch, cfg: ModelConfig, ax):
    """One token for every sequence; returns (logits [B, V], a new cache;
    the given one is not modified)."""
    dtype = L.dtype_of(cfg.dtype)
    cache = {"conv": list(cache["conv"]), "ssm": list(cache["ssm"]),
             "pos": cache["pos"]}
    tok = batch["tokens"]
    x = L.embed_tokens(params, tok[:, None], cfg, dtype)[:, 0]   # [B, d]
    p = params["layers"]
    for i in range(cfg.n_layers):
        y, conv_s, ssm_s = block_decode(
            p, i, x, cache["conv"][i], cache["ssm"][i], cfg, ax)
        cache["conv"][i] = conv_s
        cache["ssm"][i] = ssm_s
        x = x + y
    cache["pos"] = cache["pos"] + 1
    h = L.rms_norm(x, params["ln_f"])
    logits = L.logits_fn(params, h[:, None], cfg)[:, 0]
    return logits, cache
