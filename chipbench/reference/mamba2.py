"""Mamba-2 language-model training in plain float32 torch, for judging a
client's local steps.

Written from the Mamba-2 paper (arXiv:2405.21060: the SSD layer of its
sections 6-7 and the minimal chunked SSD of its Listing 1) and the
source's configuration (state-spaces/mamba2-370m: pre-norm RMSNorm
blocks, one group of B and C, a width-4 depthwise causal conv with SiLU,
the gated RMSNorm before the output projection, tied embeddings), not from
the program's code.  A layer of width d, d_inner = expand * d, H heads of
P channels and state N, on the residual stream x:

    u = RMSNorm(x)
    z, xs, B, C, dt = u W_z, u W_x, u W_B, u W_C, u W_dt
    xs, B, C = SiLU(causal depthwise conv of (xs, B, C))
    dt = softplus(dt + dt_bias);  A = -exp(A_log)
    y = SSD(xs * dt, A * dt, B, C) + D * xs
    x = x + RMSNorm(y * SiLU(z)) W_out

then the final RMSNorm, the logits against the embedding's rows, the mean
cross-entropy over every position, and per step one AdamW update: the
gradient clipped to a global norm, bias-corrected moments, decoupled
weight decay.  Each layer's activations are recomputed in the backward
pass (`torch.utils.checkpoint`) and a step's batch is taken in blocks of
rows, the gradients summed, so that it fits beside the program's kept
state; neither changes the arithmetic.

Parameters are the configuration file's leaves by path ("layers/in_x" of
[layers, d, d_inner], "layers/conv_x" of [layers, width, d_inner], ...).

Its constants are the configuration file's: the softmax spans the first
`vocab_size` rows of the embedding, and RMSNorm's epsilon is
`norm_epsilon`.  Departures from the source, as the configuration's
`reduced` lists them: the conv has no bias; the embedding has 50,304 rows
(a pad multiple of 64); `norm_epsilon` is 1e-6 (the source's 1e-5).  The
SSD's chunk is the source's `chunk_size`, 256; it changes only the order
of the sums.  TF32 is off throughout `train`.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

CHUNK = 256


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def segsum(x):
    """[..., T] -> [..., T, T]: out[t, s] = x[s+1] + ... + x[t] for s <= t,
    -inf above the diagonal (Listing 1's `segsum`)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    low = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return seg.masked_fill(~low, -math.inf)


def ssd(x, a, b, c, chunk: int):
    """Listing 1 with one group of B and C.  x [q, S, H, P] (already times
    dt), a [q, S, H] (A times dt), b, c [q, S, N] -> y [q, S, H, P]; in
    the einsums k is the chunk, l and s positions in it, d the state."""
    q, s, h, p = x.shape
    k = s // chunk
    x = x.reshape(q, k, chunk, h, p)
    a = a.reshape(q, k, chunk, h).permute(0, 3, 1, 2)          # q h k l
    b = b.reshape(q, k, chunk, -1)
    c = c.reshape(q, k, chunk, -1)
    a_cs = torch.cumsum(a, dim=-1)
    # 1. within each chunk (the diagonal blocks)
    decay = torch.exp(segsum(a))                               # q h k l s
    cb = torch.einsum("qkld,qksd->qkls", c, b)                 # q k l s
    y_diag = torch.einsum("qhkls,qkshp->qklhp", cb[:, None] * decay, x)
    # 2. each chunk's final state
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)            # q h k l
    states = torch.einsum("qkld,qklhp->qkhpd", b,
                          x * decay_states.permute(0, 2, 3, 1)[..., None])
    # 3. the recurrence between chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(a_cs[..., -1], (1, 0))))
    states = torch.einsum("qhzk,qkhpd->qzhpd", decay_chunk, states)[:, :-1]
    # 4. each chunk's incoming state to its outputs
    y_off = torch.einsum("qkld,qkhpd->qklhp", c, states) \
        * torch.exp(a_cs).permute(0, 2, 3, 1)[..., None]
    return (y_diag + y_off).reshape(q, s, h, p)


def causal_conv(v, w):
    """Depthwise causal conv: v [n, S, ch], w [width, ch]; out[t] =
    sum_j w[j] v[t - width + 1 + j]."""
    width = w.shape[0]
    out = F.conv1d(F.pad(v.transpose(1, 2), (width - 1, 0)),
                   w.t().unsqueeze(1), groups=v.shape[-1])
    return out.transpose(1, 2)


def layer(x, ln, in_z, in_x, in_b, in_c, in_dt, conv_x, conv_b, conv_c,
          dt_bias, a_log, d_skip, norm, out_proj, chunk: int, eps: float):
    u = rms_norm(x, ln, eps)
    z, xs, b, c, dt = (u @ in_z, u @ in_x, u @ in_b, u @ in_c, u @ in_dt)
    din, nst = xs.shape[-1], b.shape[-1]
    xbc = F.silu(causal_conv(torch.cat([xs, b, c], dim=-1),
                             torch.cat([conv_x, conv_b, conv_c], dim=-1)))
    xs, b, c = xbc.split([din, nst, nst], dim=-1)
    dt = F.softplus(dt + dt_bias)
    a = -torch.exp(a_log)
    n, s = x.shape[:2]
    heads = a.shape[0]
    xh = xs.reshape(n, s, heads, din // heads)
    y = ssd(xh * dt[..., None], a * dt, b, c, chunk)
    y = (y + d_skip[:, None] * xh).reshape(n, s, din)
    return rms_norm(y * F.silu(z), norm, eps) @ out_proj


LAYER_LEAVES = ("ln", "in_z", "in_x", "in_B", "in_C", "in_dt", "conv_x",
                "conv_B", "conv_C", "dt_bias", "A_log", "D", "norm",
                "out_proj")


def loss_sum(cfg: dict, params: dict, tokens, labels, chunk: int):
    """Summed cross-entropy of next-token prediction over a block of
    rows."""
    vocab, eps = int(cfg["vocab_size"]), float(cfg["norm_epsilon"])
    x = F.embedding(tokens.long(), params["embed"])
    for i in range(params["layers/ln"].shape[0]):
        ws = [params["layers/" + k][i] for k in LAYER_LEAVES]
        x = x + checkpoint(layer, x, *ws, chunk, eps, use_reentrant=False)
    h = rms_norm(x, params["ln_f"], eps)
    logits = h @ params["embed"][:vocab].t()
    return F.cross_entropy(logits.reshape(-1, vocab),
                           labels.reshape(-1).long(), reduction="sum")


@contextlib.contextmanager
def exact_float32():
    """float32 matmuls and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def train(cfg: dict, params: dict, batches, *, lr: float, b1: float,
          b2: float, eps: float, weight_decay: float, clip_norm: float,
          rows_a_block: int = 8) -> dict:
    """AdamW steps of the configuration `cfg`'s model from `params`
    ({path: tensor}, read, not changed), one a batch of `batches`
    ([(tokens, labels)] int tensors [rows, seq]).

    Returns {"losses": each step's mean loss before its update,
    "grad_norms": {path: norm of the first step's clipped gradient},
    "params": {path: float32 tensor after the last step}}."""
    with exact_float32():
        p = {k: v.detach().to(torch.float32).clone().requires_grad_()
             for k, v in params.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        losses, grad_norms = [], {}
        for step, (tokens, labels) in enumerate(batches, start=1):
            seq = tokens.shape[1]
            chunk = min(CHUNK, seq)
            if seq % chunk:
                raise ValueError(f"sequence {seq} is no multiple of {chunk}")
            total = 0.0
            for r in range(0, tokens.shape[0], rows_a_block):
                loss = loss_sum(cfg, p, tokens[r:r + rows_a_block],
                                labels[r:r + rows_a_block],
                                chunk) / tokens.numel()
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            with torch.no_grad():
                norm = math.sqrt(sum(float(t.grad.double().pow(2).sum())
                                     for t in p.values()))
                scale = min(1.0, clip_norm / max(norm, 1e-12))
                bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
                for k, t in p.items():
                    g = t.grad * scale
                    if step == 1:
                        grad_norms[k] = float(g.double().norm())
                    m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    t.sub_(lr * ((m[k] / bc1) / ((v2[k] / bc2).sqrt() + eps)
                                 + weight_decay * t))
                    t.grad = None
        return {"losses": losses, "grad_norms": grad_norms,
                "params": {k: t.detach() for k, t in p.items()}}
