"""Mamba-2's chunked SSD scan, forward and backward, as CUDA kernels
(`csrc/ssd.cu`), and the two autograd Functions that join them.

`ssd(x, dtv, a, b, c, chunk, h0)` computes the function of
`models/mamba2.py` `ssd_chunked_plain` with the same outputs and dtypes:
y in x's dtype and h_final in x's dtype; its backward gives x, dt, a, B,
C and h0 their gradients in their own dtypes.  Every product and sum is
float32 (FFMA); x, B and C are read as they come (bfloat16 or float32) and
widened in registers.  The kernels take one group (B and C shared by the
heads), a chunk of at most `MAX_CHUNK` steps and (head_dim, state) one of
`KERNEL_WIDTHS`; any other shape raises.  They take decays of at most 1
(a <= 0, dt >= 0), as Mamba-2's a = -exp(A_log) and softplus dt are: they
split exp(cum_q - cum_s) at a pivot into two factors of at most 1.

Replaces no TPU kernel: the JAX package runs the SSD as einsums under XLA.
`ssd_fwd` and `ssd_bwd` each count one launch a call (`launches`, listed in
`ops.KERNELS`), however many kernels the call runs.

The two Functions work under torch.func as under autograd: `grad` reaches
the kernels' backward, and forward mode (`jvp`) takes tangents in dy and
dh_final through the backward (which is linear in them), as the
sensitivity maps' jvp of a grad has them: their tangents enter through the
labels alone.  A nonzero tangent through the forward or through the
backward's other inputs, a second reverse derivative and vmap raise.
"""
from __future__ import annotations

import torch

from repro_torch import obs as _obs
from repro_torch.kernels import build as _build

# (head_dim, state) the kernels are built for: mamba2-370m (64, 128),
# zamba2-7b (64, 64), both SMOKE configs (16, 16)
KERNEL_WIDTHS = ((64, 128), (64, 64), (16, 16))
MAX_CHUNK = 256     # csrc/ssd.cu MAX_Q: one step a thread of a block scan
THREADS = 256       # csrc/ssd.cu THREADS: a block's threads
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

def check_shape(q: int, head_dim: int, state: int) -> None:
    """Raise unless the kernels take chunks of q steps at these widths."""
    if (head_dim, state) not in KERNEL_WIDTHS:
        raise ValueError(f"ssd: (head_dim, state) = ({head_dim}, {state}) "
                         f"is not one of the kernels' {KERNEL_WIDTHS}")
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"ssd: a chunk of {q} steps; the kernels take 1 to "
                         f"{MAX_CHUNK}")


def _geometry(x, b, q):
    bsz, s, nh, hd = x.shape
    st = b.shape[-1]
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of chunk {q}")
    return bsz, s, nh, hd, st, s // q


def _padded(q):
    """C B^T's row stride: q floats rounded up to 16 bytes."""
    return -(-q // 4) * 4


def _cuda_call(fn, *args):
    _build.launch("ssd", fn + "_launch", *args)


def _aligned(t):
    """t contiguous, its data on 16 bytes (the kernels load 16-byte chunks
    of a row); None stays None."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fwd(x, dtv, a, b, c, q, h0=None):
    """The forward kernels (x, b, c of one dtype; dtv, a, h0 float32) ->
    (y, h_final, the state before each chunk float32 [B, n, H, P, N], the
    chunks' cumulative dt a float32 [B, H, n, q])."""
    bsz, s, nh, hd, st, n = _geometry(x, b, q)
    x, dtv, a, b, c, h0 = map(_aligned, (x, dtv, a, b, c, h0))
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    h_final = torch.empty((bsz, nh, hd, st), dtype=x.dtype, device=x.device)
    cum = torch.empty((bsz, nh, n, q), **f32)
    hbuf = torch.empty((bsz, n, nh, hd, st), **f32)
    cb = torch.empty((bsz, n, q, _padded(q)), **f32)
    _cuda_call("ssd_fwd", _DTYPES[x.dtype], bsz, s, nh, hd, st, q, x, dtv,
               a, b, c, h0, y, h_final, cum, hbuf, cb)
    return y, h_final, hbuf, cum


def bwd(x, dtv, a, b, c, hbuf, cum, q, dy, dh_final, with_h0):
    """The backward kernels (dy and dh_final in x's dtype; dy None: zeros)
    -> (dx, ddt float32, da float32, db, dc, dh0 float32 or None)."""
    bsz, s, nh, hd, st, n = _geometry(x, b, q)
    dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype)
    dh_final = None if dh_final is None else dh_final.to(x.dtype)
    x, dtv, a, b, c, dy, dh_final = map(_aligned,
                                        (x, dtv, a, b, c, dy, dh_final))
    f32 = dict(dtype=torch.float32, device=x.device)
    nblk = hd * st // THREADS
    scratch = dict(
        cb=torch.empty((bsz, n, q, _padded(q)), **f32),
        gbuf=torch.empty((bsz, n, nh, hd, st), **f32),
        dapart=torch.empty((bsz, nh, n, nblk), **f32),
        dcq=torch.empty((bsz, nh, n, q), **f32),
        dcs=torch.empty((bsz, nh, n, q), **f32),
        ddv=torch.empty((bsz, nh, n, q), **f32),
        ddtx=torch.empty((bsz, s, nh), **f32),
        dapart2=torch.empty((nh, bsz * n), **f32))
    dx = torch.empty_like(x)
    ddt = torch.empty((bsz, s, nh), **f32)
    da = torch.empty((nh,), **f32)
    db = torch.empty_like(b)
    dc = torch.empty_like(c)
    dh0 = torch.empty((bsz, nh, hd, st), **f32) if with_h0 else None
    _cuda_call("ssd_bwd", _DTYPES[x.dtype], bsz, s, nh, hd, st, q, x, dtv,
               a, b, c, hbuf, cum, dy, dh_final, *scratch.values(), dx, ddt,
               da, db, dc, dh0)
    return dx, ddt, da, db, dc, dh0


def ssd_fwd(*args, **kwargs):
    """`fwd` on the card, counted."""
    out = fwd(*args, **kwargs)
    ssd_fwd.launches += 1
    return out


def ssd_bwd(*args, **kwargs):
    """`bwd` on the card, counted."""
    out = bwd(*args, **kwargs)
    ssd_bwd.launches += 1
    return out


ssd_fwd.launches = 0
ssd_bwd.launches = 0


def _nonzero(tangents) -> bool:
    """Whether any of the tangents is nonzero (torch.func hands zeros, not
    None, for an input its jvp transform made without a tangent)."""
    ts = [t for t in tangents if t is not None]
    return bool(torch.stack([t.any() for t in ts]).any()) if ts else False


class SsdFunction(torch.autograd.Function):
    """(y, h_final, the states before the chunks, cum) = SSD(x, dt, a, B,
    C, h0) by the kernels; the last two are kept for the backward.  Its
    inputs as `fwd` takes them."""

    @staticmethod
    def forward(x, dtv, a, b, c, h0, q):
        return ssd_fwd(x, dtv, a, b, c, q, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dtv, a, b, c, h0, q = inputs
        _, _, hbuf, cum = output
        ctx.mark_non_differentiable(hbuf, cum)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dtv, a, b, c, h0, hbuf, cum)
        ctx.save_for_forward(x, b)
        ctx.q = q

    @staticmethod
    def backward(ctx, dy, dh_final, _dhbuf, _dcum):
        with _obs.span("model.ssd_bwd", device=True):
            x, dtv, a, b, c, h0, hbuf, cum = ctx.saved_tensors
            grads = SsdBackward.apply(x, dtv, a, b, c, hbuf, cum, dy,
                                      dh_final, ctx.q, h0 is not None)
            return (*grads, None)

    @staticmethod
    def jvp(ctx, *tangents):
        if _nonzero(tangents[:6]):
            raise NotImplementedError("ssd: the kernels take no tangent "
                                      "through the forward")
        x, b = ctx.saved_tensors
        bsz, _, nh, hd = x.shape
        # zeros: torch.func takes no None for a differentiable output
        return (torch.zeros_like(x), x.new_zeros((bsz, nh, hd, b.shape[-1])),
                None, None)


class SsdBackward(torch.autograd.Function):
    """(dx, ddt, da, dB, dC, dh0) of SsdFunction by the kernels: `bwd`'s
    arguments and results.  Linear in (dy, dh_final): its forward-mode rule
    is one more call on their tangents."""

    @staticmethod
    def forward(x, dtv, a, b, c, hbuf, cum, dy, dh_final, q, with_h0):
        return ssd_bwd(x, dtv, a, b, c, hbuf, cum, q, dy, dh_final, with_h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        *saved, _, _, q, with_h0 = inputs
        ctx.save_for_forward(*saved)
        ctx.q, ctx.with_h0 = q, with_h0

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("ssd: the kernels' backward has no "
                                  "reverse derivative")

    @staticmethod
    def jvp(ctx, *tangents):
        *fixed, tdy, tdhf, _, _ = tangents
        if _nonzero(fixed):
            raise NotImplementedError("ssd: the kernels' backward takes "
                                      "tangents in dy and dh_final only")
        x, dtv, a, b, c, hbuf, cum = ctx.saved_tensors
        return SsdBackward.apply(x, dtv, a, b, c, hbuf, cum, tdy, tdhf,
                                 ctx.q, ctx.with_h0)


def ssd(x, dtv, a, b, c, chunk: int, h0=None):
    """SSD over a full sequence on CUDA tensors, through the kernels:
    `ssd_chunked_plain`'s arguments and results."""
    _build.require_cuda("ssd", x)
    q = min(chunk, x.shape[1])
    check_shape(q, x.shape[-1], b.shape[-1])
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd: x, B, C must share float32 or bfloat16, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if b.dim() != 3 or c.shape != b.shape:
        raise ValueError("ssd: B and C must be [batch, seq, state] (one "
                         "group)")
    h0 = None if h0 is None else h0.float()
    y, h_final, _, _ = SsdFunction.apply(x, dtv.float(), a.float(), b, c,
                                         h0, q)
    return y, h_final


def cost(bsz: int, s: int, nh: int, hd: int, st: int, q: int,
         x_bytes: int = 2) -> dict:
    """The float32 operations and device bytes the SSD needs, forward and
    backward, with the causal half of every Q x Q product (the roofline's
    least work): a multiply-add is 2 operations; each input read and each
    output written once (x, B, C, y and their gradients at x_bytes, dt and
    the states float32)."""
    n = s // q
    tri = q * (q + 1) // 2
    per_head = n * bsz * nh
    per_chunk = n * bsz
    fwd_macs = per_head * (q * hd * st + q * st * hd + tri * hd) \
        + per_chunk * tri * st
    # G, dS's two products and dy H^T per head; dM and dx's intra product
    # per head; C B^T, dB's and dC's intra products per chunk
    bwd_macs = per_head * (4 * q * hd * st + 2 * tri * hd) \
        + per_chunk * 3 * tri * st
    xs = bsz * s * nh * hd * x_bytes
    bc = 2 * bsz * s * st * x_bytes
    dts = bsz * s * nh * 4
    states = bsz * n * nh * hd * st * 4
    fwd_bytes = xs + bc + dts + xs + states
    bwd_bytes = 2 * xs + bc + dts + states + xs + bc + dts
    return {"fwd_flops": 2 * fwd_macs, "fwd_bytes": fwd_bytes,
            "bwd_flops": 2 * bwd_macs, "bwd_bytes": bwd_bytes}

