"""Model FLOPs of a Mamba-2 training step (arXiv:2405.21060's SSD).

Dense projections: each layer's in_z, in_x, in_B, in_C, in_dt and
out_proj, and the tied unembedding (the embedding's rows x d).  The SSD's
matmuls a layer and token, at chunk length Q, state N, H heads of P
channels, one group of B and C: C B^T within each chunk (2 Q N), its
masked product with the inputs (2 Q H P), each chunk's state (2 N H P)
and the states' outputs (2 N H P); the squares within a chunk are counted
whole, as the chunked algorithm computes them.
"""
from __future__ import annotations

from roofline import train

PROJECTIONS = ("in_z", "in_x", "in_B", "in_C", "in_dt", "out_proj")


def step_flops(g: dict) -> float:
    s = train.leaf_shapes(g)
    layers, d, din = s["layers/in_x"]
    nst = s["layers/in_B"][2]
    heads = s["layers/A_log"][1]
    hd = din // heads
    rows_vocab = s["embed"][0]
    matmul = layers * sum(train.prod(s["layers/" + k][1:])
                          for k in PROJECTIONS) + rows_vocab * d
    tokens = g["rows"] * g["seq"]
    q = min(g["ssm_chunk"], g["seq"])
    ssd = layers * (2 * q * nst + 2 * q * heads * hd + 4 * nst * heads * hd)
    return train.dense_flops(matmul, tokens) + 3.0 * ssd * tokens
