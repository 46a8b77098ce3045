"""Model FLOPs of one training step, counted from the shapes.

A step's model FLOPs are those of its forward pass, twice over again for
the backward: 6 x the matmul parameters x the tokens for the dense
projections (the tied unembedding included: the logits are a matmul
against the embedding's rows), plus each family's own matmuls (an SSD's)
x 3.  Remat's second forward pass is hardware work, not model work, and
is not counted; elementwise work, norms and the conv are not counted
either, so the count is a floor of what the card computes.  The family's
own counts are `roofline/train_<family>.py`, found by the geometry's
`family`.
"""
from __future__ import annotations

import importlib
import math

from roofline import peaks


def leaf_shapes(g: dict) -> dict:
    """{path: shape} of the model's leaves, as the geometry lists them."""
    return {path: tuple(shape) for path, shape in g["leaves"]}


def dense_flops(matmul_params: int, tokens: int) -> float:
    """6 x parameters x tokens: the forward's multiply-add, and the
    backward's two (the input's gradient and the weight's)."""
    return 6.0 * matmul_params * tokens


def step_flops(g: dict) -> float:
    """Model FLOPs of one local step at the geometry's batch."""
    fam = importlib.import_module(f"roofline.train_{g['family']}")
    return fam.step_flops(g)


def mfu_pct(g: dict, steps: int, seconds: float) -> float:
    """`steps` training steps' model FLOPs over `seconds` x the card's
    dense bfloat16 peak."""
    return 100.0 * steps * step_flops(g) / (seconds
                                             * peaks.BF16_DENSE_FLOPS)


def prod(shape) -> int:
    return math.prod(shape)
