"""LR schedules."""
from __future__ import annotations

import math

import torch


def cosine_lr(step, base_lr: float, warmup: int, total: int,
              min_ratio: float = 0.1):
    """Linear warmup, then cosine decay to min_ratio * base_lr (float32)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * step / max(1.0, warmup)
    frac = torch.clamp((step - warmup) / max(1.0, total - warmup), 0, 1)
    cos = base_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
