"""What the round should produce, worked out again from the inputs: the
top-p mask, the FedAvg of the clients' vectors in float64, and the errors
of the program's outputs against it."""
from __future__ import annotations

import torch


def top_p_mask(sens, p: float):
    """bool[P]: the round(P p) entries of largest |s|, ties going to the
    lower index."""
    mag = sens.abs()
    n = mag.numel()
    k = int(round(n * min(max(float(p), 0.0), 1.0)))
    mask = torch.zeros(n, dtype=torch.bool, device=mag.device)
    if k == 0:
        return mask
    kth = torch.sort(mag, descending=True).values[k - 1]   # k-th largest
    mask = mag > kth
    short = k - int(mask.sum())
    if short:
        ties = torch.nonzero(mag == kth).reshape(-1)[:short]
        mask[ties] = True
    return mask


def weighted_mean(vectors, weights):
    """sum_i w_i x_i in float64, the vectors given one at a time (an
    iterable, so that only one is alive beside the sum)."""
    acc = None
    for x, w in zip(vectors, weights):
        term = x.to(torch.float64) * float(w)
        acc = term if acc is None else acc.add_(term)
        del x
    return acc


def max_abs_err(got, want) -> float:
    """max |got - want| over every entry; inf where got is not finite."""
    got = got.to(torch.float64)
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    if got.numel() == 0:
        return 0.0
    return float((got - want).abs().max())
