"""Encryption-mask selection (paper §2.4 Step 2).

Every selector returns a flat boolean tensor over the flattened parameter
vector, on the device of the sensitivity tensor it is given.  Orders are
stable sorts of -|s| in the input's dtype: that is the order of the JAX
package's `np.lexsort((index, -|s|))`, ties broken by index, so the masks
are identical and nest across p.  On the card this sort takes seconds where
the host lexsort over a large model takes minutes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ckks.params import resolve_device


def _n_select(n_total: int, p: float) -> int:
    p = float(min(max(p, 0.0), 1.0))
    return int(round(n_total * p))


def _descending_order(s):
    """Indices of s by decreasing |s|, ties in index order."""
    return torch.sort(-s.abs(), stable=True).indices


def top_p_mask(sens_vec, p: float):
    """Global top-p by sensitivity magnitude. Returns bool[P]."""
    s = torch.as_tensor(sens_vec).reshape(-1)
    k = _n_select(s.numel(), p)
    mask = torch.zeros(s.numel(), dtype=torch.bool, device=s.device)
    if k > 0:
        mask[_descending_order(s)[:k]] = True
    return mask


def random_mask(p: float, n_total: int, seed: int = 0, device=None):
    """Random-p baseline, nested across p for a fixed seed (the JAX
    package's numpy permutation, so the masks are identical), on `device`
    (CUDA unless the caller names another)."""
    device = resolve_device(device)
    order = np.random.RandomState(seed).permutation(n_total)
    mask = torch.zeros(n_total, dtype=torch.bool, device=device)
    mask[torch.from_numpy(order[: _n_select(n_total, p)]).to(device)] = True
    return mask


def per_layer_top_p_mask(sens_vec, p: float, offsets, sizes):
    """Top-p within each leaf (layer) instead of globally."""
    s = torch.as_tensor(sens_vec).reshape(-1)
    mask = torch.zeros(s.numel(), dtype=torch.bool, device=s.device)
    for off, size in zip(offsets, sizes):
        k = _n_select(size, p)
        if k > 0:
            mask[off + _descending_order(s[off: off + size])[:k]] = True
    return mask


def recipe_mask(sens_vec, p: float, offsets, sizes, first_last: bool = True):
    """The paper's recipe: global top-p UNION first & last leaves."""
    mask = top_p_mask(sens_vec, p)
    if first_last and len(sizes) > 0:
        mask[offsets[0]: offsets[0] + sizes[0]] = True
        mask[offsets[-1]: offsets[-1] + sizes[-1]] = True
    return mask


STRATEGIES = ("top_p", "random", "per_layer", "recipe", "all", "none")


def build_mask(sens_vec, strategy: str, p: float, *, offsets=None,
               sizes=None, seed: int = 0):
    """Single dispatch point from (strategy, p) to a boolean mask."""
    s = torch.as_tensor(sens_vec).reshape(-1)
    n = s.numel()
    if strategy == "top_p":
        return top_p_mask(s, p)
    if strategy == "random":
        return random_mask(p, n, seed=seed, device=s.device)
    if strategy in ("per_layer", "recipe"):
        if offsets is None or sizes is None:
            raise ValueError(
                f"strategy {strategy!r} needs the leaf layout "
                "(offsets/sizes from packing.FlatSpec)")
        if strategy == "per_layer":
            return per_layer_top_p_mask(s, p, offsets, sizes)
        return recipe_mask(s, p, offsets, sizes)
    if strategy == "all":
        return torch.ones(n, dtype=torch.bool, device=s.device)
    if strategy == "none":
        return torch.zeros(n, dtype=torch.bool, device=s.device)
    raise ValueError(f"unknown selection strategy {strategy!r}; "
                     f"choose from {STRATEGIES}")


def mask_stats(mask) -> dict:
    """{"n_total", "n_enc", "ratio"} of a bool tensor (any device) or numpy
    mask."""
    if isinstance(mask, torch.Tensor):
        mask = mask.detach().cpu().numpy()
    mask = np.asarray(mask, dtype=bool)
    return {"n_total": int(mask.size), "n_enc": int(mask.sum()),
            "ratio": float(mask.mean())}
