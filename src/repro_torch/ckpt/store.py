"""Fault-tolerant tree checkpointing (npz payload + json manifest), the JAX
package's `repro.ckpt.store` format: a checkpoint either package writes,
the other restores.

A tree is a nested dict / list / tuple whose leaves are torch tensors (on
any device) or numpy arrays.  Leaves are named and ordered as
`jax.tree_util.tree_flatten_with_path` names them: dict keys sorted,
sequence indices, names joined with "/"; None is an empty subtree.  Each
checkpoint is `path/step_<8 digits>/` holding `payload.npz` (leaf i under
key "a<i>") and `manifest.json` ({"step", "names", "extra"}).

Atomicity: the payload is written to a temporary directory, then
os.replace'd into place, so a crash mid-write never corrupts the latest
checkpoint.  Rotation keeps the last `keep` steps.  Restore returns numpy
leaves; the caller places them (as `StreamIngest.restore_state` does).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

import numpy as np
import torch

# only exactly step_<digits> counts as a checkpoint: a crash-orphaned
# .tmp_ckpt_* dir, a stray "step_final" note, or any other junk in the
# checkpoint root must never break latest_step / rotation
_STEP_DIR = re.compile(r"^step_(\d+)$")


def _step_numbers(path: str) -> list[int]:
    """Sorted step numbers of the well-formed step_<N> dirs under path."""
    if not os.path.isdir(path):
        return []
    steps = []
    for d in os.listdir(path):
        m = _STEP_DIR.match(d)
        if m and os.path.isdir(os.path.join(path, d)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def _flatten_with_names(tree, prefix=(), names=None, leaves=None):
    """(names, leaves) in pytree order."""
    names = [] if names is None else names
    leaves = [] if leaves is None else leaves
    if tree is None:
        pass
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten_with_names(tree[k], prefix + (str(k),), names, leaves)
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            _flatten_with_names(t, prefix + (str(i),), names, leaves)
    else:
        names.append("/".join(prefix))
        leaves.append(tree)
    return names, leaves


def _unflatten_like(tree_like, leaves):
    """tree_like's structure with its leaves taken in order from the
    iterator `leaves`."""
    if tree_like is None:
        return None
    if isinstance(tree_like, dict):
        return {k: _unflatten_like(tree_like[k], leaves)
                for k in sorted(tree_like)}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten_like(t, leaves) for t in tree_like)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, step: int, tree, extra: dict | None = None):
    """Atomic write of one checkpoint at `path/step_<N>/`."""
    names, leaves = _flatten_with_names(tree)
    final = os.path.join(path, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=path, prefix=".tmp_ckpt_")
    try:
        arrays = {f"a{i}": _to_numpy(l) for i, l in enumerate(leaves)}
        np.savez(os.path.join(tmp, "payload.npz"), **arrays)
        manifest = {"step": step, "names": names, "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    return final


def latest_step(path: str) -> int | None:
    """Highest step with a well-formed step_<N> dir, or None.  Ignores
    orphaned temp dirs and non-numeric step_* strays (a crashed writer
    must never wedge the next restore)."""
    steps = _step_numbers(path)
    return steps[-1] if steps else None


def read_manifest(path: str, step: int | None = None) -> dict | None:
    """Manifest dict of one checkpoint ({"step", "names", "extra"}), or
    None when absent: a resuming caller reads its json state before it can
    build the tree_like that restore_checkpoint needs."""
    step = latest_step(path) if step is None else step
    if step is None:
        return None
    manifest = os.path.join(path, f"step_{step:08d}", "manifest.json")
    if not os.path.exists(manifest):
        return None
    with open(manifest) as f:
        return json.load(f)


def restore_checkpoint(path: str, tree_like, step: int | None = None):
    """Returns (tree of numpy leaves shaped like tree_like, step, extra),
    or (None, None, None) when absent."""
    step = latest_step(path) if step is None else step
    if step is None:
        return None, None, None
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "payload.npz")) as payload:
        leaves = [payload[f"a{i}"] for i in range(len(manifest["names"]))]
    n_like = len(_flatten_with_names(tree_like)[1])
    if n_like != len(leaves):
        raise ValueError(f"checkpoint step {step} holds {len(leaves)} "
                         f"leaves, tree_like has {n_like}")
    tree = _unflatten_like(tree_like, iter(leaves))
    return tree, manifest["step"], manifest["extra"]


class CheckpointManager:
    """Rotation + resume policy around save/restore."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep

    def save(self, step: int, tree, extra: dict | None = None):
        out = save_checkpoint(self.path, step, tree, extra)
        self._rotate()
        return out

    def restore(self, tree_like, step: int | None = None):
        return restore_checkpoint(self.path, tree_like, step)

    def _rotate(self):
        for s in _step_numbers(self.path)[: -self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)
