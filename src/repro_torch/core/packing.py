"""Flatten/partition/pack model parameters for selective HE.

The FL/HE boundary works on one flat float32 vector per model.  Parameters
are nested dicts (or lists/tuples) of tensors, flattened in JAX's pytree
order, where a dict's leaves come in sorted-key order: a mask then means the
same parameters in both packages.  The mask partition is kept as a boolean
tensor.  Splitting and merging read, on a CUDA vector, the partition's
per-device layout (the mask packed to 32-bit words and the encrypted count
before each tile, `kernels/mask.py`), built at the first split or merge on
that device and cached on the partition; each is then one kernel launch
that reads every element once and writes it once, with no index array and
no host sync.  On a CPU vector they are boolean gathers and scatters.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import torch

from repro_torch import obs
from repro_torch.kernels import mask as _mask


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Shape bookkeeping for nested-params <-> flat-vector round trips.

    `structure` mirrors the params with every leaf replaced by its index in
    the flat order."""

    structure: object
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    sizes: tuple[int, ...]
    offsets: tuple[int, ...]   # start offset of each leaf in the flat vector

    @property
    def total(self) -> int:
        return self.offsets[-1] + self.sizes[-1] if self.sizes else 0


def _flatten(tree, leaves: list):
    """Leaves of `tree` in JAX pytree order, and the tree with each leaf
    replaced by its index."""
    if isinstance(tree, dict):
        return {k: _flatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(t, leaves) for t in tree)
    leaves.append(tree)
    return len(leaves) - 1


def _unflatten(structure, leaves):
    if isinstance(structure, dict):
        return {k: _unflatten(v, leaves) for k, v in structure.items()}
    if isinstance(structure, (list, tuple)):
        return type(structure)(_unflatten(s, leaves) for s in structure)
    return leaves[structure]


def tree_leaves(params) -> list:
    """Leaves in JAX pytree order (sorted dict keys)."""
    leaves: list = []
    _flatten(params, leaves)
    return leaves


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the matching leaves of `rest`),
    in the same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten_leaves(leaves, spec: FlatSpec):
    """Leaves in pytree order -> spec's structure (inverse of
    tree_leaves)."""
    return _unflatten(spec.structure, leaves)


def make_flat_spec(params) -> FlatSpec:
    leaves: list = []
    structure = _flatten(params, leaves)
    shapes = tuple(tuple(l.shape) for l in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets = tuple(itertools.accumulate(sizes, initial=0))[:-1]
    return FlatSpec(structure=structure, shapes=shapes,
                    dtypes=tuple(l.dtype for l in leaves), sizes=sizes,
                    offsets=offsets)


def flatten_params(params):
    """params -> (float32[P] on the leaves' device, FlatSpec)."""
    spec = make_flat_spec(params)
    vec = torch.cat([l.reshape(-1).to(torch.float32)
                     for l in tree_leaves(params)])
    return vec, spec


def unflatten_params(vec, spec: FlatSpec):
    """float32[P] -> params with spec's structure, shapes and dtypes."""
    leaves = [vec[off:off + size].reshape(shape).to(dt)
              for off, size, shape, dt in zip(spec.offsets, spec.sizes,
                                              spec.shapes, spec.dtypes)]
    return _unflatten(spec.structure, leaves)


# ---------------------------------------------------------------------------
# mask partition
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MaskPartition:
    """A boolean mask splitting a flat vector into an encrypted part (in
    index order, zero-padded to whole slot blocks) and a plaintext part."""

    mask: torch.Tensor       # bool[P]
    n_enc: int
    slots: int
    # device -> kernels.mask.MaskLayout, built at first use
    _layouts: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False, compare=False)

    @property
    def n_total(self) -> int:
        return int(self.mask.numel())

    @property
    def n_plain(self) -> int:
        return self.n_total - self.n_enc

    @property
    def enc_idx(self) -> torch.Tensor:
        return torch.nonzero(self.mask).reshape(-1)

    @property
    def plain_idx(self) -> torch.Tensor:
        return torch.nonzero(~self.mask).reshape(-1)

    @property
    def n_chunks(self) -> int:
        return max(1, -(-self.n_enc // self.slots))

    @property
    def n_enc_padded(self) -> int:
        return self.n_chunks * self.slots

    @property
    def ratio(self) -> float:
        return self.n_enc / max(1, self.n_total)

    def layout(self, device) -> _mask.MaskLayout:
        """The split and merge kernels' layout of the mask on `device`,
        built from the mask there at the first call and kept (two threads
        that race here build the same layout, and either is kept)."""
        device = torch.device(device)
        lay = self._layouts.get(device)
        if lay is None:
            lay = _mask.build_layout(self.mask.to(device))
            self._layouts[device] = lay
        return lay


def make_partition(mask, slots: int) -> MaskPartition:
    mask = torch.as_tensor(mask, dtype=torch.bool).reshape(-1)
    return MaskPartition(mask=mask, n_enc=int(mask.sum()), slots=int(slots))


def split_by_mask(vec, part: MaskPartition):
    """float32[P] -> (enc float32[n_chunks, slots] zero-padded,
    plain float32[n_plain]), under an `he.split` span timed on the vector's
    device."""
    with obs.span("he.split", device=vec.device):
        return _mask.mask_split(vec, part)


def merge_by_mask(enc_chunks, plain, part: MaskPartition):
    """Inverse of split_by_mask -> float32[P], under an `he.merge` span
    timed on the plain part's device."""
    with obs.span("he.merge", device=plain.device):
        return _mask.mask_merge(enc_chunks, plain, part)
