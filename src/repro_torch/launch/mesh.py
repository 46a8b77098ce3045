"""Device meshes: the model meshes of `torch.distributed` and the sharded
HE engine's mesh (DESIGN.md §8).

Model meshes are `torch.distributed.device_mesh.DeviceMesh`es with the JAX
package's axis names, one rank per device: `make_production_mesh` is the
(16, 16) ("data", "model") pod of 256 ranks or the (2, 16, 16) ("pod",
"data", "model") pair of pods of 512, and `make_model_mesh` any other
shape.  They need a `torch.distributed` world of at least that many ranks
(`torchrun --nproc-per-node ...`, or the fake backend of
`launch/dryrun.py`, which plays JAX's placeholder host devices).  The
device type is CUDA unless the caller names another: a gloo or fake world
has no card, so tests and the dry-run pass "cpu".

An HE mesh (`HeMesh`) is a `[data][model]` grid of `torch.device`s that
one process drives: ciphertext chunks are cut along `data`, RNS limbs
along `model`.  A device may stand in more than one slot, so a mesh that
repeats the CPU, or one card, still cuts every tensor into its real
blocks; on a host with more cards the same mesh puts one block on each.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.ckks.params import resolve_device

AXES = ("data", "model")


def _normalize(device) -> torch.device:
    """A CUDA device without an index is the current card, as a tensor
    created on it reports."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class HeMesh:
    """devices[d][m]: the device of slot (d, m); every row has n_model
    devices."""

    devices: tuple

    def __post_init__(self):
        rows = tuple(tuple(_normalize(d) for d in row) for row in self.devices)
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh needs a non-empty rectangular [data]"
                             "[model] grid of devices")
        object.__setattr__(self, "devices", rows)

    @property
    def n_data(self) -> int:
        return len(self.devices)

    @property
    def n_model(self) -> int:
        return len(self.devices[0])

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    def device(self, d: int, m: int) -> torch.device:
        return self.devices[d][m]

    def flattened(self) -> "HeMesh":
        """The same slots in row-major order as a (size, 1) mesh: chunks cut
        over every slot, limbs whole (the chunk-only regime of
        launch.fl_step)."""
        return HeMesh(tuple((dev,) for row in self.devices for dev in row))


def make_model_mesh(shape, axes, device_type: str = "cuda"):
    """A `DeviceMesh` of `shape` named `axes` over the first prod(shape)
    ranks of the default process group (JAX's `_make_mesh`).  Raises
    RuntimeError, with the counts, when the world is smaller or not
    initialised."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks but only {have} exist"
            + ("" if have else " (torch.distributed is not initialised)")
            + f".  Start one rank a device with `torchrun --nproc-per-node "
            f"...` (a world of {n}), or, for a dry-run without devices, "
            "initialise torch.distributed with the fake backend as "
            "repro_torch.launch.dryrun does.")
    mesh = torch.arange(n).reshape(shape)
    return DeviceMesh(device_type, mesh, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 single pod (256 ranks) or 2x16x16 two-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_model_mesh(shape, axes, device_type)


def _default_devices() -> list[torch.device]:
    resolve_device(None)          # raises when there is no card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_host_mesh(device=None) -> HeMesh:
    """Trivial 1x1 mesh on `device` (CUDA unless the caller names another)."""
    return HeMesh(((resolve_device(device),),))


def make_he_mesh(n_limbs: int, n_devices: int | None = None, *,
                 devices=None) -> HeMesh:
    """("data", "model") mesh for the sharded HE engine.

    Picks the largest model-axis size that divides BOTH `n_limbs` (so whole
    limbs map to shards) and the device count (so the mesh is full); the
    remaining factor becomes the data axis, as the JAX package's
    `make_he_mesh` does.

    Args:
        n_limbs: RNS limb count of the CkksContext the mesh will serve.
        n_devices: slots to use (default: all of `devices`).
        devices: explicit device list, repeats allowed (default: every
            visible CUDA card; raises when there is none).
    """
    devs = list(devices) if devices is not None else _default_devices()
    k = int(n_devices if n_devices is not None else len(devs))
    if not 1 <= k <= len(devs):
        raise RuntimeError(f"make_he_mesh asked for {k} devices but "
                           f"{len(devs)} were given")
    m = max(d for d in range(1, k + 1) if n_limbs % d == 0 and k % d == 0)
    return HeMesh(tuple(tuple(devs[d * m:(d + 1) * m])
                        for d in range(k // m)))
