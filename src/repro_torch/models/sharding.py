"""Sharding policy: parameter/batch/cache specs for a production mesh
(the JAX package's `models/sharding.py`, DESIGN.md §4), and their
placement over a `torch.distributed` `DeviceMesh` by DTensor.

A spec is a plain tuple with one entry per tensor dimension: an axis name,
a tuple of axis names, or None (replicated), as JAX's `PartitionSpec`.
DTensor is the port's `NamedSharding`: `placements(spec, mesh)` turns a
spec into one placement per mesh dimension (`Shard(i)` on every mesh dim
that entry i names, `Replicate()` on the rest), `distribute(tree, specs,
mesh)` places a tree by them, and DTensor's sharding propagation plays
GSPMD's part.  `constrain` plays `with_sharding_constraint`'s: it
redistributes a DTensor whose mesh has an axis larger than 1 and is the
identity on a plain tensor, so every one-card path is unchanged.

Replicate-before sites (`REPLICATE_BEFORE`).  Where DTensor has no
placement for an op of the model on the placement the policy gives its
input, `gather` (or `whole_blocks`) gathers that input's dim just before
the op.  Each is a placement choice, not a fallback:
  * the normed input of every projection of a sequence (attention's
    q/k/v, the MLP or MoE, the unembedding; mamba2's conv tail; zamba2's
    shared block) is gathered over the sequence, which the residual's
    constraint cuts over 'model' (JAX's sequence parallelism): DTensor
    on torch 2.11 cannot flatten [B, S] into the matmul's rows with S
    cut, and JAX's compiler inserts the same all-gather; for the same
    reason the gradient of every branch output that joins the residual is
    gathered over the sequence (`gather_grad`);
  * `layers.attn_qkv`: a q/k/v projection whose output dim is cut over
    'model' into shards that are not whole heads (H or KH not divisible by
    the model-axis size: 8 KV heads over 16) is gathered before the
    [B, S, H*hd] -> [B, S, H, hd] split;
  * `layers.decode_attention`: q's heads cut over 'model' finer than whole
    GQA groups (KH not divisible by the shard count) are gathered before
    the [B, H, hd] -> [B, KH, G, hd] split.
Other placement choices: attention, the SSD scan and the MoE run per
shard under `local_map` (`local_map` below); the cross entropy's label
logit is a masked sum on DTensors (`layers._xent_sums`); the recurrent
decode constrains the SSM state to its cache spec (`mamba2.block_decode`);
`constrain` leaves a dim its axes do not divide replicated; and a two-pod
mesh computes on `spmd_mesh`.

Policy summary (axes: optional 'pod', 'data', 'model'):
  * 2-D weights [in, out]          -> ('data', 'model')    (ZeRO-FSDP x TP)
  * embed [V, d]                   -> ('model', None)      (vocab-sharded)
  * unembed [d, V]                 -> ('data', 'model')
  * MoE expert weights [E, in, out]-> (None, None, 'model')
  * 1-D params (norms, biases)     -> replicated
  * batch dims                     -> ('pod', 'data') when divisible
  * decode KV caches               -> batch over dp, seq over 'model'
                                      (B==1: seq over ('data','model'))

Stacked layer dims (leading L) are never sharded.  All rules check
divisibility and fall back to replication, so specs on a mesh of size 1
are all replicated.
"""
from __future__ import annotations

import dataclasses
import math
import re

import torch


@dataclasses.dataclass(frozen=True)
class AxisEnv:
    """Names + sizes of the mesh axes in play ((1,)-sized axes => no mesh)."""

    data: tuple[str, ...] = ("data",)   # FSDP / batch axes ('pod','data')
    model: str = "model"
    data_size: int = 1
    model_size: int = 1
    mesh: object = dataclasses.field(default=None, compare=False, hash=False)

    @property
    def dp(self):
        return self.data if self.data_size > 1 else None

    def mp(self, dim: int):
        return self.model if self.model_size > 1 and dim % self.model_size == 0 \
            else None

    def fsdp(self, dim: int):
        if self.data_size > 1 and dim % self.data_size == 0:
            return self.data if len(self.data) > 1 else self.data[0]
        return None

    def flat(self, dim: int):
        """All mesh axes as one flattened TP axis (weight-stationary
        serving); falls back to 'model' then replication."""
        total = self.data_size * self.model_size
        if total > 1 and dim % total == 0:
            return (*self.data, self.model)
        return self.mp(dim)


def axis_env_from_mesh(mesh) -> AxisEnv:
    """The AxisEnv of a `DeviceMesh`: 'pod' and 'data' are the data axes,
    'model' the tensor-parallel one (a merged dim of `spmd_mesh` counts for
    each axis it holds)."""
    names = tuple(mesh.mesh_dim_names)
    data = tuple(a for n in names for a in n.split(".")
                 if a in ("pod", "data"))
    data_size = math.prod(size for n, size in zip(names, mesh.shape)
                          if set(n.split(".")) & {"pod", "data"})
    model_size = math.prod(size for n, size in zip(names, mesh.shape)
                           if "model" in n.split("."))
    return AxisEnv(data=data or ("data",), model="model",
                   data_size=data_size, model_size=model_size, mesh=mesh)


def spmd_mesh(mesh):
    """The mesh DTensor computes on: `mesh` itself, or, when it has more
    than one data axis ('pod' and 'data'), the same ranks as a mesh whose
    first dim merges them (named "pod.data").  Every spec names the data
    axes together, major first, so each rank holds the same block on both
    (rank (p, d) holds block p * n_data + d).  DTensor plans a
    redistribution of a strided shard by a graph search over the
    placements of every mesh dim, which on the (2, 16, 16) mesh made a
    dry-run's train step about 25 times slower than on the merged
    (32, 16) one.  The merged mesh is built once per mesh."""
    names = tuple(mesh.mesh_dim_names)
    data = [j for j, n in enumerate(names) if n in ("pod", "data")]
    if len(data) < 2:
        return mesh
    cached = getattr(mesh, "_repro_spmd_mesh", None)
    if cached is None:
        from torch.distributed.device_mesh import DeviceMesh
        if data != list(range(len(data))):
            raise ValueError(f"data axes must lead the mesh: {names}")
        ranks = mesh.mesh.reshape(-1, *mesh.mesh.shape[len(data):])
        cached = DeviceMesh(mesh.device_type, ranks, mesh_dim_names=(
            ".".join(names[j] for j in data), *names[len(data):]))
        mesh._repro_spmd_mesh = cached
    return cached


CPU_ENV = AxisEnv()  # sizes 1 -> every spec collapses to replicated


def spec(*entries) -> tuple:
    """A spec tuple; a one-name tuple entry becomes the bare name, as in
    JAX's PartitionSpec."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


# ---------------------------------------------------------------------------
# parameter specs by path
# ---------------------------------------------------------------------------

_REPLICATED_2D = re.compile(r"conv_|router")


def _leaf_spec(path: str, shape, ax: AxisEnv) -> tuple:
    nd = len(shape)
    if nd <= 1:
        return spec()
    if "unembed" in path:                       # must precede the embed rule
        return spec(ax.fsdp(shape[0]), ax.mp(shape[1]))
    if "embed" in path and "patch" not in path and "frame" not in path:
        # [V, d] vocab-sharded
        return spec(ax.mp(shape[0]), None)
    if _REPLICATED_2D.search(path):
        return (None,) * nd
    if nd == 2:
        return spec(ax.fsdp(shape[0]), ax.mp(shape[1]))
    if nd == 3:
        # stacked per-layer [L, in, out] or expert [E, in, out]
        if "expert" in path:
            return spec(None, None, ax.mp(shape[2]))
        return spec(None, ax.fsdp(shape[1]), ax.mp(shape[2]))
    if nd == 4:
        # stacked experts [L, E, in, out]
        return spec(None, None, None, ax.mp(shape[3]))
    return (None,) * nd


def _leaf_spec_serve_tp(path: str, shape, ax: AxisEnv) -> tuple:
    """Weight-stationary serving: shard every weight's OUT dim over the
    flattened mesh (pure TP) so decode never all-gathers weights."""
    nd = len(shape)
    if nd == 1:
        return spec(ax.flat(shape[0]))
    if nd == 0:
        return ()
    if "embed" in path and "patch" not in path and "frame" not in path:
        return spec(ax.flat(shape[0]), None)
    return spec(*(None,) * (nd - 1), ax.flat(shape[-1]))


def _keystr(path: tuple) -> str:
    """JAX's `keystr` of a dict path: "['layers']['wq']"."""
    return "".join(f"[{k!r}]" for k in path)


def param_specs(params_abstract, ax: AxisEnv, mode: str = "train"):
    """Nested dict of tensors (meta or real) -> the same nesting of specs.

    mode='train': 2-D ZeRO-FSDP x TP (the baseline everywhere).
    mode='serve_tp': flattened-mesh weight-stationary TP.
    """
    fn = _leaf_spec if mode == "train" else _leaf_spec_serve_tp

    def visit(path, tree):
        if isinstance(tree, dict):
            return {k: visit(path + (k,), v) for k, v in tree.items()}
        return fn(_keystr(path), tuple(tree.shape), ax)
    return visit((), params_abstract)


# ---------------------------------------------------------------------------
# placement over a DeviceMesh (DTensor)
# ---------------------------------------------------------------------------

# the replicate-before sites (see the module docstring)
REPLICATE_BEFORE = (
    "every projection's normed input (attention, MLP/MoE, unembedding; "
    "mamba2's conv tail; zamba2's shared block): the sequence, cut over "
    "'model' by the residual's constraint",
    "every branch output's gradient (attention, MLP/MoE, the mamba2 "
    "block, zamba2's shared block) before it leaves the residual: the "
    "sequence",
    "layers.attn_qkv: q/k/v projection dim before the head split, when H "
    "or KH is not a multiple of the model-axis size",
    "layers.decode_attention: q heads before the GQA split, when KH is not "
    "a multiple of the heads' shard count",
)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def placements(spec: tuple, mesh) -> list:
    """A spec tuple -> one DTensor placement per mesh dim.  A tuple entry
    shards its tensor dim over each named mesh dim, in the mesh's order
    (major first), so rank (p, d) holds block p * n_data + d as in JAX; on
    a merged dim of `spmd_mesh` the axes it holds shard once."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    dim_of = {a: j for j, n in enumerate(names) for a in n.split(".")}
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [dim_of[a] for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for j in idx:
            out[j] = Shard(i)
    return out


def place(x, spec: tuple, mesh):
    """One tensor on `mesh` by `spec`: `distribute_tensor` for a plain
    tensor (every rank passes the same global value and keeps its own
    block, with no communication), `redistribute` for a DTensor."""
    from torch.distributed.tensor import distribute_tensor
    pl = placements(spec, mesh)
    if is_dtensor(x):
        return x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map2(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def distribute(tree, spec_tree, mesh):
    """A nested dict / list of tensors placed leaf by leaf by the same
    nesting of spec tuples."""
    return _map2(lambda x, s: place(x, s, mesh), tree, spec_tree)


def _live(x) -> bool:
    return is_dtensor(x) and math.prod(x.device_mesh.shape) > 1


def constrain(x, *spec):
    """with_sharding_constraint: redistribute a DTensor on a mesh larger
    than one device to `spec`; the identity on a plain tensor (one card).
    An entry whose axes do not divide its dim (the batch of 1 of long_500k
    over 'data') leaves that dim replicated: JAX pads such a shard, and
    DTensor cannot reshape an uneven one."""
    if not _live(x):
        return x
    mesh = x.device_mesh

    def divides(entry, n):
        # the mesh dims the entry names (a merged dim of spmd_mesh once)
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = {j for j, name in enumerate(mesh.mesh_dim_names)
                if set(axes) & set(name.split("."))}
        return n % math.prod(mesh.shape[j] for j in dims) == 0
    spec = tuple(e if e is None or divides(e, x.shape[i]) else None
                 for i, e in enumerate(spec))
    return x.redistribute(mesh, placements(spec, mesh))


def reduce_partial(x):
    """A DTensor with its Partial placements reduced (to Replicate); the
    identity on a plain tensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate
    pl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: a
    shard body's autograd may give a permuted local gradient, and DTensor
    views a local tensor by the global tensor's (contiguous) strides.
    Written for torch.func too (the sensitivity maps' grad and jvp): its
    tangent passes through."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()

    @staticmethod
    def jvp(ctx, t):
        return t


def contiguous_grads(*xs):
    """xs, whose gradients come back contiguous (see _ContiguousGrad).  The
    one-card paths of the `local_map` bodies call it too, so that a step
    placed on a one-rank mesh reduces the same gradient layouts as the
    unplaced step, bit for bit."""
    return tuple(_ContiguousGrad.apply(x) if x.requires_grad else x
                 for x in xs)


def local_map(body, mesh, in_placements, out_placements):
    """`torch.distributed.tensor.experimental.local_map` (JAX's shard_map):
    body runs on each rank's local shards of the inputs, redistributed to
    in_placements first; its outputs are wrapped by out_placements.

    The gradient of an input replicated over a mesh dim on which some
    output is cut (Shard or Partial) is Partial there: each rank of that
    dim did its own part of the work, and the input's gradient is the sum
    of their parts.  Over a dim where every output is replicated the ranks
    did the same work, and the gradient stays replicated."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map as lm
    outs = [out_placements] if not isinstance(out_placements[0],
                                              (list, tuple)) \
        else out_placements
    split = [any(not isinstance(o[j], Replicate) for o in outs)
             for j in range(mesh.ndim)]
    grad_placements = tuple(
        [Partial() if split[j] and isinstance(p, Replicate) else p
         for j, p in enumerate(pl)] for pl in in_placements)

    return lm(lambda *args: body(*contiguous_grads(*args)),
              out_placements=out_placements,
              in_placements=in_placements,
              in_grad_placements=grad_placements, device_mesh=mesh,
              redistribute_inputs=True)


def gather(x, dim: int):
    """x with tensor dim `dim` replicated over every mesh dim that cuts it
    (a replicate-before); the identity on a plain tensor."""
    if not _live(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    d = dim % x.ndim
    pl = [Replicate() if isinstance(p, Shard) and p.dim == d else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


class _GatherGrad(torch.autograd.Function):
    """The identity, whose backward gathers its gradient's dim `dim`."""

    @staticmethod
    def forward(x, dim):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return gather(g, ctx.dim), None


def gather_grad(x, dim: int):
    """x, whose gradient comes back with tensor dim `dim` gathered (a
    replicate-before of the backward): a branch's output joins the
    residual, whose gradient is cut over the sequence, and torch 2.11's
    DTensor cannot flatten [B, S] into the branch's matmul rows with S
    cut.  The identity on a plain tensor."""
    return _GatherGrad.apply(x, dim) if _live(x) else x


def whole_blocks(x, dim: int, n_blocks: int):
    """x, with tensor dim `dim` gathered first when it is cut into shards
    that do not hold whole blocks of dim / n_blocks: a reshape that splits
    the dim into [n_blocks, dim / n_blocks] has no DTensor placement then.
    The identity on a plain tensor."""
    if not _live(x):
        return x
    from torch.distributed.tensor import Shard
    d = dim % x.ndim
    n = math.prod(size for p, size in zip(x.placements, x.device_mesh.shape)
                  if isinstance(p, Shard) and p.dim == d)
    return x if n_blocks % n == 0 else gather(x, dim)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------


def batch_spec(ax: AxisEnv, batch_size: int, extra_dims: int = 1) -> tuple:
    """Spec over the leading batch dim; replicate when indivisible."""
    dp = ax.dp if (ax.dp and batch_size % ax.data_size == 0) else None
    return spec(dp, *(None,) * extra_dims)


def kv_cache_spec(ax: AxisEnv, batch_size: int) -> tuple:
    """[B, S, KH, hd]: batch over dp, seq over model; B==1 -> seq over
    (data..., model)."""
    if batch_size == 1:
        seq = (*ax.data, ax.model) if ax.data_size > 1 else ax.model
        return spec(None, seq if ax.model_size > 1 else None, None, None)
    dp = ax.dp if batch_size % ax.data_size == 0 else None
    mp = ax.model if ax.model_size > 1 else None
    return spec(dp, mp, None, None)


def ssm_state_spec(ax: AxisEnv, batch_size: int, n_heads: int) -> tuple:
    """[B, nh, hd, state]: batch over dp, heads over model."""
    dp = ax.dp if (batch_size % ax.data_size == 0 and batch_size > 1) else None
    return spec(dp, ax.mp(n_heads), None, None)


def conv_state_spec(ax: AxisEnv, batch_size: int, ch: int) -> tuple:
    """[B, w-1, ch]."""
    dp = ax.dp if (batch_size % ax.data_size == 0 and batch_size > 1) else None
    return spec(dp, None, ax.mp(ch))
