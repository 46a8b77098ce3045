"""Train, prefill and decode steps, input/cache sharding specs, and the
steps placed on a `DeviceMesh` (the JAX package's `repro.launch.steps`,
used by train.py and launch/dryrun.py).

The steps are plain functions on trees of tensors: the train step is
`models.value_and_grad(model.loss_fn)`, then `cosine_lr` and
`adamw_update`, and returns `{"loss", "grad_norm", "lr"}` as the
reference's does; prefill and decode call the model.  The specs are plain
tuples normalised like `PartitionSpec` (`models/sharding.py`).

`named(mesh, specs)` is the tree of DTensor placements, the counterpart of
a tree of `NamedSharding`s.  `jit_train_step`, `jit_prefill_step` and
`jit_decode_step` are the reference's `jax.jit(..., in_shardings,
out_shardings)`: each places its inputs by the in-specs (`distribute_tensor`,
or `redistribute` for an input that is already a DTensor), runs the same
step body under `implicit_replication` (a plain tensor the body makes,
such as `torch.arange` positions, counts as replicated), and places the
outputs by the out-specs; an out-spec of None (JAX's "the compiler
chooses") keeps DTensor's placement and reduces a Partial one.  Every leaf
that comes out is a DTensor on the mesh.  "jit" stays in the names only so
that a reader finds the counterpart: nothing is compiled (no
`torch.compile`), and donation has no counterpart, so the inputs stay
valid.  On a two-pod mesh the steps compute on `sharding.spmd_mesh`, the
same ranks with 'pod' and 'data' merged into one dim, which holds the same
blocks (`step.mesh`).
"""
from __future__ import annotations

from repro_torch import models
from repro_torch.models import Model
from repro_torch.models import sharding as shd
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.schedule import cosine_lr


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------


def _map_with_path(fn, tree, path=()):
    """fn(keystr, leaf) over a nested dict / list / tuple, keeping its
    nesting; keystr is JAX's `keystr` of the leaf's path ("['k'][0]")."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (f"[{k!r}]",))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn("".join(path), tree)


def batch_specs(batch_tree, ax: shd.AxisEnv):
    """Input batch leaves: leading dim over dp, rest replicated."""
    def spec(_, leaf):
        if not tuple(leaf.shape):
            return shd.spec()
        b = leaf.shape[0]
        dp = ax.dp if (ax.dp and b % ax.data_size == 0 and b > 1) else None
        return shd.spec(dp, *([None] * (len(leaf.shape) - 1)))
    return _map_with_path(spec, batch_tree)


def cache_specs(cfg, cache_tree, ax: shd.AxisEnv, batch: int):
    """Per-layer cache buffers: conv [B, w-1, ch], ssm [B, nh, hd, st],
    k/v [B, S, KH, hd]."""
    def visit(name, leaf):
        if "conv" in name:
            return shd.conv_state_spec(ax, batch, leaf.shape[-1])
        if "ssm" in name:
            return shd.ssm_state_spec(ax, batch, cfg.ssm_heads)
        if len(leaf.shape) == 4:   # k/v and attn_k/attn_v [B, S, KH, hd]
            return shd.kv_cache_spec(ax, batch)
        return shd.spec()
    return _map_with_path(visit, cache_tree)


def opt_specs(param_spec_tree):
    return {"m": param_spec_tree, "v": param_spec_tree, "step": shd.spec()}


def _map_specs(fn, spec_tree):
    """fn over the spec tuples (leaves) of a nested dict / list."""
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [_map_specs(fn, v) for v in spec_tree]
    return fn(spec_tree)


def named(mesh, spec_tree):
    """Spec tree -> the same tree of DTensor placement lists."""
    return _map_specs(lambda s: shd.placements(s, mesh), spec_tree)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    warmup: int = 100, total_steps: int = 10_000):
    """(params, opt_state, batch) -> (params, opt_state, metrics): one
    AdamW step at the cosine schedule's lr for opt_state["step"]."""
    loss_and_grad = models.value_and_grad(model.loss_fn)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grad(params, batch)
        lr = cosine_lr(opt_state["step"], opt_cfg.lr, warmup, total_steps)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                opt_cfg, lr=lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}
    return train_step


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch)
    return decode_step


# ---------------------------------------------------------------------------
# steps placed on a DeviceMesh
# ---------------------------------------------------------------------------


def _settle(x, mesh):
    """An output leaf under an out-spec of None: a plain tensor becomes a
    replicated DTensor, a Partial placement is reduced."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return shd.reduce_partial(x)


def _place_out(tree, spec_tree, mesh):
    tree = _map_leaves(lambda x: _settle(x, mesh), tree)
    return tree if spec_tree is None else shd.distribute(tree, spec_tree,
                                                         mesh)


def _map_leaves(fn, tree):
    """fn over the tensors of a nested dict / list / tuple (None stays, as
    the encoder's missing cache)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _placed(fn, mesh, in_specs, out_specs):
    """fn with its positional inputs placed by in_specs and its outputs by
    out_specs (a tuple, one entry per output; None leaves the placement to
    DTensor)."""
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = shd.spmd_mesh(mesh)

    def step(*args):
        args = [shd.distribute(a, s, mesh) for a, s in zip(args, in_specs)]
        with implicit_replication():
            out = fn(*args)
        return tuple(_place_out(o, s, mesh) for o, s in zip(out, out_specs))
    step.in_specs, step.out_specs, step.mesh = in_specs, out_specs, mesh
    return step


def jit_train_step(model: Model, mesh, opt_cfg: AdamWConfig, batch_tree):
    """The production train step placed on `mesh`: params and AdamW state
    by the model's specs in and out, the batch over dp, the metrics
    replicated."""
    ax = model.ax
    pspecs = model.param_specs()
    ospecs = opt_specs(pspecs)
    bspecs = batch_specs(batch_tree, ax)
    return _placed(make_train_step(model, opt_cfg), mesh,
                   (pspecs, ospecs, bspecs), (pspecs, ospecs, None))


def jit_prefill_step(model: Model, mesh, batch_tree):
    ax = model.ax
    pspecs = model.param_specs()
    bspecs = batch_specs(batch_tree, ax)
    return _placed(make_prefill_step(model), mesh, (pspecs, bspecs),
                   (None, None))


def jit_decode_step(model: Model, mesh, cache_tree, batch_tree, batch: int,
                    param_mode: str = "train"):
    ax = model.ax
    pspecs = model.param_specs(mode=param_mode)
    cspecs = cache_specs(model.cfg, cache_tree, ax, batch)
    bspecs = batch_specs(batch_tree, ax)
    return _placed(make_decode_step(model), mesh, (pspecs, cspecs, bspecs),
                   (None, cspecs))
