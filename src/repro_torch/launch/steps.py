"""Train, prefill and decode steps and input/cache sharding specs (the
JAX package's `repro.launch.steps`, used by train.py).

The steps are plain functions on trees of tensors: the train step is
`models.value_and_grad(model.loss_fn)`, then `cosine_lr` and
`adamw_update`, and returns `{"loss", "grad_norm", "lr"}` as the
reference's does; prefill and decode call the model.  The specs are
metadata, as in `models/sharding.py`: plain tuples normalised like
`PartitionSpec`, which on one card all collapse to replication.

`named` and the `jit_*` wrappers of the reference place each tree on a
device mesh by these specs.  They wait for model sharding over several
cards (ROADMAP Queue A item 6); nothing here moves a tensor.
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
