"""Unified model API over all architecture families (dense, moe, vlm,
encoder: `transformer`; ssm: `mamba2`; hybrid: `zamba2`), the JAX
package's `repro.models`.

``build_model(cfg, ax, device)`` returns a ``Model`` (``ax`` an
``AxisEnv``; one from ``axis_env_from_mesh(mesh)`` carries a
``DeviceMesh``, and the model's sharding constraints and ``local_map``
paths then act on the DTensors that ``launch.steps.jit_*`` place on it):
  init(gen) -> params                    (real weights drawn from gen)
  init_abstract() -> params              (meta tensors; no allocation)
  loss_fn(params, batch) -> scalar
  prefill(params, batch, cache_len) -> (logits, cache)
  decode_step(params, cache, batch) -> (logits, cache)   (causal families)
  abstract_cache(batch, cache_len) -> cache of meta tensors
  params() -> the module's parameters as a nested dict

`module` is an `nn.Module` whose parameters are the JAX package's leaves,
stacked on the leading L axis and named as JAX names them (`embed`,
`layers.wq` of [L, d, H*hd], `ln_f`, ...), so `core.packing.flatten_params`
lays out the same flat vector in both packages.  Its forward is the loss;
`loss_fn(params, batch)` runs it through `torch.func.functional_call` with
the given tree in place of the module's parameters.  `init` sets the
module's parameters to the new tree; before it they are on the meta device.

Gradients come from `value_and_grad` (torch.autograd): torch.func.grad
refuses the saved-tensor hooks of cfg.remat's checkpointing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from repro_torch.core import packing
from repro_torch.core.ckks.params import resolve_device
from repro_torch.models import mamba2, transformer, zamba2
from repro_torch.models.config import ModelConfig
from repro_torch.models import sharding
from repro_torch.models.sharding import (
    AxisEnv, CPU_ENV, axis_env_from_mesh, param_specs)

TRANSFORMER_FAMILIES = ("dense", "moe", "vlm", "encoder")


def family_module(cfg: ModelConfig):
    """The module holding cfg's family: init_abstract, loss_fn,
    forward_logits, prefill, decode_step and abstract_cache."""
    if cfg.family in TRANSFORMER_FAMILIES:
        return transformer
    if cfg.family == "ssm":
        return mamba2
    if cfg.family == "hybrid":
        return zamba2
    raise ValueError(f"unknown family {cfg.family}")


def _named(tree, prefix=""):
    """Nested dict -> {"layers.wq": leaf, ...} (nn.Module parameter names)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


class ModelModule(nn.Module):
    """Holds the parameter tree; forward(batch) is the training loss of
    cfg's family."""

    def __init__(self, cfg: ModelConfig, ax: AxisEnv, tree: dict):
        super().__init__()
        self.cfg, self.ax = cfg, ax
        self.family = family_module(cfg)
        self.set_tree(tree)

    def set_tree(self, tree: dict, _owner=None) -> None:
        """Make the tree's leaves this module's parameters (same storage),
        one child module per nested dict."""
        owner = self if _owner is None else _owner
        for k, v in tree.items():
            if isinstance(v, dict):
                child = getattr(owner, k, None)
                if not isinstance(child, nn.Module):
                    child = nn.Module()
                    owner.add_module(k, child)
                self.set_tree(v, child)
            else:
                owner.register_parameter(k, nn.Parameter(v))

    def tree(self, detach: bool = False) -> dict:
        def visit(mod):
            out = {k: (p.detach() if detach else p)
                   for k, p in mod.named_parameters(recurse=False)}
            for k, child in mod.named_children():
                out[k] = visit(child)
            return out
        return visit(self)

    def forward(self, batch):
        return self.family.loss_fn(self.tree(), batch, self.cfg, self.ax)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    ax: AxisEnv
    device: torch.device
    module: ModelModule
    init: Callable
    loss_fn: Callable
    prefill: Callable | None
    decode_step: Callable | None
    abstract_cache: Callable | None

    def params(self) -> dict:
        """The module's parameters as the JAX-layout nested dict (detached
        views: they share the module's storage)."""
        return self.module.tree(detach=True)

    def init_abstract(self) -> dict:
        return family_module(self.cfg).init_abstract(self.cfg)

    def param_specs(self, mode: str = "train"):
        return param_specs(self.init_abstract(), self.ax, mode=mode)


def build_model(cfg: ModelConfig, ax: AxisEnv = CPU_ENV,
                device=None) -> Model:
    """The model of `cfg` on `device` (CUDA unless the caller names
    another; raises without one)."""
    fam = family_module(cfg)
    dev = resolve_device(device)
    module = ModelModule(cfg, ax, fam.init_abstract(cfg))
    init_tree = transformer.init if fam is transformer else fam.init_model

    def init(gen: torch.Generator) -> dict:
        module.set_tree(init_tree(cfg, gen, dev))
        return module.tree(detach=True)

    def loss(params, batch):
        return torch.func.functional_call(module, _named(params), (batch,))

    if cfg.family == "encoder":
        # encoder inference = one bidirectional forward, no cache
        enc_fwd = lambda p, b, cache_len=None: (
            transformer.forward_logits(p, b, cfg, ax)[0], None)
        return Model(cfg, ax, dev, module, init, loss, prefill=enc_fwd,
                     decode_step=None, abstract_cache=None)
    if fam is mamba2:
        # the recurrent cache has no length
        abstract_cache = lambda batch, cache_len=None, dtype=None: (
            mamba2.abstract_cache(cfg, batch, dtype or cfg.dtype))
    else:
        abstract_cache = lambda batch, cache_len, dtype=None: (
            fam.abstract_cache(cfg, batch, cache_len, dtype or cfg.dtype))
    return Model(
        cfg, ax, dev, module, init, loss,
        prefill=lambda p, b, cache_len=None: fam.prefill(
            p, b, cfg, ax, cache_len),
        decode_step=lambda p, c, b: fam.decode_step(p, c, b, cfg, ax),
        abstract_cache=abstract_cache,
    )


def value_and_grad(fn: Callable) -> Callable:
    """fn(params, *args) -> scalar  ==>  (params, *args) -> (value, grads),
    grads a tree like params: jax.value_and_grad over the first argument,
    by torch.autograd on detached copies of the leaves (same storage)."""
    def wrapped(params, *args):
        leaves = [t.detach().requires_grad_() for t in
                  packing.tree_leaves(params)]
        spec = packing.make_flat_spec(params)
        with torch.enable_grad():
            value = fn(packing.unflatten_leaves(leaves, spec), *args)
            # a leaf the function does not read (the encoder's embed) gets
            # zeros, as in JAX
            grads = torch.autograd.grad(value, leaves, allow_unused=True,
                                        materialize_grads=True)
        return value.detach(), packing.unflatten_leaves(list(grads), spec)
    return wrapped
