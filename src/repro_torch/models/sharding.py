"""Sharding policy as metadata: parameter/batch/cache specs for a
production mesh (the JAX package's `models/sharding.py`, DESIGN.md §4).

A spec is a plain tuple with one entry per tensor dimension: an axis name,
a tuple of axis names, or None (replicated).  On one card every spec
collapses to replication and nothing here moves a tensor; `constrain` is
the identity.  Placing parameters over several cards by these specs waits
for the multi-card backend (ROADMAP Queue A item 6), and so does
`axis_env_from_mesh`.

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
divisibility and fall back to replication.
"""
from __future__ import annotations

import dataclasses
import re


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


def constrain(x, *_spec):
    """The identity: one card has nothing to constrain."""
    return x


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
