"""Kernel-launch timing hooks for `kernels/ops.py` (the JAX package's
`repro.obs.hooks`), on while obs is enabled (`obs.configure`), and only
then: a torch.profiler session turns the spans on, never these hooks.

  * `timed_kernel` wraps one kernel op of `kernels/ops.py`.  It
    synchronizes the op's device before the call and after it, so the
    time is the op's own and not queued earlier work, under a
    `torch.profiler.record_function` (and NVTX range) named `he.<op>`.  It
    records `kernel_op_launches_total{op, backend}`, the
    `kernel_op_seconds` histogram and an `he.<op>` span with cat="kernel";
    `backend` is "cuda" for a CUDA tensor (the kernel) and "ref" for a CPU
    tensor (the plain version), and the NTTs stamp the tuner's resolved
    `KernelConfig` into the span.  The JAX package also names ops under a
    jit trace (`jax.named_scope`, `kernel_op_traces_total`); the port is
    never traced, so it has no counterpart.
  * `kernel_launch` is a span around the call site of a compound dispatch
    (a `ShardedHe` op, the stream flush's accumulate): wall time of one
    launch, synchronized on its outputs' devices at exit, keyed by op name.

With obs disabled every hook returns at once: no synchronize, no series,
no span, and `ops.launch_counts()` unchanged.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


def kernel_hooks_enabled() -> bool:
    """Gate for the ops hook: `configure(enabled=True)` alone."""
    return _trace.enabled()


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of every tensor in x: a tensor, or a dict, list,
    tuple or dataclass (a Ciphertext, a BlockGrid) holding tensors."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), out)
    return out


def _synchronize(x) -> None:
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)


def timed_kernel(op: str, impl, *args, config=None):
    """Run impl(*args), one kernel op, with timing (see module docstring).
    The op's device is its first tensor argument's.  `config` is the
    tuner's resolved KernelConfig of an NTT dispatch."""
    x = next(a for a in args if isinstance(a, torch.Tensor))
    backend = "cuda" if x.is_cuda else "ref"
    _synchronize(x)
    tracer = _trace.get_tracer()
    ts0 = tracer.now_us()
    t0 = time.perf_counter()
    with _trace.annotate(f"he.{op}"):
        out = impl(*args)
        _synchronize(x)
    dt = time.perf_counter() - t0
    _metrics.REGISTRY.counter("kernel_op_launches_total", op=op,
                              backend=backend).inc()
    _metrics.REGISTRY.histogram("kernel_op_seconds", op=op,
                                backend=backend).observe(dt)
    span_args = {"op": op, "backend": backend, "token": backend}
    if config is not None:
        span_args["config"] = config.to_json()
    tracer.emit_complete(f"he.{op}", ts0, dt * 1e6, cat="kernel",
                         args=span_args)
    return out


class _KernelLaunch:
    """Span + histogram around one compound launch (synchronizes on exit)."""

    __slots__ = ("op", "args", "_ts0", "_t0", "_out")

    def __init__(self, op: str, args: dict):
        self.op = op
        self.args = args
        self._out = None

    def done(self, out):
        """Hand the launch its outputs so __exit__ can wait for them."""
        self._out = out
        return out

    def __enter__(self) -> "_KernelLaunch":
        self._ts0 = _trace.get_tracer().now_us()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._out is not None and exc_type is None:
            _synchronize(self._out)
        dt = time.perf_counter() - self._t0
        backend = self.args.get("backend", "")
        _metrics.REGISTRY.counter("kernel_launches_total", op=self.op,
                                  backend=backend).inc()
        _metrics.REGISTRY.histogram("kernel_launch_seconds", op=self.op,
                                    backend=backend).observe(dt)
        _trace.get_tracer().emit_complete(
            f"he.{self.op}", self._ts0, dt * 1e6, cat="kernel",
            args={"op": self.op, **self.args})


class _NullLaunch:
    __slots__ = ()

    def done(self, out):
        return out

    def __enter__(self) -> "_NullLaunch":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NULL_LAUNCH = _NullLaunch()


def kernel_launch(op: str, **args):
    """Context manager timing one compound launch.

    Usage::

        with obs.kernel_launch("sharded.weighted_sum", n_clients=3) as kl:
            out = kl.done(body(...))

    `kl.done(out)` registers the outputs; exit synchronizes their devices
    and records the wall time into `kernel_launch_seconds` and a
    cat="kernel" trace event.  No-op when obs is disabled.
    """
    if not _trace.enabled():
        return _NULL_LAUNCH
    return _KernelLaunch(op, dict(args))


def maybe_block(x):
    """Synchronize x's devices when obs is enabled, so span durations mean
    'work finished', not 'dispatch returned'; returns x."""
    if _trace.enabled():
        _synchronize(x)
    return x
