"""Shape-keyed autotuner: launch configurations swept on the device, winners
cached by shape, resolved per NTT dispatch.

The port's counterpart of the JAX package's `kernels/tune.py` (DESIGN.md
§12).  A configuration changes launch geometry only, never arithmetic, so
every candidate gives the same bits; the tuner chooses between two
hand-written kernels and never between a kernel and the plain version (the
tensor's device decides that, as everywhere in the port).

  * **config**: `KernelConfig(block_b, ntt4_split, radix)`, with the JAX
    package's fields and JSON.  Only `ntt4_split` changes a launch: both
    NTT kernels run the register passes of `csrc/ntt_pass.cuh`, one thread
    block a (row, limb) pair, so `block_b` and `radix` are checked (a cache
    may name them) and change no launch; `radix` only groups the plain
    version's stages on the CPU.  Only the NTT ops are tuned: the other
    five kernels have no geometry parameter, so they are not ops of the
    tuner.
  * **backends**: "flat" is the flat kernel of `csrc/ntt.cu`, "ntt4" the
    4-step kernels of `csrc/ntt4.cu`.
  * **cache**: winners keyed `op|N<n>|L<l>|B<b>|<platform>`, the platform
    being the tensor's device type (`cuda` or `cpu`).  It is loaded only by
    an explicit `load_cache(path)`: no environment variable is read.
    Entries for another platform, unknown ops, backends the port does not
    have (the JAX package's `ref`, `pallas`, `pallas4`) or malformed configs
    (one a kernel would refuse included) are skipped one by one, so a JAX
    cache never steers the port.
  * **resolve**: a hit gives the cached (backend, config), a miss the flat
    kernel at its default: exactly the dispatch of an empty cache.
  * **sweep**: `sweep_op` times every candidate that the roofline model
    (the H100's 3.35 TB/s, one launch a dispatch) does not rule out.  The
    default is never pruned and always measured, so the winner's time is
    at most the default's.  The space is the flat kernel and the 4-step
    kernel at each `ntt4_split_candidates(N)` split (four candidates at
    N=8192), every one a different launch: each (split, radix, block_b)
    that named the same launch would only time one kernel twice.  The
    pruning is inert in this space: the model gives every split the same
    time (the flat kernel's passes plus the twist's corr read, 1.875
    against the flat kernel's 1.375 times the memory time at N=8192),
    under PRUNE_RATIO, so every candidate is measured.  The model is an
    order, not a time (chip_smoke.py measures both kernels beside their
    bound).
  * **telemetry** (`repro_torch.obs`): each measured candidate's time in
    `tune_candidate_seconds{op, backend}`, each sweep in
    `tune_sweeps_total{op}`, each unreadable cache file in
    `tune_cache_load_errors_total`.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
import warnings

import torch

from repro_torch import obs
from repro_torch.core.ckks import params as _params
from repro_torch.kernels import ntt as _ntt

OPS = ("ntt_fwd", "ntt_inv")
BACKENDS = ("flat", "ntt4")
RADICES = (2, 4)   # a config's radix: the plain version's stage grouping
CACHE_VERSION = 1

# roofline pruning: a candidate modelled at more than PRUNE_RATIO x the best
# modelled candidate is skipped unmeasured
PRUNE_RATIO = 3.0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
LAUNCH_OVERHEAD_S = 5e-6    # one kernel launch a dispatch
STAGES_PER_PASS = 5         # ntt_pass.cuh's kLogElems: 32 residues a thread


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Launch geometry of one kernel invocation, never arithmetic.

    block_b: (row, limb) pairs a thread block in the JAX package's
      kernels, 1 .. ntt.MAX_BLOCK_B; the port's kernels run one a block.
    ntt4_split: (n1, n2) factorization of N, None = params.ntt4_split.
    radix: butterfly radix of the plain 4-step version's sub-transforms
      (2 or 4); the kernel's register passes have none.
    """

    block_b: int
    ntt4_split: tuple[int, int] | None = None
    radix: int = 2

    def to_json(self) -> dict:
        return {"block_b": self.block_b,
                "ntt4_split": list(self.ntt4_split)
                if self.ntt4_split else None,
                "radix": self.radix}

    @classmethod
    def from_json(cls, doc: dict) -> "KernelConfig":
        split = doc.get("ntt4_split")
        return cls(block_b=int(doc["block_b"]),
                   ntt4_split=tuple(int(x) for x in split) if split
                   else None,
                   radix=int(doc.get("radix", 2)))


def default_config(op: str) -> KernelConfig:
    """The config of a dispatch with no cache entry: the kernel's one
    geometry today (the flat NTT runs one (row, limb) pair a block)."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    return KernelConfig(block_b=1)


def default_platform() -> str:
    """The platform a cache is loaded for and saved from by default."""
    return "cuda" if torch.cuda.is_available() else "cpu"


# ---------------------------------------------------------------------------
# tuning cache
# ---------------------------------------------------------------------------


def shape_key(op: str, n: int, l: int, b: int, platform: str) -> str:
    """Cache key of one tuned point; shape-exact (no interpolation)."""
    return f"{op}|N{n}|L{l}|B{b}|{platform}"


@dataclasses.dataclass
class _CacheEntry:
    backend: str
    config: KernelConfig
    tuned_ms: float = float("nan")
    default_ms: float = float("nan")


_ENTRIES: dict[str, _CacheEntry] = {}
_GENERATION = 0          # bumped on every put, load and clear
_LOADED_PATH: str | None = None


def generation() -> int:
    """Monotonic counter of cache changes."""
    return _GENERATION


def n_entries() -> int:
    return len(_ENTRIES)


def clear_cache() -> None:
    """Drop every entry: every dispatch resolves to the flat default."""
    global _GENERATION, _LOADED_PATH
    _ENTRIES.clear()
    _LOADED_PATH = None
    _GENERATION += 1


def _validate(op: str, n: int, backend: str, config: KernelConfig) -> None:
    """Raise ValueError unless a kernel would run `config` at N=n: the
    rule `candidates` applies, so a cache never names a launch that the
    wrapper refuses."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {op}'s")
    if not 1 <= config.block_b <= _ntt.MAX_BLOCK_B or \
            config.radix not in RADICES:
        raise ValueError(f"bad config {config}")
    if n > 1 << _ntt.MAX_LOG_N:
        raise ValueError(f"N={n} is beyond the NTT kernels' 2**"
                         f"{_ntt.MAX_LOG_N}")
    split = config.ntt4_split
    if split is not None and (len(split) != 2 or split[0] * split[1] != n):
        raise ValueError(f"split {split} does not factor N={n}")
    if backend == "ntt4" and _ntt.smem_bytes(
            n, split or _params.ntt4_split(n)) > _ntt.MAX_SMEM_BYTES:
        raise ValueError(f"the 4-step kernel's shared memory at N={n} "
                         "exceeds one block's")


def put(op: str, n: int, l: int, b: int, platform: str, backend: str,
        config: KernelConfig, tuned_ms: float = float("nan"),
        default_ms: float = float("nan")) -> None:
    """Insert or overwrite one entry (sweep_op and by hand)."""
    global _GENERATION
    _validate(op, n, backend, config)
    _ENTRIES[shape_key(op, n, l, b, platform)] = _CacheEntry(
        backend=backend, config=config, tuned_ms=tuned_ms,
        default_ms=default_ms)
    _GENERATION += 1


def load_cache(path: str, platform: str | None = None) -> int:
    """Load a JSON cache, replacing the in-memory entries; returns the
    number of entries accepted for `platform` (default: `cuda` when a card
    is visible, else `cpu`).  Stale entries are skipped one by one; a
    missing file loads as empty, an unreadable one warns and loads as
    empty."""
    global _GENERATION, _LOADED_PATH
    platform = platform or default_platform()
    _ENTRIES.clear()
    _LOADED_PATH = path
    _GENERATION += 1
    try:
        with open(path) as f:
            raw = json.load(f).get("entries", {})
        items = list(raw.items())
    except FileNotFoundError:
        return 0
    except (OSError, json.JSONDecodeError, AttributeError) as e:
        obs.counter("tune_cache_load_errors_total").inc()
        warnings.warn(f"tuning cache {path!r} could not be loaded ({e!r}); "
                      "every dispatch runs its default", RuntimeWarning,
                      stacklevel=2)
        return 0
    for key, e in items:
        try:
            op, n_tag, _, _, key_platform = key.split("|")
            if key_platform != platform:
                continue
            config = KernelConfig.from_json(e["config"])
            _validate(op, int(n_tag[1:]), e["backend"], config)
            _ENTRIES[key] = _CacheEntry(
                backend=e["backend"], config=config,
                tuned_ms=float(e.get("tuned_ms", float("nan"))),
                default_ms=float(e.get("default_ms", float("nan"))))
        except (KeyError, ValueError, TypeError, AttributeError):
            continue
    return len(_ENTRIES)


def save_cache(path: str) -> None:
    """Write the in-memory entries, with the device they were tuned on."""
    platform = default_platform()
    doc = {
        "version": CACHE_VERSION,
        "meta": {
            "platform": platform,
            "device": torch.cuda.get_device_name(0)
            if platform == "cuda" else "cpu",
            "device_count": torch.cuda.device_count()
            if platform == "cuda" else 1,
        },
        "entries": {
            key: {"backend": e.backend, "config": e.config.to_json(),
                  "tuned_ms": e.tuned_ms, "default_ms": e.default_ms}
            for key, e in sorted(_ENTRIES.items())
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")


def resolve(op: str, n: int, l: int, b: int,
            platform: str) -> tuple[str, KernelConfig]:
    """(backend, config) of one dispatch: the cached winner, else the flat
    kernel at its default."""
    e = _ENTRIES.get(shape_key(op, n, l, b, platform))
    if e is not None:
        return e.backend, e.config
    return "flat", default_config(op)


def provenance() -> dict:
    """The tuner's state, for stamping into a result."""
    return {"generation": _GENERATION, "cache_path": _LOADED_PATH,
            "entries": len(_ENTRIES)}


# ---------------------------------------------------------------------------
# candidates and roofline pruning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Candidate:
    backend: str            # "flat" | "ntt4"
    config: KernelConfig


def candidates(op: str, n: int, l: int, b: int) -> list[Candidate]:
    """The swept space of one point, the default first: the flat kernel and
    the 4-step kernel at every `ntt4_split_candidates(N)`, the only field
    that changes its launch."""
    return [Candidate("flat", default_config(op))] + [
        Candidate("ntt4", KernelConfig(block_b=1, ntt4_split=split))
        for split in _params.ntt4_split_candidates(n)]


def _model_time_s(n: int, l: int, b: int, cand: Candidate) -> float:
    """Roofline estimate of one candidate: device-memory traffic (each
    element read and written once) over 3.35 TB/s, scaled by the register
    passes both kernels run (csrc/ntt_pass.cuh: at most 5 stages a pass,
    an eighth of the traffic each), plus, for the 4-step kernel, the
    twist's corr read (4 bytes an element, half the row's traffic), plus
    one launch.  It only has to be right in order: what is PRUNE_RATIO x
    the best estimate is not measured."""
    mem_s = 8 * b * l * n / HBM_BYTES_PER_S
    passes = math.ceil(math.log2(n) / STAGES_PER_PASS)
    scale = 1.0 + passes / 8.0
    if cand.backend == "ntt4":
        scale += 0.5
    return mem_s * scale + LAUNCH_OVERHEAD_S


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def _timeit(fn, device: torch.device, reps: int) -> float:
    """Mean seconds of fn() over reps calls after one warm-up call: CUDA
    events between synchronizes on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def _make_inputs(ctx, b: int, gen: torch.Generator) -> torch.Tensor:
    """Residues int32[b, L, N] of the context, drawn from `gen` on the
    context's device."""
    x = torch.randint(0, 1 << 30, (b, ctx.n_limbs, ctx.n_poly),
                      generator=gen, device=ctx.device, dtype=torch.int32)
    return x % ctx.device_tables.qs[:, None]


@dataclasses.dataclass
class SweepResult:
    op: str
    n: int
    l: int
    b: int
    platform: str
    winner: Candidate
    tuned_ms: float
    default_ms: float
    n_candidates: int
    n_pruned: int
    times_ms: dict = dataclasses.field(default_factory=dict)  # measured

    @property
    def speedup(self) -> float:
        return self.default_ms / self.tuned_ms if self.tuned_ms else 1.0

    def to_row(self) -> dict:
        return {"op": self.op, "n": self.n, "l": self.l, "b": self.b,
                "platform": self.platform,
                "backend": self.winner.backend,
                "config": self.winner.config.to_json(),
                "default_ms": self.default_ms, "tuned_ms": self.tuned_ms,
                "speedup": self.speedup,
                "candidates": self.n_candidates, "pruned": self.n_pruned}


def sweep_op(op: str, ctx, b: int, gen: torch.Generator, *,
             reps: int = 3) -> SweepResult:
    """Time every unpruned candidate of (op, ctx.n_poly, ctx.n_limbs, b) on
    the context's device and put the winner into the cache.  Every
    candidate's output must equal the default's bit for bit (a config is
    geometry, not arithmetic); the default is always measured, so
    `tuned_ms <= default_ms`."""
    from repro_torch.kernels import ops as _ops

    n, l, platform = ctx.n_poly, ctx.n_limbs, ctx.device.type
    cands = candidates(op, n, l, b)
    x = _make_inputs(ctx, b, gen)
    est = {c: _model_time_s(n, l, b, c) for c in cands}
    floor = min(est.values())
    default = cands[0]
    measured: dict[Candidate, float] = {}
    want = None
    for cand in cands:
        if cand != default and est[cand] > PRUNE_RATIO * floor:
            continue
        tables = ctx.split_device_tables(cand.config.ntt4_split
                                         if cand.backend == "ntt4" else None)

        def fn(cand=cand, tables=tables):
            return _ops.run_config(op, cand.backend, cand.config, tables,
                                   x)

        # checked, and released, before the timing: a held output would
        # make the first timed call allocate
        got = fn()
        if want is None:
            want = got
        elif not torch.equal(got, want):
            raise AssertionError(f"sweep {op}: {cand} differs from the "
                                 "default's output")
        del got
        measured[cand] = _timeit(fn, ctx.device, reps)
        obs.histogram("tune_candidate_seconds", op=op,
                      backend=cand.backend).observe(measured[cand])
    winner = min(measured, key=measured.get)
    tuned_ms, default_ms = measured[winner] * 1e3, measured[default] * 1e3
    put(op, n, l, b, platform, winner.backend, winner.config,
        tuned_ms=tuned_ms, default_ms=default_ms)
    obs.counter("tune_sweeps_total", op=op).inc()
    return SweepResult(op=op, n=n, l=l, b=b, platform=platform,
                       winner=winner, tuned_ms=tuned_ms,
                       default_ms=default_ms, n_candidates=len(cands),
                       n_pruned=len(cands) - len(measured),
                       times_ms={c: s * 1e3 for c, s in measured.items()})
