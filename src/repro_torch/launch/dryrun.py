"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step on `meta`
tensors placed on a production mesh of fake ranks, prove memory/sharding
coherence, and write the roofline raw material (per-rank flops, bytes,
collectives, live memory) to dryrun_out/<arch>_<shape>_<mesh>[__tag].json
(the JAX package's `repro.launch.dryrun`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --he-agg --mesh single

How a cell runs.  The JAX package lowers each cell on 512 placeholder host
devices; here torch.distributed's fake backend plays them: this process is
rank 0 of a world of 256 (single pod, (16, 16)) or 512 (two pods,
(2, 16, 16)) whose collectives move nothing, and `make_production_mesh(...,
device_type="cpu")` is built on it.  The model is built with
`axis_env_from_mesh(mesh)` on `meta`; parameters, AdamW state (m, v
float32, step) and `configs.shapes.input_specs` are placed as meta DTensors
by the specs, and `launch.steps.jit_*_step` runs once.  Every cell restarts
the fake group, so `--mesh both` runs in one process.

What is counted, all for rank 0 (every rank of the SPMD step does the
same):
  * memory.argument_bytes: exact, the sum of the local shards of the
    step's inputs;
  * memory.peak_hbm_bytes: the peak of live local tensor bytes during the
    step, arguments included.  A TorchDispatchMode sees every local op
    under DTensor (it declines the DTensor-level call, so DTensor desugars
    it into local ops and collectives first, as CommDebugMode does) and
    keeps each output storage live until its last tensor is freed;
    temp_bytes is that peak less the arguments, output_bytes the local
    bytes of the step's outputs, alias_bytes 0 (there is no donation);
  * collectives: counts from `CommDebugMode`, and bytes by op from the same
    dispatch mode (the larger of the local input and output);
  * roofline: flops of the local ops by `torch.utils.flop_counter`'s
    formulas (FlopCounterMode's own, applied below DTensor, so a shard body
    of `local_map` and a DTensor op count alike), op bytes (inputs plus
    outputs of every non-view local op: eager PyTorch fuses nothing, so
    fused_bytes equals bytes_accessed), and ring wire bytes of each
    collective, over the H100's published peaks: 989 TFLOP/s bf16 dense,
    3.35 TB/s HBM3 and 450 GB/s NVLink each way (H100 SXM, 700 W).  These
    are the port's counts on the fake backend, not times on a card.

`--he-agg` is the paper-technique cell: `launch.fl_step.HeAggSpec.for_model`
at Qwen1.5-0.5B, p = 0.1 and 8 clients on a 256- or 512-slot `HeMesh` of
meta devices.  It reports the JAX package's `he` block and each slot's
input and output bytes from the step's `Layout`s.  The step itself does not
run (its kernels need a context's tables on a real device): its launches,
one `weighted_sum` per slot, are counted from the layouts.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, input_specs
from repro_torch.core import packing
from repro_torch.core.ckks.params import make_context
from repro_torch.launch import fl_step, steps
from repro_torch.launch.mesh import make_he_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models import sharding as shd
from repro_torch.optim import AdamWConfig

# H100 SXM published peaks at its 700 W limit
PEAK_FLOPS = 989e12       # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12          # HBM3 bytes/s
NVLINK_BW = 450e9         # bytes/s each way

ARTIFACTS = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "dryrun_out"))

MESHES = {"single": ((16, 16), False), "multi": ((2, 16, 16), True)}

_COLLECTIVES = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all",
                "broadcast")


def _fake_world(n: int) -> None:
    """This process as rank 0 of a fresh fake world of n ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())


def _end_world() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh_for(name: str):
    shape, multi = MESHES[name]
    _fake_world(math.prod(shape))
    return make_production_mesh(multi_pod=multi, device_type="cpu")


# ---------------------------------------------------------------------------
# the meter: a dispatch mode below DTensor
# ---------------------------------------------------------------------------


def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t):
    return getattr(t, "_local_tensor", t)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args) -> int:
    """Ranks of a functional collective's group (its name is the last
    string argument)."""
    import torch.distributed.distributed_c10d as c10d
    names = [a for a in args if isinstance(a, str)]
    if not names:
        return 1
    return c10d._resolve_process_group(names[-1]).size()


class Meter:
    """Counts the local ops of one step (see the module docstring)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        meter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                meter._op(func, args, kwargs, out, flop_registry)
                return out

        self.mode = _Mode()
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes: dict[str, int] = {}
        self.wire_bytes = 0.0
        self._live: dict[int, list] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def hold(self, t) -> None:
        """Count t's storage live until its last tracked tensor dies."""
        st = t.untyped_storage()
        key = st._cdata
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [st.nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._live[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._live[key]

    def _op(self, func, args, kwargs, out, flop_registry) -> None:
        from torch._subclasses.fake_tensor import FakeTensor
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return      # DTensor's sharding propagation on global shapes
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = str(packet)
        coll = next((c for c in _COLLECTIVES if c in name), None)
        if coll is not None and "wait" not in name:
            b_in = sum(_nbytes(t) for t in ins)
            b_out = sum(_nbytes(t) for t in outs)
            self.coll_bytes[coll] = self.coll_bytes.get(coll, 0) + \
                max(b_in, b_out)
            g = _group_size(func, args)
            ring = (g - 1) / g if g > 1 else 0.0
            self.wire_bytes += (2 * ring * b_in if coll == "all_reduce"
                                else ring * max(b_in, b_out))
        elif not func.is_view:
            self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self.hold(t)


def _roofline(flops, bytes_accessed, wire_bytes, model_flops) -> dict:
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_accessed / HBM_BW
    collective_s = wire_bytes / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    step_s = max(terms.values())
    return {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "memory_upper_s": memory_s,
        "flops": float(flops), "bytes_accessed": float(bytes_accessed),
        "fused_bytes": float(bytes_accessed), "wire_bytes": float(wire_bytes),
        "model_flops": model_flops,
        "flops_ratio": model_flops / flops if flops else 0.0,
        "dominant": max(terms, key=terms.get), "step_s": step_s,
        "roofline_fraction": (model_flops / PEAK_FLOPS / step_s
                              if step_s > 0 else 0.0),
        "peaks": {"flops": PEAK_FLOPS, "hbm_bytes_s": HBM_BW,
                  "nvlink_bytes_s": NVLINK_BW,
                  "card": "H100 SXM, 700 W (published)"},
    }


# ---------------------------------------------------------------------------
# model cells
# ---------------------------------------------------------------------------


def _abstract_opt(params):
    zeros = lambda p: torch.empty(p.shape, dtype=torch.float32,
                                  device="meta")
    return {"m": packing.tree_map(zeros, params),
            "v": packing.tree_map(zeros, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def lower_cell(arch: str, shape: str, mesh_name: str, tag: str = "",
               param_mode: str = "train", cfg_overrides: dict | None = None):
    """Run one cell's step on meta tensors; returns the artifact dict."""
    mesh = _mesh_for(mesh_name)
    try:
        return _run_cell(mesh, arch, shape, mesh_name, tag, param_mode,
                         cfg_overrides)
    finally:
        _end_world()


def _run_cell(mesh, arch, shape, mesh_name, tag, param_mode, cfg_overrides):
    from torch.distributed.tensor.debug import CommDebugMode
    n_dev = mesh.size()
    cfg = configs.get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    sp = SHAPES[shape]
    ax = shd.axis_env_from_mesh(mesh)
    model = build_model(cfg, ax, device="meta")
    params = model.init_abstract()

    t0 = time.perf_counter()
    if sp.kind == "train":
        batch = input_specs(cfg, shape)
        step = steps.jit_train_step(model, mesh, AdamWConfig(), batch)
        args = (params, _abstract_opt(params), batch)
        names = ("params", "opt", "batch")
        tokens = sp.batch * sp.seq
    elif sp.kind == "prefill":
        batch = input_specs(cfg, shape)
        step = steps.jit_prefill_step(model, mesh, batch)
        args = (params, batch)
        names = ("params", "batch")
        tokens = sp.batch * sp.seq
    else:  # decode
        full = input_specs(cfg, shape, model=model)
        batch = {"tokens": full["tokens"]}
        cache = full["cache"]
        step = steps.jit_decode_step(model, mesh, cache, batch, sp.batch,
                                     param_mode=param_mode)
        args = (params, cache, batch)
        names = ("params", "cache", "batch")
        tokens = sp.batch
    placed = [shd.distribute(a, s, step.mesh)
              for a, s in zip(args, step.in_specs)]
    t_place = time.perf_counter() - t0

    meter, comm = Meter(), CommDebugMode()
    by_input = {n: sum(_nbytes(_local(t)) for t in _tensors(a))
                for n, a in zip(names, placed)}
    for t in _tensors(placed):
        meter.hold(_local(t))
    argument_bytes = meter.live_bytes
    t0 = time.perf_counter()
    with comm, meter.mode:
        out = step(*placed)
    t_step = time.perf_counter() - t0
    output_bytes = sum(_nbytes(_local(t)) for t in _tensors(out))
    del out

    mult = 6.0 if sp.kind == "train" else 2.0
    model_flops = mult * cfg.active_param_count() * tokens / n_dev
    return {
        "arch": arch, "shape": shape, "mesh": mesh_name, "tag": tag,
        "n_devices": n_dev, "tokens": tokens, "kind": sp.kind,
        "place_s": round(t_place, 1), "step_s": round(t_step, 1),
        "memory": {
            "argument_bytes": argument_bytes,
            "argument_bytes_by_input": by_input,
            "output_bytes": output_bytes,
            "temp_bytes": meter.peak_bytes - argument_bytes,
            "alias_bytes": 0,
            "peak_hbm_bytes": meter.peak_bytes,
        },
        "collectives": {
            "counts": {str(k).split(".")[-1]: v
                       for k, v in comm.get_comm_counts().items()},
            "by_op_bytes": meter.coll_bytes,
        },
        "roofline": _roofline(meter.flops, meter.bytes_accessed,
                              meter.wire_bytes, model_flops),
        "replicate_before": list(shd.REPLICATE_BEFORE),
    }


# ---------------------------------------------------------------------------
# the paper-technique cell
# ---------------------------------------------------------------------------


def lower_he_agg(mesh_name: str, arch: str = "qwen1.5-0.5b",
                 p_ratio: float = 0.1, n_clients: int = 8, tag: str = "",
                 out_dir: str = ARTIFACTS):
    """Distributed CKKS FedAvg aggregation, counted from its layouts."""
    shape, _ = MESHES[mesh_name]
    n_slots = math.prod(shape)
    cfg = configs.get_config(arch)
    ctx = make_context(device="cpu")
    spec = fl_step.HeAggSpec.for_model(cfg.param_count(), p_ratio,
                                       n_clients, n_slots, ctx=ctx)
    mesh = make_he_mesh(ctx.n_limbs,
                        devices=[torch.device("meta")] * n_slots)
    lay = spec.shardings(mesh)
    cts, plain = lay["cts"], lay["plain"]
    n_limbs, n_poly = ctx.n_limbs, ctx.n_poly
    chunk_rows = cts.row_offsets(spec.n_chunks)
    plain_rows = plain.row_offsets(spec.n_plain)
    limbs = n_limbs // cts.mesh.n_model
    slots = []
    for d in range(cts.mesh.n_data):
        ch = chunk_rows[d + 1] - chunk_rows[d]
        pl = plain_rows[d + 1] - plain_rows[d]
        ct_in = n_clients * ch * limbs * 2 * n_poly * 4
        slots.append({"in_bytes": ct_in + n_clients * pl * 4,
                      "out_bytes": ch * limbs * 2 * n_poly * 4 + pl * 4})
    slots = [s for s in slots for _ in range(cts.mesh.n_model)]
    worst = max(slots, key=lambda s: s["in_bytes"] + s["out_bytes"])
    bytes_slot = worst["in_bytes"] + worst["out_bytes"]
    art = {
        "arch": arch, "shape": "he_agg", "mesh": mesh_name, "tag": tag,
        "n_devices": n_slots, "tokens": 0, "kind": "he_agg",
        "memory": {"argument_bytes": worst["in_bytes"],
                   "output_bytes": worst["out_bytes"], "temp_bytes": 0,
                   "alias_bytes": 0, "peak_hbm_bytes": bytes_slot},
        "collectives": {"counts": {}, "by_op_bytes": {}},
        "roofline": _roofline(0, bytes_slot, 0, 0.0),
        "he": {
            "n_clients": n_clients, "p_ratio": p_ratio,
            "n_chunks": spec.n_chunks, "n_plain": spec.n_plain,
            "wire_bytes_per_client": spec.wire_bytes_per_client(),
            "limb_sharded": spec.limb_sharded(mesh),
            "slot_grid": [cts.mesh.n_data, cts.mesh.n_model],
            "slot_in_bytes": [s["in_bytes"] for s in slots],
            "slot_out_bytes": [s["out_bytes"] for s in slots],
            "launches_per_block": {"weighted_sum": 1},
            "launches_from": "layouts (one weighted_sum per slot block; "
                             "the step does not run on meta)",
        },
    }
    _write(art, out_dir)
    return art


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _name(arch, shape, mesh_name, tag=""):
    return f"{arch}_{shape}_{mesh_name}{f'__{tag}' if tag else ''}.json"


def _write(art: dict, out_dir: str = ARTIFACTS) -> str:
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(out_dir, _name(art["arch"], art["shape"], art["mesh"],
                                     art.get("tag", "")))
    with open(fn, "w") as f:
        json.dump(art, f, indent=1)
    return fn


def run_cell(arch, shape, mesh_name, force=False, tag="", param_mode="train",
             cfg_overrides=None, out_dir: str = ARTIFACTS):
    fn = os.path.join(out_dir, _name(arch, shape, mesh_name, tag))
    if os.path.exists(fn) and not force:
        print(f"SKIP (cached) {arch} {shape} {mesh_name}")
        with open(fn) as f:
            return json.load(f)
    t0 = time.perf_counter()
    try:
        art = lower_cell(arch, shape, mesh_name, tag, param_mode=param_mode,
                         cfg_overrides=cfg_overrides)
    except Exception as e:
        print(f"FAIL {arch} {shape} {mesh_name}: {e}")
        traceback.print_exc()
        return None
    _write(art, out_dir)
    r, m = art["roofline"], art["memory"]
    print(f"OK {arch} {shape} {mesh_name} step={art['step_s']}s "
          f"comp={r['compute_s']*1e3:.1f}ms mem={r['memory_s']*1e3:.1f}ms "
          f"coll={r['collective_s']*1e3:.1f}ms dom={r['dominant']} "
          f"frac={r['roofline_fraction']:.2f} "
          f"args={m['argument_bytes']/1e9:.2f}GB "
          f"peak={m['peak_hbm_bytes']/1e9:.2f}GB "
          f"colls={sum(art['collectives']['counts'].values())} "
          f"({time.perf_counter()-t0:.0f}s)")
    return art


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--he-agg", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--param-mode", default="train",
                    choices=["train", "serve_tp"])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every model to this many layers (a quick "
                         "check; the artifact is tagged with it)")
    ap.add_argument("--out", default=ARTIFACTS,
                    help="artifact directory (default: dryrun_out/ at the "
                         "repo root)")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.he_agg:
        for m in meshes:
            t0 = time.perf_counter()
            art = lower_he_agg(m, tag=args.tag, out_dir=args.out)
            r, he = art["roofline"], art["he"]
            print(f"OK he_agg {m} chunks={he['n_chunks']} "
                  f"plain={he['n_plain']} "
                  f"slot_in={max(he['slot_in_bytes'])}B "
                  f"mem={r['memory_s']*1e3:.3f}ms dom={r['dominant']} "
                  f"({time.perf_counter()-t0:.0f}s)")
        return 0
    if args.all:
        cells = configs.all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")
    over, tag = None, args.tag
    if args.layers:
        over = {"n_layers": args.layers}
        tag = "_".join(t for t in (tag, f"L{args.layers}") if t)
    ok = fail = 0
    for arch, shape in cells:
        for m in meshes:
            art = run_cell(arch, shape, m, force=args.force, tag=tag,
                           param_mode=args.param_mode, cfg_overrides=over,
                           out_dir=args.out)
            ok += art is not None
            fail += art is None
    print(f"done: {ok} ok, {fail} failed")
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
