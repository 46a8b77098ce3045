#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card this process sees.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the kernels' build on a checkout's first run, the context,
keys, inputs and a warm-up of every shape the cell uses) counts as
`setup_s`; then the window measures for `--seconds`, under torch.profiler
with `--trace 1`.  After the window the program's outputs are checked
against the plain reference in `reference/`, and the last line of standard
output is the result: `correct`, `attempted`, `failed`, the cell's
end-to-end metrics (`--trace 0`) or per-layer metrics (`--trace 1`),
`device`, with `--trace 1` a `breakdown`, and last `checks`, each number
compared beside its limit.  The same numbers end standard error.

Exits 3 without a CUDA card, 4 if JAX or the JAX package was loaded, and 5
if the cell has no limits of its own (`limits/<cell>.json`).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import harness  # noqa: E402
from roofline import peaks  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(workload, cfg, traffic, run, cell_kwargs=None) -> dict:
    """Set up, measure, check.  Returns the result line's fields, with the
    compared numbers under "numbers" and not yet judged; a traced run keeps
    what its readers read in `run.record`.  `cell_kwargs` switch on a
    lower-precision control of the cell's kind (its CONTROLS;
    calibrate.py)."""
    bench = harness.benchmark()
    kind = harness.kind(traffic)
    cell = kind.Cell(cfg, traffic, run, **(cell_kwargs or {}))
    cell.setup()
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
        if run.trace:
            run.geometry["card"] = peaks.card(run.device.index or 0)
    setup_s = time.perf_counter() - T0
    ops.reset_launch_counts()
    trace = run.window(cell.window)
    run.counters["launches"] = ops.launch_counts()
    device = harness.device_block(run, trace)
    out = {"attempted": run.counters.get("attempted", len(run.units)),
           "failed": run.counters.get("failed", 0)}
    if run.trace:
        names = [m["name"] for m in bench["per_layer"]
                 if workload["name"] in m.get("workloads",
                                              [workload["name"]])]
        run.record = harness.record_of(run, trace)
        out["metrics"] = harness.per_layer(run.record, names)
        out["breakdown"] = {
            "device_ops": harness.top({k: s for k, (_, s) in
                                       trace["kernels"].items()}),
            "idle_gaps": harness.top(trace["idle"])}
    else:
        e2e = cell.metrics(run)
        e2e["setup_s"] = setup_s
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        out["metrics"] = {k: {"value": float(v), "unit": units[k]}
                          for k, v in e2e.items()}
    out["device"] = device
    cell.release()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out["numbers"] = cell.check()
    traced = (f", profiler stop {run.trace_s[0]:.3f} s, trace listing "
              f"{run.trace_s[1]:.3f} s, trace read {run.trace_s[2]:.3f} s"
              if run.trace_s else "")
    print(f"setup {setup_s:.3f} s, window {run.window_s:.3f} s "
          f"({len(run.units)} rounds or turns){traced}, check "
          f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in numbers.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def main(argv=None) -> int:
    args = parse(argv)
    workload, cfg, traffic = harness.cell(args.workload)
    try:
        limits = harness.limits(workload["name"])
    except LookupError as e:
        print(e, file=sys.stderr)
        return 5
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(workload["chips"]):
        print(f"{args.workload} needs {workload['chips']} CUDA card(s); "
              f"this process sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    run = harness.Run(args.seed, args.seconds, bool(args.trace), "cuda")
    out = execute(workload, cfg, traffic, run)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 4
    correct, checks = judge(out.pop("numbers"), limits)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    line = {"correct": correct, **out, "checks": checks}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # no teardown of the interpreter and the card's context: seconds for
    # tens of GB on the card, and this process started no other
    os._exit(rc)
