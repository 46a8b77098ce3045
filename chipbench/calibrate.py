#!/usr/bin/env python3
"""Read a cell's compared numbers over many seeds in one process, for the
program, for one of its lower-precision controls or for a planted fault;
each cell's limits in `limits/<cell>.json` are set from these readings
(PERF.md lists them).

    python3 chipbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--control <name>] [--record out.json]

One JSON line a seed: {"seed", "control", "numbers", "window_s",
"units"}.  The controls are the cell's kind's `CONTROLS`, each a set of
the kind's Cell arguments (for example `delta20`, the program at CKKS
scale 2**20, its own test-context scale, the step below the
configuration's 2**26), and its `FAULTS`, each a fault planted in the
program while the run lasts (`faults.py`) (`kinds/<kind>.py`).

The benchmark's own runs never run a control.  `--record` writes the
first seed's per-layer record (spans, counters, geometry, trace summary
and the program's events) of a traced window, the fixture the metric
readers are tested on.
"""
import argparse
import contextlib
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import harness  # noqa: E402
import run as runner  # noqa: E402


def controls(kind) -> dict:
    """{name: (Cell arguments, planter)} of a kind's controls and faults,
    the planter a context manager to run the cell in; "none" is the
    program as the configuration states it."""
    out = {"none": ({}, contextlib.nullcontext)}
    out.update((n, (kw, contextlib.nullcontext))
               for n, kw in kind.CONTROLS.items())
    out.update((n, ({}, plant))
               for n, plant in getattr(kind, "FAULTS", {}).items())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", default="none")
    ap.add_argument("--record", default=None)
    args = ap.parse_args(argv)
    workload, cfg, traffic = harness.cell(args.workload)
    choices = controls(harness.kind(traffic))
    if args.control not in choices:
        ap.error(f"--control: {args.control!r} is none of {sorted(choices)}"
                 f" for {args.workload}")
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = harness.Run(seed, args.seconds, bool(args.record and i == 0),
                          "cuda")
        kwargs, plant = choices[args.control]
        with plant():
            out = runner.execute(workload, cfg, traffic, run, kwargs)
        if args.record and i == 0:
            with open(args.record, "w") as f:
                json.dump(run.record, f)
        print(json.dumps({"seed": seed, "control": args.control,
                          "numbers": out["numbers"],
                          "window_s": run.window_s, "units": run.units}),
              flush=True)
        del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
