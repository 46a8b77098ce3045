#!/usr/bin/env python3
"""Read a cell's compared numbers over many seeds in one process, for the
program or for one of its lower-precision controls; each cell's limits in
`limits/<cell>.json` are set from these readings (PERF.md lists them).

    python3 chipbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--control delta20|i8|bf16] [--record out.json]

One JSON line a seed: {"seed", "control", "numbers", "window_s",
"units"}.  Controls:

  delta20  the program at CKKS scale 2**20 (its own test-context scale),
           the step below the configuration's 2**26;
  i8       the program's i8 plain codec in place of f16 (wire cells);
  bf16     the reference's FedAvg computed in bfloat16 in the place of the
           recovered model (in-memory cells, whose plain part is float32).

The benchmark's own runs never run a control.  `--record` writes the
first seed's per-layer record (spans, counters, geometry, trace summary)
of a traced window, the fixture the metric readers are tested on.
"""
import argparse
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import harness  # noqa: E402
import run as runner  # noqa: E402

CONTROLS = {"none": {}, "delta20": {"delta_bits": 20},
            "i8": {"plain_codec": "i8"}}


def cell_kwargs(control: str) -> dict:
    return dict(CONTROLS.get(control, {}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", default="none",
                    choices=(*CONTROLS, "bf16"))
    ap.add_argument("--record", default=None)
    args = ap.parse_args(argv)
    workload, cfg, traffic = harness.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = harness.Run(seed, args.seconds, bool(args.record and i == 0),
                          "cuda")
        out, trace = runner.execute(workload, cfg, traffic, run,
                             cell_kwargs(args.control),
                             substitute=(torch.bfloat16
                                         if args.control == "bf16"
                                         else None))
        if args.record and i == 0:
            with open(args.record, "w") as f:
                json.dump(harness.record_of(run, trace), f)
        print(json.dumps({"seed": seed, "control": args.control,
                          "numbers": out["numbers"],
                          "window_s": run.window_s, "units": run.units}),
              flush=True)
        del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
