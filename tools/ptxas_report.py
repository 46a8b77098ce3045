"""Registers, spills and stack frame of the port's CUDA kernels, from ptxas.

    python3 tools/ptxas_report.py [--no-spill] [--sass PATTERN] [source ...]

Compiles each named source of `src/repro_torch/kernels/csrc/` (all of
`build.SOURCES` by default) with the flags the port builds with plus
`-Xptxas -v`, into a temporary directory, and prints one line per kernel
entry: source, demangled name, registers, stack frame and spill bytes.
With `--no-spill` it exits 1 if any reported kernel spills or has a stack
frame.  With `--sass PATTERN` it also prints, for each kernel whose
demangled name contains PATTERN, the count of each SASS opcode in the
compiled code (cuobjdump -sass; static counts, not executed ones).  Needs
nvcc (the CUDA toolkit), not a GPU.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.kernels import build  # noqa: E402

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)")


def demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def sass_opcodes(lib: str, nvcc: str) -> dict[str, dict[str, int]]:
    """{mangled kernel name: {opcode: static count}} of a built library."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    return out


def report(name: str, nvcc: str, tmp: str) -> list[dict]:
    """One dict per kernel entry of csrc/<name>.cu."""
    cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           os.path.join(tmp, f"lib{name}.so"), str(build.CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stderr}")
    rows, cur = [], None
    for line in proc.stderr.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"source": name, "kernel": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(
                int, m.groups())
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    for row, pretty in zip(rows, demangle([r["kernel"] for r in rows])):
        row["mangled"], row["kernel"] = row["kernel"], pretty
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="*", default=list(build.SOURCES))
    ap.add_argument("--no-spill", action="store_true",
                    help="exit 1 if a kernel spills or has a stack frame")
    ap.add_argument("--sass", metavar="PATTERN",
                    help="print SASS opcode counts of matching kernels")
    args = ap.parse_args(argv)
    nvcc = build.nvcc_path()
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.sources:
            rows = report(name, nvcc, tmp)
            for r in rows:
                spill = r.get("spill_stores", 0) + r.get("spill_loads", 0)
                print(f"ptxas {r['source']}.cu {r['kernel']}: "
                      f"{r.get('registers', 0)} registers, "
                      f"{r.get('stack', 0)} bytes stack frame, "
                      f"{spill} bytes spilled", flush=True)
                bad += bool(spill or r.get("stack", 0))
            if not args.sass:
                continue
            ops = sass_opcodes(os.path.join(tmp, f"lib{name}.so"), nvcc)
            for r in rows:
                if args.sass in r["kernel"] and r["mangled"] in ops:
                    counts = sorted(ops[r["mangled"]].items(),
                                    key=lambda kv: -kv[1])
                    print(f"sass {r['source']}.cu {r['kernel']}: "
                          f"{sum(ops[r['mangled']].values())} instructions: "
                          + ", ".join(f"{k} {v}" for k, v in counts),
                          flush=True)
    if args.no_spill and bad:
        print(f"ptxas: {bad} kernels spill or use a stack frame",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
