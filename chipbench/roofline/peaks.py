"""The card's peaks, and the least time of a piece of work.

HBM bandwidth is NVIDIA's published figure for the H100 SXM (80 GB HBM3,
3.35 TB/s at the full 700 W), and so is its dense bfloat16 tensor-core
rate (989.4 TFLOP/s without sparsity), the peak of a training step's model
FLOPs.  Integer work is counted per pipe: each pipe
has 64 lanes an SM (Hopper white paper), times the SM count and the card's
maximum SM clock, both read off the card.  The multiply pipe takes 32-bit
multiplies and multiply-adds; the ALU pipe adds, compares, shifts, logic
and min/max.  A count is the least number of instructions Hopper needs, so
the least time is a bound the work cannot beat.
"""
from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
BF16_DENSE_FLOPS = 989.4e12
INT_LANES_PER_SM = 64

# (multiplies, ALU instructions) of one operation on 32-bit residues: a
# 64-bit Montgomery product is three multiplies and one fused add-min; a
# modular add or subtract an add and one fused add-min
MONT = (3, 1)
MOD_ADD = (0, 2)
BUTTERFLY = (3, 5)          # one MONT and one each of MOD_ADD, MOD_SUB
# one Threefry-2x32-20 block: per round an add, a funnel shift and a xor,
# and an add to each word at each of the five key injections
THREEFRY_BLOCK = (0, 20 * 3 + 5 * 2)


def card(device_index: int = 0) -> dict:
    """{"sms", "max_sm_mhz", "name", "power_limit_w"} of a CUDA card."""
    import torch

    props = torch.cuda.get_device_properties(device_index)
    q = subprocess.run(
        ["nvidia-smi", "-i", str(device_index),
         "--query-gpu=clocks.max.sm,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz, watts = (float(v) for v in q.stdout.strip().splitlines()[0]
                  .split(","))
    return {"sms": props.multi_processor_count, "max_sm_mhz": mhz,
            "name": props.name, "power_limit_w": watts}


def int_rate(c: dict) -> float:
    """Instructions a second of one integer pipe on the whole card."""
    return c["sms"] * INT_LANES_PER_SM * c["max_sm_mhz"] * 1e6


def ops(*terms) -> tuple:
    """(multiplies, ALU) of terms (count, (multiplies, ALU))."""
    return (sum(n * o[0] for n, o in terms), sum(n * o[1] for n, o in terms))


def least_seconds(nbytes: float, work: tuple, c: dict) -> float:
    """The larger of the bytes over HBM bandwidth and each integer pipe's
    count over its rate."""
    rate = int_rate(c)
    return max(nbytes / HBM_BYTES_PER_S, work[0] / rate, work[1] / rate)
