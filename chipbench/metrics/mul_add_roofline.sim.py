"""mul_add's share of its roofline over the window: the least time of its
launches at [rows, L, N] (roofline/mul_add.py) over its kernel's device
time."""
import readers
from roofline import mul_add

UNIT = "%"


def read(record):
    return readers.kernel_roofline_pct(record, "mul_add", "mul_add_kernel",
                                       mul_add.least_seconds)
