"""ntt_fwd's share of its roofline over the window: the least time of
its launches at [rows, L, N] (roofline/ntt_fwd.py) over its kernel's
device time."""
import readers
from roofline import ntt_fwd

UNIT = "%"


def read(record):
    return readers.kernel_roofline_pct(record, "ntt_fwd", "ntt_fwd_kernel",
                                       ntt_fwd.least_seconds)
