"""weighted_accum_chunks's share of its roofline over the window: the least
time of its launches, one an ingest over the update's rows
(roofline/weighted_accum_chunks.py), over its kernel's device time."""
import readers
from roofline import weighted_accum_chunks

UNIT = "%"


def read(record):
    return readers.kernel_roofline_pct(
        record, "weighted_accum_chunks", "weighted_accum_chunks_kernel",
        weighted_accum_chunks.least_seconds)
