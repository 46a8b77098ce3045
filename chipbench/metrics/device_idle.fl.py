"""Share of the window in which no operation ran on the card: one minus
the union of the profiler's device intervals over the window."""
import readers

UNIT = "%"


def read(record):
    return readers.device_idle_pct(record)
