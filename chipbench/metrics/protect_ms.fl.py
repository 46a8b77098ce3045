"""Mean host time of one client_protect, ending once its device work has
finished (the harness span bench.protect)."""
import readers

UNIT = "ms"


def read(record):
    return readers.mean_span_ms(record, "bench.protect")
