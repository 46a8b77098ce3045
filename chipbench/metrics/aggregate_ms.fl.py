"""Mean host time of one server_aggregate, ending once its device work has
finished (the harness span bench.aggregate)."""
import readers

UNIT = "ms"


def read(record):
    return readers.mean_span_ms(record, "bench.aggregate")
