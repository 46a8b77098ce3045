"""Mean host time of one AggregationService.submit (the harness span
bench.submit)."""
import readers

UNIT = "ms"


def read(record):
    return readers.mean_span_ms(record, "bench.submit")
