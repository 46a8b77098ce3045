"""Mean host time of wire.format.serialize_update of a round's result (the
harness span bench.downlink)."""
import readers

UNIT = "ms"


def read(record):
    return readers.mean_span_ms(record, "bench.downlink")
