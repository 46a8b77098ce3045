"""Mean host time of wire.format.deserialize of the downlink, ending once
its copies to the card have finished (the harness span bench.parse)."""
import readers

UNIT = "ms"


def read(record):
    return readers.mean_span_ms(record, "bench.parse")
