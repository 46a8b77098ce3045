"""Mean host time of seed_compress + pack_update_frames of one uplink (the
harness span bench.pack)."""
import readers

UNIT = "ms"


def read(record):
    return readers.mean_span_ms(record, "bench.pack")
