"""Mean time of one StreamIngest.ingest on the service's worker: the
program's own wire.ingest spans, recorded while obs is on in the traced
run."""
import readers

UNIT = "ms"


def read(record):
    return readers.mean_obs_span_ms(record, "wire.ingest")
