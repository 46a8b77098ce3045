"""Device ms an ingest spends expanding the public a of its seeded chunks
(threefry): the device_ms of the program's he.expand_a spans inside
wire.ingest, over the ingests."""
import program_spans

UNIT = "ms"


def read(record):
    return program_spans.device_ms_per_parent(record, "he.expand_a",
                                              "wire.ingest")
