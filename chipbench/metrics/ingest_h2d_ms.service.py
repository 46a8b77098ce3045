"""Host ms an ingest spends copying to the card: the program's wire.h2d
spans (the plain segment's copy, and the flush's gather of rows into one
host buffer and its copies) inside wire.ingest, over the ingests."""
import program_spans

UNIT = "ms"


def read(record):
    return program_spans.host_ms_per_parent(record, "wire.h2d",
                                            "wire.ingest")
