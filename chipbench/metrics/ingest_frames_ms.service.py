"""Host ms an ingest spends in its frame loop: the program's wire.frames
spans inside wire.ingest, over the ingests of the window."""
import program_spans

UNIT = "ms"


def read(record):
    return program_spans.host_ms_per_parent(record, "wire.frames",
                                            "wire.ingest")
