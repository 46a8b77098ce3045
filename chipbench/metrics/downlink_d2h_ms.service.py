"""Host ms a round's downlink spends copying the aggregate to the host:
the program's wire.d2h spans inside wire.serialize, over the rounds."""
import program_spans

UNIT = "ms"


def read(record):
    return program_spans.host_ms_per_parent(record, "wire.d2h",
                                            "wire.serialize")
