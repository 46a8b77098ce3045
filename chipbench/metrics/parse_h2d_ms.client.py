"""Host ms a turn's downlink parse spends copying to the card: the
program's wire.h2d spans inside wire.deserialize, over the parses."""
import program_spans

UNIT = "ms"


def read(record):
    return program_spans.host_ms_per_parent(record, "wire.h2d",
                                            "wire.deserialize")
