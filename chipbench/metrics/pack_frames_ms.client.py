"""Host ms a turn's pack spends framing: the program's wire.frames spans
inside wire.pack, over the packs."""
import program_spans

UNIT = "ms"


def read(record):
    return program_spans.host_ms_per_parent(record, "wire.frames",
                                            "wire.pack")
