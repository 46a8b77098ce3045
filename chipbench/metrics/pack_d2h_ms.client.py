"""Host ms a turn's pack spends copying to the host (c0 rows and the
plain part): the program's wire.d2h spans inside wire.pack, over the
packs."""
import program_spans

UNIT = "ms"


def read(record):
    return program_spans.host_ms_per_parent(record, "wire.d2h",
                                            "wire.pack")
