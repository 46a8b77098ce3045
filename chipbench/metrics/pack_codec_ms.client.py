"""Host ms a turn's pack spends in the plain codec (the f16 cast): the
program's wire.codec spans inside wire.pack, over the packs."""
import program_spans

UNIT = "ms"


def read(record):
    return program_spans.host_ms_per_parent(record, "wire.codec",
                                            "wire.pack")
