"""Device ms a round spends in the selection mask's gathers and
scatters: the device_ms of the program's he.split and he.merge spans,
over the rounds."""
import program_spans

UNIT = "ms"


def read(record):
    return program_spans.device_ms_per_unit(record, ("he.split",
                                                     "he.merge"))
