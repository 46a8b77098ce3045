"""Device ms a round spends in the encode (FFT and scatter): the device_ms
of the program's he.encode spans, over the rounds."""
import program_spans

UNIT = "ms"


def read(record):
    return program_spans.device_ms_per_unit(record, ("he.encode",))
