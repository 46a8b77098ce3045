"""Mean ms a submit waits for the service's lock: the program's
serve.lock_wait spans of caller submit, one a submit."""
import program_spans

UNIT = "ms"


def read(record):
    return program_spans.mean_ms(record, "serve.lock_wait", caller="submit")
