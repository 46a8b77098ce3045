"""Mean ms a blob waits from its accept to the start of its fold: the
wait_s of the program's serve.queue_wait events, one a folded blob."""
import program_spans

UNIT = "ms"


def read(record):
    return program_spans.mean_ms(record, "serve.queue_wait", "wait_s")
