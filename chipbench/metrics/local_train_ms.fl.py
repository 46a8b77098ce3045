"""Mean host time of one client's local training (FLClient.local_train:
its local steps), ending once its device work has finished (the harness
span bench.local_train)."""
import readers

UNIT = "ms"


def read(record):
    return readers.mean_span_ms(record, "bench.local_train")
