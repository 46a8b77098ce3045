"""Model FLOP utilization of the window's local training: the model FLOPs
of every local step the window ran (roofline/train.py: rounds x clients x
local steps, each 6 x matmul parameters x tokens plus the SSD's matmuls
x 3) over the window x the card's dense bfloat16 peak.  The window also
holds the rounds' HE work, which does no model FLOPs."""
from roofline import train

UNIT = "%"


def read(record):
    g = record["geometry"]
    if not record.get("trace") or not record["units"] or "leaves" not in g:
        return None
    steps = len(record["units"]) * g["clients"] * g["local_steps"]
    return train.mfu_pct(g, steps, record["window_s"])
