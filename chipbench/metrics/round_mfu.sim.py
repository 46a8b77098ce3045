"""The whole round's share of the card's peak: the least time of one
in-memory round (roofline/rounds.py) x rounds, over the window."""
import readers
from roofline import rounds

UNIT = "%"


def read(record):
    return readers.whole_share_pct(record, rounds.sim_round)
