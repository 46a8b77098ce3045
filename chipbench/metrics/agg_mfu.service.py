"""The whole service round's share of the card's peak: the least time of
one round of uploads folded and read out (roofline/rounds.py) x rounds,
over the window."""
import readers
from roofline import rounds

UNIT = "%"


def read(record):
    return readers.whole_share_pct(record, rounds.service_round)
