"""The whole client turn's share of the card's peak: the least time of one
turn (roofline/rounds.py) x turns, over the window."""
import readers
from roofline import rounds

UNIT = "%"


def read(record):
    return readers.whole_share_pct(record, rounds.client_turn)
