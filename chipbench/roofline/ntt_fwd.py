"""Least time of one forward NTT launch over [rows, L, N] residues: x
read and the output written once, the twiddle table and per-limb
constants read once; (N/2) log2 N butterflies a row and limb."""
from roofline import peaks


def least_seconds(rows: int, n_limbs: int, n_poly: int, card: dict) -> float:
    elems = rows * n_limbs * n_poly
    butterflies = (n_poly // 2) * (n_poly.bit_length() - 1) * rows * n_limbs
    nbytes = 4 * (2 * elems + n_limbs * n_poly + 2 * n_limbs)
    return peaks.least_seconds(
        nbytes, peaks.ops((butterflies, peaks.BUTTERFLY)), card)
