"""Least time of one mul_add launch, x (*) y + z over [rows, L, N] with y
one broadcast [1, L, N] row: x, z and the output once each, y and the
per-limb constants once; a Montgomery product and a modular add an
element."""
from roofline import peaks


def least_seconds(rows: int, n_limbs: int, n_poly: int, card: dict) -> float:
    elems = rows * n_limbs * n_poly
    nbytes = 4 * (3 * elems + n_limbs * n_poly + 2 * n_limbs)
    return peaks.least_seconds(
        nbytes, peaks.ops((elems, peaks.MONT), (elems, peaks.MOD_ADD)), card)
