"""Least time of one weighted_accum_chunks launch: acc[k] += w[k] (*)
ct[k] over [rows, L, 2, N], the accumulator read and written and the
ciphertext read once each, one Montgomery weight a row and limb and the
per-limb constants once; a Montgomery product and a modular add an
element."""
from roofline import peaks


def least_seconds(rows: int, n_limbs: int, n_poly: int, card: dict) -> float:
    elems = rows * n_limbs * 2 * n_poly
    nbytes = 4 * (3 * elems + rows * n_limbs + 2 * n_limbs)
    return peaks.least_seconds(
        nbytes, peaks.ops((elems, peaks.MONT), (elems, peaks.MOD_ADD)), card)
