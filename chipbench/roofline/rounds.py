"""Least time of a whole round or turn, whatever kernels do the work: the
bytes its inputs and outputs must move through HBM once each, and the
integer work its transforms, products and key streams need, each over the
card's peak (peaks.least_seconds).  Floating-point work (the FFTs of encode
and decode, the plain FedAvg) is left out, which only lowers the bound.

A geometry is the run's: n_params P, n_plain, rows (ciphertexts a client),
n_limbs L, n_poly N, clients K.
"""
from roofline import peaks


def _sizes(g: dict):
    rows, l, n = g["rows"], g["n_limbs"], g["n_poly"]
    residues = rows * l * n                  # one [rows, L, N] component
    return (rows, l, n, residues, 4 * 2 * residues, 4 * g["n_plain"],
            4 * g["n_params"])


def _ntt(rows, l, n):
    return (n // 2) * (n.bit_length() - 1) * rows * l


def sim_round(g: dict, card: dict) -> float:
    """K public-key encrypts (vector in; ciphertext and plain part out;
    four forward NTTs and two multiply-adds each), the weighted sum (K
    ciphertexts and plain parts in, one out), and the recover (ciphertext
    and plain part in, vector out; a multiply-add and an inverse NTT)."""
    rows, l, n, res, ct, pl, vec = _sizes(g)
    k = g["clients"]
    nbytes = (k * (vec + ct + pl) + k * (ct + pl) + (ct + pl)
              + (ct + pl + vec))
    work = peaks.ops(
        (k * 4 * _ntt(rows, l, n), peaks.BUTTERFLY),
        (k * 2 * res, peaks.MONT), (k * 2 * res, peaks.MOD_ADD),
        (k * 2 * res, peaks.MONT), ((k - 1) * 2 * res, peaks.MOD_ADD),
        (res, peaks.MONT), (res, peaks.MOD_ADD),
        (_ntt(rows, l, n), peaks.BUTTERFLY), (res, peaks.MONT))
    return peaks.least_seconds(nbytes, work, card)


def service_round(g: dict, card: dict) -> float:
    """K seeded uploads folded: each upload's c0 rows and f16 plain part
    in, the accumulators written (and read for all but the first), every
    `a` residue drawn from two threefry blocks, a Montgomery product and a
    modular add per ciphertext word; the aggregate read once for the
    downlink."""
    rows, l, n, res, ct, pl, _ = _sizes(g)
    k = g["clients"]
    nbytes = (k * (4 * res + 2 * g["n_plain"]) + (2 * k - 1) * (ct + pl)
              + (ct + pl))
    work = peaks.ops((k * 2 * res, peaks.THREEFRY_BLOCK),
                     (k * 2 * res, peaks.MONT), (k * 2 * res, peaks.MOD_ADD))
    return peaks.least_seconds(nbytes, work, card)


def client_turn(g: dict, card: dict) -> float:
    """A seeded encrypt (vector in, ciphertext and plain part out; the `a`
    stream, two forward NTTs and a multiply-add), the downlink's
    ciphertext and plain part written to the card and read by the
    decrypt (a multiply-add and an inverse NTT), and the model written."""
    rows, l, n, res, ct, pl, vec = _sizes(g)
    nbytes = (vec + ct + pl) + 2 * (ct + pl) + vec
    work = peaks.ops((2 * res, peaks.THREEFRY_BLOCK),
                     (3 * _ntt(rows, l, n), peaks.BUTTERFLY),
                     (2 * res, peaks.MONT), (2 * res, peaks.MOD_ADD),
                     (res, peaks.MONT))
    return peaks.least_seconds(nbytes, work, card)
