"""Plain RNS-CKKS decryption and decoding, for judging the program's
ciphertexts.

Written from the scheme's definition, not from the program: the moduli are
the largest primes below 2**max_prime_bits that are 1 mod 2N; the NTT
domain is the negacyclic evaluation at the powers of psi, a primitive 2N-th
root of unity (psi = g**((q-1)/2N) for g the least primitive root of q),
stored in bit-reversed order (the Longa-Naehrig forward transform); the
canonical embedding evaluates the message polynomial at zeta**(5**j mod 2N),
j < N/2.  Arithmetic is exact int64 torch (every product of two residues
is below 2**60) and float64/complex128 for the decode, on whatever device
the inputs are on.
"""
from __future__ import annotations

import functools

import torch

_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin (exact for n < 3.3e24)."""
    if n < 2:
        return False
    for p in _WITNESSES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _WITNESSES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def moduli(n_poly: int, n_limbs: int, max_prime_bits: int) -> tuple:
    """The `n_limbs` largest primes q < 2**max_prime_bits, q = 1 mod 2N, in
    decreasing order."""
    step = 2 * n_poly
    q = ((1 << max_prime_bits) - 1) // step * step + 1
    out = []
    while len(out) < n_limbs:
        if q <= step:
            raise ValueError(f"too few NTT primes for N={n_poly}")
        if is_prime(q):
            out.append(q)
        q -= step
    return tuple(out)


def _least_primitive_root(q: int) -> int:
    phi, m, factors, d = q - 1, q - 1, [], 2
    while d * d <= m:
        if m % d == 0:
            factors.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        factors.append(m)
    g = 2
    while any(pow(g, phi // f, q) == 1 for f in factors):
        g += 1
    return g


def _bitrev(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


@functools.lru_cache(maxsize=8)
def _tables(q: int, n_poly: int):
    """(psi**bitrev(i), psi**-bitrev(i)) for i < N, as python lists."""
    psi = pow(_least_primitive_root(q), (q - 1) // (2 * n_poly), q)
    psi_inv = pow(psi, -1, q)
    bits = n_poly.bit_length() - 1
    rev = [_bitrev(i, bits) for i in range(n_poly)]
    return ([pow(psi, r, q) for r in rev], [pow(psi_inv, r, q) for r in rev])


class Ring:
    """Z_q[X]/(X^N + 1) for each modulus q, with the forward and inverse
    NTT and the two-limb decode."""

    def __init__(self, n_poly: int, n_limbs: int, max_prime_bits: int,
                 device):
        self.n = n_poly
        self.primes = moduli(n_poly, n_limbs, max_prime_bits)
        self.device = torch.device(device)
        fwd, inv = zip(*(_tables(q, n_poly) for q in self.primes))
        self.psi = torch.tensor(fwd, dtype=torch.int64, device=self.device)
        self.psi_inv = torch.tensor(inv, dtype=torch.int64,
                                    device=self.device)
        self.q = torch.tensor(self.primes, dtype=torch.int64,
                              device=self.device)
        self.n_inv = torch.tensor([pow(n_poly, -1, q) for q in self.primes],
                                  dtype=torch.int64, device=self.device)

    def _q(self, l: int, ndim: int):
        return self.q[:l].reshape((l,) + (1,) * ndim)

    def ntt(self, x):
        """Coefficients int64[B, L, N] in [0, q) -> NTT domain
        (Cooley-Tukey, bit-reversed output)."""
        b, l, n = x.shape
        a = x.clone()
        t, m = n, 1
        while m < n:
            t //= 2
            a = a.view(b, l, m, 2, t)
            s = self.psi[:l, m:2 * m].reshape(1, l, m, 1)
            q = self._q(l, 2)
            u, v = a[:, :, :, 0], a[:, :, :, 1] * s % q
            a = torch.stack([(u + v) % q, (u - v) % q], dim=3).view(b, l, n)
            m *= 2
        return a

    def intt(self, x):
        """NTT domain int64[B, L, N] -> coefficients in [0, q)
        (Gentleman-Sande, then the factor N**-1)."""
        b, l, n = x.shape
        a = x.clone()
        t, m = 1, n
        while m > 1:
            h = m // 2
            a = a.view(b, l, h, 2, t)
            s = self.psi_inv[:l, h:2 * h].reshape(1, l, h, 1)
            q = self._q(l, 2)
            u, v = a[:, :, :, 0], a[:, :, :, 1]
            a = torch.stack([(u + v) % q, (u - v) % q * s % q],
                            dim=3).view(b, l, n)
            t *= 2
            m = h
        return a * self.n_inv[:l, None] % self._q(l, 1)

    def residues(self, small):
        """Small signed integers int[..., N] -> int64[..., L, N] in [0, q)."""
        return small.to(torch.int64)[..., None, :] % self._q(
            len(self.primes), 1)

    def decrypt(self, c0, c1, s_ntt):
        """c0, c1: NTT-domain residues [B, L, N] (any integer dtype holding
        u32 values); s_ntt: int64[L, N].  -> coefficients int64[B, L, N] of
        c0 + c1 * s."""
        l = c0.shape[1]
        q = self._q(l, 1)
        c0 = c0.to(torch.int64) & 0xFFFFFFFF
        c1 = c1.to(torch.int64) & 0xFFFFFFFF
        return self.intt((c0 + c1 * s_ntt[:l] % q) % q)

    def decode(self, coeffs, scale: float):
        """Two-limb coefficients int64[B, 2, N] -> float64[B, N/2]: CRT,
        centred, over the scale, evaluated at zeta**(5**j)."""
        if coeffs.shape[1] != 2:
            raise ValueError("decode takes two limbs")
        q0, q1 = self.primes[:2]
        x0, x1 = coeffs[:, 0], coeffs[:, 1]
        t = (x1 - x0 % q1) % q1 * pow(q0, -1, q1) % q1
        v = x0 + q0 * t                                # in [0, q0 q1)
        big = q0 * q1
        v = torch.where(v > big // 2, v - big, v)
        n = self.n
        c = torch.zeros((v.shape[0], 2 * n), dtype=torch.complex128,
                        device=v.device)
        c[:, :n] = (v.to(torch.float64) / float(scale)).to(torch.complex128)
        z = torch.fft.ifft(c, dim=-1) * (2 * n)
        return z[:, slot_roots(n, v.device)].real


@functools.lru_cache(maxsize=8)
def _slot_roots(n_poly: int) -> tuple:
    out, cur = [], 1
    for _ in range(n_poly // 2):
        out.append(cur)
        cur = cur * 5 % (2 * n_poly)
    return tuple(out)


def slot_roots(n_poly: int, device):
    return torch.tensor(_slot_roots(n_poly), dtype=torch.int64,
                        device=device)


def decrypt_decode(ring: Ring, c0, c1, s_ntt, scale: float,
                   block_rows: int = 1024):
    """Decrypted and decoded slots float64[B, N/2] of ciphertext rows
    (c0, c1), decrypted `block_rows` rows at a time so that the int64
    temporaries stay a few GB."""
    out = []
    for r in range(0, c0.shape[0], block_rows):
        coeffs = ring.decrypt(c0[r:r + block_rows].to(ring.device),
                              c1[r:r + block_rows].to(ring.device), s_ntt)
        out.append(ring.decode(coeffs, scale))
        del coeffs
    return torch.cat(out)
