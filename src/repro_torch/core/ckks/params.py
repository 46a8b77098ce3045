"""CKKS (RNS) parameters for the PyTorch port.

A numpy copy of the JAX package's parameter generation: the same NTT-friendly
primes (q == 1 mod 2N, q < 2**30), the same Montgomery constants (R = 2**32)
and the same Longa-Naehrig bit-reversed twiddle tables, so every table is
equal to the reference's bit for bit, the 4-step NTT's tables included (at
the default split on `LimbTables`, at any other split through
`ntt4_variant_tables`).

Tables are built on the host once per context.  `CkksContext.device_tables`
holds the same tables as torch tensors on the context's device.  Residues and
constants are `torch.int32` there: every residue is below q < 2**30, so the
int32 value equals the u32 value, and the one full-range constant
(-q^{-1} mod 2**32) is stored as the int32 with the same bits.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# device selection
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default) and
    there is none; it never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    return dev


# ---------------------------------------------------------------------------
# number theory (host-side, python ints)
# ---------------------------------------------------------------------------

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (only n < 2**31 is used)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _SMALL_PRIMES:
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


def find_ntt_primes(n_poly: int, count: int, max_bits: int = 30) -> list[int]:
    """Largest `count` primes q < 2**max_bits with q == 1 (mod 2*n_poly)."""
    step = 2 * n_poly
    q = ((1 << max_bits) - 1) // step * step + 1
    primes: list[int] = []
    while len(primes) < count and q > (1 << 20):
        if is_prime(q):
            primes.append(q)
        q -= step
    if len(primes) < count:
        raise ValueError(f"could not find {count} NTT primes for N={n_poly}")
    return primes


def _primitive_root(q: int) -> int:
    """Smallest primitive root modulo prime q."""
    phi = q - 1
    factors = set()
    m = phi
    d = 2
    while d * d <= m:
        while m % d == 0:
            factors.add(d)
            m //= d
        d += 1
    if m > 1:
        factors.add(m)
    for g in range(2, q):
        if all(pow(g, phi // f, q) != 1 for f in factors):
            return g
    raise ValueError("no primitive root")


def root_of_unity(q: int, order: int) -> int:
    """A primitive `order`-th root of unity mod q (order | q-1)."""
    if (q - 1) % order:
        raise ValueError(f"{order} does not divide q-1 for q={q}")
    w = pow(_primitive_root(q), (q - 1) // order, q)
    assert pow(w, order, q) == 1 and pow(w, order // 2, q) != 1
    return w


def bit_reverse(x: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


def ntt4_split(n_poly: int) -> tuple[int, int]:
    """Default factorization N = n1 * n2 of the 4-step NTT: powers of two,
    n1 <= n2, as close to sqrt(N) as possible (64 x 128 at N=8192)."""
    k = (n_poly.bit_length() - 1) // 2
    return 1 << k, n_poly >> k


def ntt4_split_candidates(n_poly: int) -> tuple[tuple[int, int], ...]:
    """The splits the autotuner sweeps: the default and its two neighbours
    (32x256 / 64x128 / 128x64 at N=8192), both lengths >= 2."""
    logn = n_poly.bit_length() - 1
    mid = logn // 2
    out = []
    for k in (mid - 1, mid, mid + 1):
        if 1 <= k <= logn - 1:
            pair = (1 << k, n_poly >> k)
            if pair not in out:
                out.append(pair)
    return tuple(out)


# ---------------------------------------------------------------------------
# per-prime (limb) Montgomery + NTT tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LimbContext:
    """All constants for one RNS limb prime q (< 2**30)."""

    q: int
    qinv_neg: int                 # -q^{-1} mod 2**32
    r2: int                       # R^2 mod q
    one_mont: int                 # R mod q
    psi_rev_mont: np.ndarray      # [N] u32, psi^bitrev(i) * R mod q
    psi_inv_rev_mont: np.ndarray  # [N] u32
    n_inv_mont: np.ndarray        # scalar u32 array, N^{-1} * R mod q
    # 4-step NTT tables at the default split N = n1 * n2
    ntt4_psi1_mont: np.ndarray      # [n1] u32, LN table of mu = psi^n2
    ntt4_psi1_inv_mont: np.ndarray  # [n1] u32
    ntt4_psi2_mont: np.ndarray      # [n2] u32, LN table of chi = psi^n1
    ntt4_psi2_inv_mont: np.ndarray  # [n2] u32
    ntt4_corr_mont: np.ndarray      # [N] u32, [bitrev(k1)][j2] correction
    ntt4_corr_inv_mont: np.ndarray  # [N] u32


@functools.lru_cache(maxsize=64)
def make_limb_context(q: int, n_poly: int) -> LimbContext:
    if q >= (1 << 30):
        raise ValueError("Montgomery u32 bounds require q < 2**30")
    if (q - 1) % (2 * n_poly):
        raise ValueError(f"q={q} is not 1 mod 2N for N={n_poly}")
    logn = n_poly.bit_length() - 1
    r = 1 << 32
    qinv_neg = (-pow(q, -1, r)) % r
    psi = root_of_unity(q, 2 * n_poly)   # primitive 2N-th root (negacyclic)
    psi_inv = pow(psi, -1, q)

    psi_rev = np.zeros(n_poly, dtype=np.uint32)
    psi_inv_rev = np.zeros(n_poly, dtype=np.uint32)
    for i in range(n_poly):
        j = bit_reverse(i, logn)
        psi_rev[i] = pow(psi, j, q) * r % q
        psi_inv_rev[i] = pow(psi_inv, j, q) * r % q
    ntt4 = _ntt4_limb_tables(q, n_poly, *ntt4_split(n_poly))
    return LimbContext(
        q=q,
        qinv_neg=qinv_neg,
        r2=r * r % q,
        one_mont=r % q,
        psi_rev_mont=psi_rev,
        psi_inv_rev_mont=psi_inv_rev,
        n_inv_mont=np.asarray(pow(n_poly, -1, q) * r % q, dtype=np.uint32),
        **dict(zip(NTT4_FIELDS, ntt4)),
    )


NTT4_FIELDS = ("ntt4_psi1_mont", "ntt4_psi1_inv_mont", "ntt4_psi2_mont",
               "ntt4_psi2_inv_mont", "ntt4_corr_mont", "ntt4_corr_inv_mont")


@functools.lru_cache(maxsize=256)
def _ntt4_limb_tables(q: int, n_poly: int, n1: int, n2: int) -> tuple:
    """4-step NTT tables of one limb at any split N = n1 * n2 (n1 > n2
    too).

    With x[j] = x[j2 + n2*j1] the negacyclic NTT factors into a length-n1
    LN NTT over j1 with mu = psi^n2, an elementwise correction
    psi^(j2*(2*k1+1-n1)) at row bitrev(k1), and a length-n2 LN NTT over j2
    with chi = psi^n1.  Sub-tables are LN bit-reversed Montgomery, like
    psi_rev_mont.  Returns the NTT4_FIELDS in order."""
    if n1 * n2 != n_poly or n1 < 2 or n2 < 2:
        raise ValueError(f"bad 4-step split {n1} x {n2} of N={n_poly}")
    r = 1 << 32
    psi = root_of_unity(q, 2 * n_poly)
    k_bits, r_bits = n1.bit_length() - 1, n2.bit_length() - 1

    def lnt(root, length, bits):
        return np.asarray([pow(root, bit_reverse(i, bits), q) * r % q
                           for i in range(length)], dtype=np.uint32)

    mu, chi = pow(psi, n2, q), pow(psi, n1, q)
    corr = np.zeros((n1, n2), dtype=np.uint32)
    corr_inv = np.zeros((n1, n2), dtype=np.uint32)
    for k1 in range(n1):
        w = pow(psi, (2 * k1 + 1 - n1) % (2 * n_poly), q)
        w_inv = pow(w, -1, q)
        row = bit_reverse(k1, k_bits)
        c = ci = 1
        for j2 in range(n2):
            corr[row, j2] = c * r % q
            corr_inv[row, j2] = ci * r % q
            c = c * w % q
            ci = ci * w_inv % q
    return (lnt(mu, n1, k_bits), lnt(pow(mu, -1, q), n1, k_bits),
            lnt(chi, n2, r_bits), lnt(pow(chi, -1, q), n2, r_bits),
            corr.reshape(-1), corr_inv.reshape(-1))


# ---------------------------------------------------------------------------
# stacked limb tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LimbTables:
    """Per-limb constants stacked along a leading limb axis.

    On the host the fields are numpy u32 arrays, equal to the JAX package's
    `LimbTables` fields of the same names; `to(device)` gives the same
    tables as torch int32 tensors (u32 bits) for the kernels and ops.
    """

    qs: object                # [L] limb primes
    qinv_negs: object         # [L] -q^{-1} mod 2**32
    r2s: object               # [L] R^2 mod q
    one_monts: object         # [L] R mod q
    n_inv_monts: object       # [L] N^{-1} * R mod q
    psi_rev_mont: object      # [L, N] forward twiddles (Montgomery)
    psi_inv_rev_mont: object  # [L, N] inverse twiddles (Montgomery)
    # 4-step NTT tables, limb axis leading like the rest, so `slice`,
    # `take` and `to` carry them
    ntt4_psi1_mont: object      # [L, n1]
    ntt4_psi1_inv_mont: object  # [L, n1]
    ntt4_psi2_mont: object      # [L, n2]
    ntt4_psi2_inv_mont: object  # [L, n2]
    ntt4_corr_mont: object      # [L, N]
    ntt4_corr_inv_mont: object  # [L, N]

    @property
    def n_limbs(self) -> int:
        return int(self.qs.shape[0])

    def take(self, l: int) -> "LimbTables":
        """First-l-limb slice (limb-dropped ciphertexts keep leading limbs)."""
        if l == self.n_limbs:
            return self
        if not 1 <= l <= self.n_limbs:
            raise ValueError(f"cannot take {l} of {self.n_limbs} limbs")
        return self.slice(0, l)

    def slice(self, lo: int, hi: int) -> "LimbTables":
        """Limbs [lo, hi): the tables of one model shard of the sharded
        engine, which owns a limb range rather than the leading limbs."""
        if not 0 <= lo < hi <= self.n_limbs:
            raise ValueError(f"cannot slice limbs [{lo}, {hi}) of "
                             f"{self.n_limbs}")
        return LimbTables(**{f.name: getattr(self, f.name)[lo:hi]
                             for f in dataclasses.fields(self)})

    def to(self, device) -> "LimbTables":
        """Host tables -> torch int32 tensors (same bits) on `device`."""
        return LimbTables(**{f.name: _tensor(getattr(self, f.name), device)
                             for f in dataclasses.fields(self)})


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """u32 numpy array -> int32 tensor with the same bits on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(
        device, copy=True)


def _stack_limb_tables(limbs: "tuple[LimbContext, ...]") -> LimbTables:
    def col(name):
        return np.asarray([getattr(lc, name) for lc in limbs], dtype=np.uint32)

    return LimbTables(
        qs=col("q"), qinv_negs=col("qinv_neg"), r2s=col("r2"),
        one_monts=col("one_mont"), n_inv_monts=col("n_inv_mont"),
        **{name: np.stack([getattr(lc, name) for lc in limbs], axis=0)
           for name in ("psi_rev_mont", "psi_inv_rev_mont") + NTT4_FIELDS},
    )


@functools.lru_cache(maxsize=64)
def ntt4_variant_tables(primes: tuple, n_poly: int, n1: int,
                        n2: int) -> dict:
    """The six stacked u32[L, .] 4-step tables at split n1 x n2, by
    LimbTables field name (what the autotuner's split sweep needs)."""
    per_limb = [_ntt4_limb_tables(int(q), n_poly, n1, n2) for q in primes]
    return {name: np.stack([t[i] for t in per_limb], axis=0)
            for i, name in enumerate(NTT4_FIELDS)}


def retable_ntt4(tables: LimbTables, n1: int, n2: int) -> LimbTables:
    """Host numpy `tables` with its six ntt4_* fields at the n1 x n2 split;
    `tables` itself when they are at that split already.  Device tables at
    a split come from `CkksContext.split_device_tables`, built once per
    split."""
    if int(tables.ntt4_psi1_mont.shape[-1]) == n1:
        return tables
    n_poly = int(tables.psi_rev_mont.shape[-1])
    return dataclasses.replace(tables, **ntt4_variant_tables(
        tuple(int(q) for q in tables.qs), n_poly, n1, n2))


# ---------------------------------------------------------------------------
# full CKKS context
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CkksContext:
    """RNS-CKKS context, depth-1 chain (the paper's setting).

    Shape conventions:
      * ciphertext tensors: int32[..., L, 2, N] in bit-reversed NTT domain;
      * kernel-level ops see limbs at axis -2: int32[..., L, N];
      * per-limb constants: stacked [L] / [L, N] tables.

    `device` is where the context's tensors live; every entry point that
    takes the context runs there.  `threefry_partitionable` names the layout
    of JAX's threefry stream that the public `a` of seeded ciphertexts is
    drawn in (`jax_threefry_partitionable`, True by default in jax 0.9):
    a port client and server must use the layout of the JAX peers they talk
    to.
    """

    n_poly: int
    primes: tuple[int, ...]
    delta_bits: int
    device: torch.device = torch.device("cpu")
    error_sigma: float = 3.2    # RLWE noise stddev
    threefry_partitionable: bool = True

    @property
    def n_limbs(self) -> int:
        return len(self.primes)

    @property
    def slots(self) -> int:
        return self.n_poly // 2

    @property
    def delta(self) -> float:
        return float(2 ** self.delta_bits)

    @property
    def big_q(self) -> int:
        return math.prod(self.primes)

    @functools.cached_property
    def limbs(self) -> tuple[LimbContext, ...]:
        return tuple(make_limb_context(q, self.n_poly) for q in self.primes)

    @functools.cached_property
    def tables(self) -> LimbTables:
        """Stacked numpy u32 tables (host)."""
        return _stack_limb_tables(self.limbs)

    @functools.cached_property
    def device_tables(self) -> LimbTables:
        """`tables` as int32 tensors on the context's device."""
        return self.tables.to(self.device)

    @functools.cached_property
    def _split_tables(self) -> dict:
        return {}

    def split_device_tables(self, split=None) -> LimbTables:
        """`device_tables` with the 4-step tables at `split` (n1, n2);
        None or the default split is `device_tables` itself.  Built once
        per split and context."""
        if split is None or tuple(split) == ntt4_split(self.n_poly):
            return self.device_tables
        n1, n2 = split
        t = self._split_tables.get((n1, n2))
        if t is None:
            t = self._split_tables[(n1, n2)] = dataclasses.replace(
                self.device_tables, **{
                    k: _tensor(v, self.device) for k, v in
                    ntt4_variant_tables(self.primes, self.n_poly, n1,
                                        n2).items()})
        return t

    def limb_range(self, lo: int, hi: int, device=None) -> "CkksContext":
        """The context of limbs [lo, hi) on `device` (default: this one's):
        what one slot of the sharded engine runs the single-device bodies
        with.  Its tables are `tables.slice(lo, hi)`, built once per
        returned context; the whole range on another device is the same
        context moved there."""
        sub = dataclasses.replace(
            self, primes=self.primes[lo:hi],
            device=self.device if device is None else torch.device(device))
        sub.__dict__["tables"] = self.tables.slice(lo, hi)
        return sub

    def ciphertext_bytes(self, packed: bool = True) -> int:
        """Bytes to ship one ciphertext: ceil(log2 q) bits per coefficient
        (packed) or the raw u32 layout."""
        if packed:
            bits = sum(q.bit_length() for q in self.primes) * 2 * self.n_poly
            return (bits + 7) // 8
        return self.n_limbs * 2 * self.n_poly * 4

    def plaintext_bytes(self, n_values: int) -> int:
        return 4 * n_values  # f32 wire format

    def num_ciphertexts(self, n_values: int) -> int:
        return max(0, -(-n_values // self.slots))

    def encrypted_bytes(self, n_values: int, packed: bool = True) -> int:
        return self.num_ciphertexts(n_values) * self.ciphertext_bytes(packed)


def make_context(
    n_poly: int = 8192,
    n_limbs: int = 2,
    delta_bits: int = 26,
    max_prime_bits: int = 30,
    device=None,
    threefry_partitionable: bool = True,
) -> CkksContext:
    """Build a context on `device` (CUDA unless the caller names another).
    Defaults mirror the paper: 4096 slots (N=8192), depth 1, 128-bit
    security."""
    if n_poly & (n_poly - 1):
        raise ValueError("N must be a power of two")
    dev = resolve_device(device)
    primes = tuple(find_ntt_primes(n_poly, n_limbs, max_prime_bits))
    # depth-1 headroom: values*delta**2 must stay below Q/2 at decode
    headroom_bits = sum(q.bit_length() for q in primes) - 2 * delta_bits - 1
    if headroom_bits < 4:
        raise ValueError(
            f"insufficient modulus headroom: logQ~"
            f"{sum(q.bit_length() for q in primes)} vs 2*delta_bits="
            f"{2 * delta_bits}; add limbs or shrink delta")
    return CkksContext(n_poly=n_poly, primes=primes, delta_bits=delta_bits,
                       device=dev,
                       threefry_partitionable=bool(threefry_partitionable))


def make_test_context(n_poly: int = 256, n_limbs: int = 2,
                      delta_bits: int = 20, device=None,
                      threefry_partitionable: bool = True) -> CkksContext:
    """Small context for tests and examples."""
    return make_context(n_poly=n_poly, n_limbs=n_limbs,
                        delta_bits=delta_bits, device=device,
                        threefry_partitionable=threefry_partitionable)
