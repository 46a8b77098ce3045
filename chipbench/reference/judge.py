"""The judge: the reference's ring, secret and mask for a run's seed, the
FedAvg the round should give, and the errors of the program's outputs
against it.  Plain torch and numpy; the inputs come from `inputs`, the
benchmark's own maker, as the program's do."""
from __future__ import annotations

import numpy as np
import torch

import inputs
from reference import ckks as ref_ckks
from reference import fedavg
from reference import threefry as ref_threefry


class Reference:
    """The reference's ring, secret and mask for a run's seed."""

    def __init__(self, cfg: dict, ck: dict, p: float, run):
        dev = run.device
        self.cfg, self.seed = cfg, run.seed
        self.ring = ref_ckks.Ring(ck["n_poly"], ck["n_limbs"],
                                  ck["max_prime_bits"], dev)
        s, _, _ = inputs.key_samples(self.ring.n, self.ring.primes,
                                     ck["error_sigma"], run.seed, dev)
        self.s_ntt = self.ring.ntt(self.ring.residues(s)[None])[0]
        self.mask = fedavg.top_p_mask(inputs.sensitivity(cfg, run.seed,
                                                          dev), p)

    def base(self):
        return inputs.base_vector(self.cfg, self.seed, self.ring.device)

    def client(self, base, rnd, i, offset_std):
        return inputs.client_vector(base, self.seed, rnd, i, offset_std)

    def _err(self, rows: int, c0_c1, scale, want_enc, block: int) -> float:
        """max |decode(decrypt(c0, c1)) - want| over the encrypted values,
        `block` rows at a time (c0_c1(r0, r1) gives the rows' residues);
        the padding slots past the last value must decode to 0."""
        slots = self.ring.n // 2
        n = want_enc.numel()
        worst = 0.0
        for r in range(0, rows, block):
            c0, c1 = c0_c1(r, min(rows, r + block))
            z = ref_ckks.decrypt_decode(self.ring, c0, c1, self.s_ntt,
                                        scale).reshape(-1)
            lo = r * slots
            w = torch.zeros_like(z)
            hi = min(n, lo + z.numel())
            if hi > lo:
                w[: hi - lo] = want_enc[lo:hi]
            worst = max(worst, fedavg.max_abs_err(z, w))
        return worst

    def enc_err(self, c0, c1, scale, want_enc, block: int = 1024) -> float:
        """The error of a ciphertext's NTT-domain rows c0, c1 [B, L, N]
        (tensors or u32 arrays), decrypted and decoded by the reference."""
        return self._err(c0.shape[0], lambda a, b: (
            self._residues(c0[a:b]), self._residues(c1[a:b])), scale,
            want_enc, block)

    def seeded_enc_err(self, c0_rows, a_seed: int, scale, want_enc,
                       block: int = 512) -> float:
        """The error of a seeded upload's c0 rows (u32 [L, N] arrays),
        decrypted with the public `a` the reference expands from the
        seed."""
        ids = lambda a, b: torch.arange(a, b, device=self.ring.device)  # noqa: E731
        return self._err(len(c0_rows), lambda a, b: (
            self._residues(np.stack(c0_rows[a:b])),
            ref_threefry.a_rows(a_seed, ids(a, b), self.ring.primes,
                                self.ring.n)), scale, want_enc, block)

    def _residues(self, x):
        """u32 residues (an array or an int32 tensor) as int64 on the
        reference's device."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x).view(np.int32))
        return x.to(self.ring.device).to(torch.int64) & 0xFFFFFFFF


def leaves_wrong(cfg: dict, tree) -> int:
    """Leaves of a recovered tree missing, or of another shape or dtype
    than the configuration lists."""
    bad = 0
    for path, shape, _, _ in inputs.leaves(cfg):
        node = tree
        for p in path.split("/"):
            node = node.get(p) if isinstance(node, dict) else None
        if not isinstance(node, torch.Tensor) or tuple(node.shape) != shape \
                or node.dtype != torch.float32:
            bad += 1
    return bad


def flat(cfg: dict, tree):
    """The recovered tree's leaves in the configuration's order, as one
    vector."""
    out = []
    for path, _, _, _ in inputs.leaves(cfg):
        node = tree
        for p in path.split("/"):
            node = node[p]
        out.append(node.reshape(-1))
    return torch.cat(out)


def masked_err(got, want, mask, block: int = 1 << 26) -> float:
    """max |got - want| over the masked entries, in blocks."""
    worst = 0.0
    for i in range(0, got.numel(), block):
        m = mask[i:i + block]
        worst = max(worst, fedavg.max_abs_err(got[i:i + block][m],
                                              want[i:i + block][m]))
    return worst


def recovered_numbers(cfg: dict, tree, want, mask) -> dict:
    """The recovered model against the expected FedAvg: its leaves, the
    encrypted entries and the plain entries."""
    nums = {"leaves_wrong": leaves_wrong(cfg, tree)}
    if nums["leaves_wrong"]:
        nums["rec_enc_err"] = nums["rec_plain_err"] = float("inf")
        return nums
    got = flat(cfg, tree)
    nums["rec_enc_err"] = masked_err(got, want, mask)
    nums["rec_plain_err"] = masked_err(got, want, ~mask)
    return nums


def quantized(x, codec: str):
    """The values a plain segment of `codec` carries, as the configuration
    states them (f16: round to nearest half precision)."""
    if codec == "f16":
        return x.to(torch.float16).to(torch.float64)
    if codec == "f32":
        return x.to(torch.float64)
    raise ValueError(f"no expectation for plain codec {codec}")
