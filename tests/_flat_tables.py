"""The flat NTT's tables at any N >= 2, for the port's kernel tests.

A context (`params.make_context`) also builds the 4-step tables, which need
N >= 4; the flat kernels take N = 2 too.  `FlatTables` builds only the
fields the flat NTTs read, from the port's own prime and root helpers, the
same way `params.make_limb_context` does.
"""
import numpy as np

from repro_torch import interop
from repro_torch.core.ckks import params as tparams


class FlatTables:
    """psi_rev_mont, psi_inv_rev_mont [L, N] and qs, qinv_negs,
    n_inv_monts [L] as int32 tensors (u32 bits) on `device`."""

    def __init__(self, n, l, device="cpu"):
        logn = n.bit_length() - 1
        r = 1 << 32
        self.primes = tparams.find_ntt_primes(n, l)
        rev, inv_rev, qinv, n_inv = [], [], [], []
        for q in self.primes:
            psi = tparams.root_of_unity(q, 2 * n)
            psi_inv = pow(psi, -1, q)
            js = [tparams.bit_reverse(i, logn) for i in range(n)]
            rev.append([pow(psi, j, q) * r % q for j in js])
            inv_rev.append([pow(psi_inv, j, q) * r % q for j in js])
            qinv.append((-pow(q, -1, r)) % r)
            n_inv.append(pow(n, -1, q) * r % q)

        def t(v):
            return interop.residues_from_np(np.asarray(v, dtype=np.uint32),
                                            device)

        self.psi_rev_mont, self.psi_inv_rev_mont = t(rev), t(inv_rev)
        self.qs, self.qinv_negs = t(self.primes), t(qinv)
        self.n_inv_monts = t(n_inv)
