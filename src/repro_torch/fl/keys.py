"""Key management (paper §2.2, Appendix B).

* KeyAuthority: the trusted key-authority server.  It makes the CKKS key
  pair, hands (pk, sk) to authenticated clients and only the public crypto
  context to the aggregation server (no collusion assumed).
* ThresholdKeyAuthority: the additive n-of-n variant.  The parties run the
  interactive keygen; decryption needs every share (plus smudging noise),
  so a corrupted server and n - 1 clients still cannot decrypt an honest
  client's update.

`seed` seeds a `torch.Generator` on the context's device (not the JAX
package's threefry key: the same seed gives other keys).  Without a context
both make `make_context()`, which needs a card.
"""
from __future__ import annotations

import torch

from repro_torch.core.ckks import cipher, threshold
from repro_torch.core.ckks.params import CkksContext, make_context


def _generator(ctx: CkksContext, seed: int) -> torch.Generator:
    return torch.Generator(device=ctx.device).manual_seed(seed)


class KeyAuthority:
    def __init__(self, ctx: CkksContext | None = None, seed: int = 0):
        self.ctx = ctx if ctx is not None else make_context()
        self._sk, self._pk = cipher.keygen(self.ctx,
                                           _generator(self.ctx, seed))

    # clients get both keys; the aggregation server only ever calls
    # public_context().
    def client_keys(self) -> tuple[dict, dict]:
        return self._pk, self._sk

    def public_context(self) -> CkksContext:
        return self.ctx


class ThresholdKeyAuthority:
    """Coordination point for the interactive additive threshold keygen."""

    def __init__(self, n_parties: int, ctx: CkksContext | None = None,
                 seed: int = 0):
        self.ctx = ctx if ctx is not None else make_context()
        self.n_parties = n_parties
        self.parties, self._pk = threshold.threshold_keygen(
            self.ctx, _generator(self.ctx, seed), n_parties)

    def public_key(self) -> dict:
        return self._pk

    def party(self, i: int) -> threshold.ThresholdParty:
        return self.parties[i]

    def partial_decrypt(self, i: int, ct, gen: torch.Generator):
        return threshold.partial_decrypt(self.ctx, self.parties[i], ct, gen)

    def combine(self, ct, partials):
        return threshold.combine_partials(self.ctx, ct, partials)
