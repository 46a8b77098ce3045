"""Distributed HE secure-aggregation step (the paper's server hot loop,
mapped onto a device mesh).

Two regimes, as in the JAX package (DESIGN.md §8):

  * limb-sharded: when the mesh's model axis divides the RNS limb count
    (and its data axis the chunk count), ciphertext chunks are cut over
    `data` and limbs over `model`, one weighted_sum launch per block;
  * chunk-only: otherwise the chunk axis is cut over every slot of the
    mesh and limbs stay whole.

The plaintext remainder is cut like the chunks in both, and every block
sums its own part.  Nothing is compiled: the step is a function over
placed blocks (core.ckks.sharded.BlockGrid).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.ckks import encoding
from repro_torch.core.ckks.params import CkksContext, make_context
from repro_torch.core.ckks.sharded import Layout, ShardedHe
from repro_torch.kernels import ops
from repro_torch.launch.mesh import HeMesh


@dataclasses.dataclass(frozen=True)
class HeAggSpec:
    """Static description of one aggregation round's tensors."""

    n_clients: int
    n_chunks: int            # ciphertexts per client (padded to mesh size)
    n_plain: int             # plaintext parameters (padded to mesh size)
    ctx: CkksContext

    @staticmethod
    def for_model(n_params: int, p_ratio: float, n_clients: int,
                  mesh_size: int, ctx: CkksContext | None = None):
        ctx = ctx or make_context()
        n_enc = int(round(n_params * p_ratio))
        chunks = max(1, -(-n_enc // ctx.slots))
        chunks = -(-chunks // mesh_size) * mesh_size
        n_plain = n_params - n_enc
        n_plain = -(-n_plain // mesh_size) * mesh_size
        return HeAggSpec(n_clients=n_clients, n_chunks=chunks,
                         n_plain=n_plain, ctx=ctx)

    def input_specs(self) -> dict:
        """{name: (shape, dtype)} of the step's inputs."""
        c, l, n = self.n_clients, self.ctx.n_limbs, self.ctx.n_poly
        return {"cts": ((c, self.n_chunks, l, 2, n), torch.int32),
                "plain": ((c, self.n_plain), torch.float32)}

    def limb_sharded(self, mesh: HeMesh) -> bool:
        """True when the mesh's model axis can host whole limb shards."""
        return self.ctx.n_limbs % mesh.n_model == 0 \
            and self.n_chunks % mesh.n_data == 0

    def shardings(self, mesh: HeMesh) -> dict:
        """Layouts of the step inputs: cts [C, chunks, L, 2, N] with chunks
        on the data axis and limbs on the model axis; in the chunk-only
        regime chunks over every slot of the mesh (flattened to a model
        axis of 1, so limbs stay whole).  plain [C, n_plain] is cut like
        the chunks."""
        m = mesh if self.limb_sharded(mesh) else mesh.flattened()
        return {"cts": Layout(m, 1, -3), "plain": Layout(m, 1, None)}

    def wire_bytes_per_client(self) -> int:
        return self.n_chunks * self.ctx.ciphertext_bytes(packed=False) \
            + 4 * self.n_plain


def make_he_agg_step(spec: HeAggSpec, weights: list[float], mesh=None):
    """Server aggregation: sum_i w_i (*) ct_i (HE) + sum_i w_i plain_i.

    Without a mesh, step(cts, plain) runs the single-device op on tensors
    and returns tensors.  With one, it places its inputs by
    spec.shardings(mesh) (tensors are placed, BlockGrids in that layout pass
    through) and returns the ciphertext and plaintext aggregates as
    BlockGrids: each block's weighted_sum and weighted sum of plaintext run
    on that block's device.
    """
    ctx = spec.ctx
    w_mont = torch.from_numpy(encoding.encode_weights_mont(
        weights, ctx).view(np.int32).copy())                      # [C, L]
    w_plain = torch.from_numpy(np.asarray(weights, np.float32))

    if mesh is None:
        def step(cts, plain):
            enc = ops.weighted_sum(cts, w_mont.to(cts.device), ctx,
                                   limb_axis=-3)
            pt = torch.einsum("c,cp->p", w_plain.to(plain.device), plain)
            return enc, pt

        return step

    sh = spec.shardings(mesh)
    eng = ShardedHe(ctx, sh["cts"].mesh)

    def step(cts, plain):
        x, p = sh["cts"].place(cts), sh["plain"].place(plain)
        l = x.shape[-3]

        def body(d, m):
            c = eng.slot_ctx(d, m, l)
            lo, hi = x.limb_range(m)
            return (ops.weighted_sum(x.blocks[d][m],
                                     w_mont[:, lo:hi].to(c.device), c,
                                     limb_axis=-3),
                    torch.einsum("c,cp->p", w_plain.to(c.device),
                                 p.blocks[d][m]))

        return eng.map_slots(body, (x.shape[1:], 0, -3, x.rows),
                             (p.shape[1:], 0, None, p.rows))

    return step


def jit_he_agg_step(spec: HeAggSpec, mesh: HeMesh, weights: list[float]):
    """The mesh step with its inputs placed by spec.shardings(mesh) first
    (there is nothing to compile: the step runs eagerly over the blocks)."""
    sh = spec.shardings(mesh)
    step = make_he_agg_step(spec, weights, mesh=mesh)
    return lambda cts, plain: step(sh["cts"].place(cts),
                                   sh["plain"].place(plain))
