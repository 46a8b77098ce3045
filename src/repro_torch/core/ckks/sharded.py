"""Sharded HE engine: the limb-fused execution model cut over a device mesh
(DESIGN.md §8), driven by one process.

A `launch.mesh.HeMesh` is a `[data][model]` grid of devices.  A tensor on
the mesh is a `BlockGrid`: its chunk (row) axis cut over `data` into
contiguous ranges, its RNS limb axis over `model`, one contiguous block on
each slot's device.  Rows that do not divide get torch.tensor_split's
uneven ranges (no padding); limbs must divide (`make_he_mesh` picks such a
mesh).  A tensor with no row axis (keys, a broadcast accumulator) is
repeated on every data row, one with no limb axis (noise draws, plaintext)
on every model column.  Placing a tensor copies each block once, onto its
slot's device; every op takes a tensor (placed on entry, as the JAX engine
re-shards on entry) or a BlockGrid in its layout, and returns BlockGrids.

Each op runs the port's single-device body on every block with the context
of that slot's limb range on that slot's device (`CkksContext.limb_range`),
so every launch reads only its own device's memory and every op is
bit-identical to the single-device path for any mesh shape (DESIGN.md
§8.3).  Draws are made as the single-device functions make them (the same
calls, shapes and generator, on the context's device) and each block is
handed its rows.  The draws whose shape includes L (keygen's uniform `a`,
the seeded ciphertext's public `a`) are made for every limb and sliced, as
the JAX engine does; a block's `a` rows are expanded on its own device from
their global chunk ids, so a JAX server expands the same blob unchanged.

Data moves between slots only where decrypt gathers the limb shards (CRT
decode needs every limb) and where a streaming ingest hands its aggregate
out; `ShardedHe.gathers` counts both.

While obs is enabled each dispatch (keygen, the four encrypt entry points,
decrypt, weighted_sum, weighted_accum, weighted_accum_chunks) runs under an
`obs.kernel_launch("sharded.<op>")` that waits for its blocks' devices.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.ckks import cipher, encoding
from repro_torch.core.ckks.cipher import Ciphertext
from repro_torch.core.ckks.params import CkksContext
from repro_torch.kernels import ops
from repro_torch.launch.mesh import HeMesh


def _axis(axis, ndim):
    return None if axis is None else axis % ndim


@dataclasses.dataclass(frozen=True)
class BlockGrid:
    """A global tensor of `shape` held as blocks[d][m], each contiguous on
    mesh.device(d, m).  Slot (d, m) holds rows [rows[d], rows[d + 1]) of
    `row_axis` and limbs limb_range(m) of `limb_axis` (whole where the axis
    is None)."""

    mesh: HeMesh
    shape: tuple
    row_axis: int | None
    limb_axis: int | None
    rows: tuple | None          # n_data + 1 offsets along row_axis
    blocks: tuple

    @property
    def dtype(self):
        return self.blocks[0][0].dtype

    def dim(self) -> int:
        return len(self.shape)

    def row_range(self, d: int) -> tuple[int, int]:
        if self.row_axis is None:
            return 0, 0
        return self.rows[d], self.rows[d + 1]

    def limb_range(self, m: int) -> tuple[int, int]:
        if self.limb_axis is None:
            return 0, 0
        k = self.shape[self.limb_axis] // self.mesh.n_model
        return m * k, (m + 1) * k

    def index(self, d: int, m: int) -> tuple:
        """Slot (d, m)'s block as an index into the global tensor."""
        idx = [slice(None)] * len(self.shape)
        if self.row_axis is not None:
            idx[self.row_axis] = slice(*self.row_range(d))
        if self.limb_axis is not None:
            idx[self.limb_axis] = slice(*self.limb_range(m))
        return tuple(idx)

    def slots(self):
        """(d, m) of every slot holding a distinct part of the tensor."""
        for d in range(self.mesh.n_data if self.row_axis is not None else 1):
            for m in range(self.mesh.n_model
                           if self.limb_axis is not None else 1):
                yield d, m

    def assemble(self, device) -> torch.Tensor:
        """The global tensor on `device`: a movement of data between slots
        (ShardedHe.gather counts the engine's)."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for d, m in self.slots():
            out[self.index(d, m)] = self.blocks[d][m]
        return out

    def equals(self, x: torch.Tensor) -> bool:
        """Every block equals its part of the tensor x (moved to the block's
        device); nothing is assembled."""
        if tuple(x.shape) != self.shape:
            return False
        return all(torch.equal(b, x[self.index(d, m)].to(b.device))
                   for d, row in enumerate(self.blocks)
                   for m, b in enumerate(row))

    def on_slot_devices(self) -> bool:
        return all(self.blocks[d][m].device == self.mesh.device(d, m)
                   for d in range(self.mesh.n_data)
                   for m in range(self.mesh.n_model))


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a tensor is cut over a mesh: `row_axis` over data, `limb_axis`
    over model; None keeps the axis whole."""

    mesh: HeMesh
    row_axis: int | None = 0
    limb_axis: int | None = -3

    def row_offsets(self, n_rows: int) -> tuple:
        """torch.tensor_split's ranges: the first n_rows % n_data slots
        take one row more."""
        q, r = divmod(int(n_rows), self.mesh.n_data)
        offs = [0]
        for d in range(self.mesh.n_data):
            offs.append(offs[-1] + q + (d < r))
        return tuple(offs)

    def place(self, x, rows=None) -> BlockGrid:
        """Copy each block of the tensor x to its slot's device, once.  A
        BlockGrid already in this layout (and these row ranges, if given)
        passes through.  `rows` pins the row ranges (n_data + 1 offsets)."""
        ndim = x.dim()
        ra, la = _axis(self.row_axis, ndim), _axis(self.limb_axis, ndim)
        if isinstance(x, BlockGrid):
            if (x.mesh, x.row_axis, x.limb_axis) != (self.mesh, ra, la) or \
                    (rows is not None and tuple(rows) != x.rows):
                raise ValueError("BlockGrid is laid out differently from "
                                 "what this op needs; pass the tensor")
            return x
        mesh = self.mesh
        if la is not None and x.shape[la] % mesh.n_model:
            raise ValueError(f"limb count {x.shape[la]} is not divisible by "
                             f"model-axis size {mesh.n_model}")
        offs = None
        if ra is not None:
            offs = (tuple(int(r) for r in rows) if rows is not None
                    else self.row_offsets(x.shape[ra]))
            if len(offs) != mesh.n_data + 1 or offs[-1] != x.shape[ra]:
                raise ValueError(f"row ranges {offs} do not cut "
                                 f"{x.shape[ra]} rows over {mesh.n_data}")
        grid = BlockGrid(mesh, tuple(x.shape), ra, la, offs, ())
        blocks = tuple(
            tuple(_copy_to(x[grid.index(d, m)], mesh.device(d, m))
                  for m in range(mesh.n_model))
            for d in range(mesh.n_data))
        return dataclasses.replace(grid, blocks=blocks)


def _copy_to(view, device):
    return torch.empty(view.shape, dtype=view.dtype,
                       device=device).copy_(view)


def stack(datas) -> torch.Tensor | BlockGrid:
    """torch.stack of tensors, or of BlockGrids in one layout block by block
    (a new leading axis; nothing moves between slots)."""
    if not isinstance(datas[0], BlockGrid):
        return torch.stack(list(datas))
    g = datas[0]
    if any((x.mesh, x.shape, x.row_axis, x.limb_axis, x.rows)
           != (g.mesh, g.shape, g.row_axis, g.limb_axis, g.rows)
           for x in datas):
        raise ValueError("cannot stack BlockGrids laid out differently")
    shift = lambda a: None if a is None else a + 1      # noqa: E731
    return BlockGrid(g.mesh, (len(datas),) + g.shape, shift(g.row_axis),
                     shift(g.limb_axis), g.rows, tuple(
                         tuple(torch.stack([x.blocks[d][m] for x in datas])
                               for m in range(g.mesh.n_model))
                         for d in range(g.mesh.n_data)))


class ShardedHe:
    """Sharded counterpart of the cipher-level API, bound to (ctx, mesh).

    Attributes:
        ctx: the CkksContext; draws are made on its device.
        mesh: a launch.mesh.HeMesh.
        gathers: movements of data between slots so far (decrypt's gather of
            limb shards and `gather` calls).
    """

    def __init__(self, ctx: CkksContext, mesh: HeMesh):
        self.ctx = ctx
        self.mesh = mesh
        self.gathers = 0
        self._ctxs: dict = {}

    @property
    def n_data(self) -> int:
        return self.mesh.n_data

    @property
    def n_model(self) -> int:
        return self.mesh.n_model

    def _check_limbs(self, l: int) -> None:
        if l % self.n_model:
            raise ValueError(
                f"limb count {l} is not divisible by model-axis size "
                f"{self.n_model}; build the mesh with "
                "launch.mesh.make_he_mesh(n_limbs, ...) so the limb grid "
                "axis maps onto whole shards")

    def slot_ctx(self, d: int, m: int, l: int | None = None) -> CkksContext:
        """The context of slot (d, m)'s limbs of an l-limb tensor (default:
        all) on that slot's device, with its tables; built once per
        engine."""
        l = self.ctx.n_limbs if l is None else int(l)
        self._check_limbs(l)
        k = l // self.n_model
        return self.range_ctx(self.mesh.device(d, m), m * k, (m + 1) * k)

    def range_ctx(self, device, lo: int, hi: int) -> CkksContext:
        """The context of limbs [lo, hi) on `device`, built once per
        engine (all limbs: where a block expands its public `a` rows)."""
        key = (torch.device(device), lo, hi)
        if key not in self._ctxs:
            self._ctxs[key] = self.ctx.limb_range(lo, hi, device)
        return self._ctxs[key]

    # -- placement -----------------------------------------------------------

    def place(self, x, row_axis: int | None = 0, limb_axis: int | None = -3,
              rows=None) -> BlockGrid:
        """A tensor (or BlockGrid) on the mesh: `row_axis` over data,
        `limb_axis` over model (see Layout.place)."""
        if limb_axis is not None:
            self._check_limbs(x.shape[limb_axis])
        return Layout(self.mesh, row_axis, limb_axis).place(x, rows)

    def put_ciphertext(self, ct: Ciphertext) -> Ciphertext:
        """Place ciphertext data u32[B, L, 2, N] on the mesh (chunks -> data
        axis, limbs -> model axis)."""
        return Ciphertext(data=self.place(ct.data), scale=ct.scale)

    def gather(self, x: BlockGrid, device=None) -> torch.Tensor:
        """Assemble a BlockGrid on one device (default: the context's),
        counted in `gathers`."""
        self.gathers += 1
        return x.assemble(self.ctx.device if device is None else device)

    def _key(self, k, l: int) -> BlockGrid:
        """A key int32[L, N] as limb blocks of its first l limbs."""
        if isinstance(k, BlockGrid) and k.shape[0] != l:
            raise ValueError(f"key blocks hold {k.shape[0]} limbs, the "
                             f"operand {l}; pass the key as a tensor")
        return self.place(k if isinstance(k, BlockGrid) else k[:l], None, 0)

    def map_slots(self, fn, *specs) -> tuple:
        """Run fn(d, m) on every slot; its i-th output becomes block (d, m)
        of grid i, laid out as specs[i] = (shape, row_axis, limb_axis,
        rows)."""
        res = [[fn(d, m) for m in range(self.n_model)]
               for d in range(self.n_data)]
        return tuple(
            BlockGrid(self.mesh, tuple(shape), _axis(ra, len(shape)),
                      _axis(la, len(shape)), rows,
                      tuple(tuple(res[d][m][i] for m in range(self.n_model))
                            for d in range(self.n_data)))
            for i, (shape, ra, la, rows) in enumerate(specs))

    # -- keys -----------------------------------------------------------------

    def keygen(self, gen: torch.Generator) -> tuple[dict, dict]:
        """Sharded keygen: the draws of cipher.keygen(ctx, gen), so the keys
        are bit-identical to it.  Every int32[L, N] component is cut along
        the model axis and repeated on every data row."""
        n = self.ctx.n_poly
        with obs.kernel_launch("sharded.keygen") as kl:
            s_sym = cipher.sample_ternary(gen, (n,), self.ctx.device)
            a = cipher.sample_uniform(gen, (n,), self.ctx)
            e_sym = cipher.sample_gaussian(gen, (n,), self.ctx.device,
                                           self.ctx.error_sigma)
            return kl.done(self.keygen_from_samples(s_sym, a, e_sym))

    def keygen_from_samples(self, s_sym, a, e_sym) -> tuple[dict, dict]:
        """cipher.keygen_from_samples per slot on its limbs of the uniform
        a int32[L, N] (drawn for every limb, then cut)."""
        l, n = self.ctx.n_limbs, self.ctx.n_poly
        a = self.place(a, None, 0)

        def body(d, m):
            c = self.slot_ctx(d, m)
            sk, pk = cipher.keygen_from_samples(
                c, s_sym.to(c.device), a.blocks[d][m], e_sym.to(c.device))
            return sk["s_mont"], pk["pk0_mont"], pk["pk1_mont"]

        spec = ((l, n), None, 0, None)
        s, pk0, pk1 = self.map_slots(body, spec, spec, spec)
        return {"s_mont": s}, {"pk0_mont": pk0, "pk1_mont": pk1}

    # -- encrypt --------------------------------------------------------------

    def encrypt_values(self, pk: dict, values,
                       gen: torch.Generator) -> Ciphertext:
        """float32[B, slots] -> fresh ciphertext: encode on the context's
        device, then encrypt_coeffs; bit-identical to
        cipher.encrypt_values."""
        with obs.kernel_launch("sharded.encrypt_values",
                               rows=int(values.shape[0])) as kl:
            return kl.done(self._encrypt_coeffs(
                pk, encoding.encode(values, self.ctx), gen, self.ctx.delta))

    def encrypt_coeffs(self, pk: dict, m_coeff, gen: torch.Generator,
                       scale: float | None = None) -> Ciphertext:
        """Public-key encryption of int32[B, L, N] residues with the draws
        of cipher.encrypt_coeffs; chunks over data, limbs over model."""
        with obs.kernel_launch("sharded.encrypt_coeffs",
                               rows=int(m_coeff.shape[0])) as kl:
            return kl.done(self._encrypt_coeffs(pk, m_coeff, gen, scale))

    def _encrypt_coeffs(self, pk: dict, m_coeff, gen: torch.Generator,
                        scale: float | None) -> Ciphertext:
        b, n = m_coeff.shape[0], self.ctx.n_poly
        dev, sigma = self.ctx.device, self.ctx.error_sigma
        u = cipher.sample_ternary(gen, (b, n), dev)
        e0 = cipher.sample_gaussian(gen, (b, n), dev, sigma)
        e1 = cipher.sample_gaussian(gen, (b, n), dev, sigma)
        return self.encrypt_coeffs_from_samples(pk, m_coeff, u, e0, e1, scale)

    def encrypt_coeffs_from_samples(self, pk: dict, m_coeff, u_sym, e0_sym,
                                    e1_sym,
                                    scale: float | None = None) -> Ciphertext:
        """cipher.encrypt_coeffs_from_samples per block: each block takes
        its rows of the draws int[B, N] and its limbs of m_coeff and pk."""
        l = m_coeff.shape[-2]
        m = self.place(m_coeff, 0, -2)
        u, e0, e1 = (self.place(v, 0, None, m.rows)
                     for v in (u_sym, e0_sym, e1_sym))
        pk0, pk1 = self._key(pk["pk0_mont"], l), self._key(pk["pk1_mont"], l)
        scale = float(scale if scale is not None else self.ctx.delta)

        def body(d, i):
            ct = cipher.encrypt_coeffs_from_samples(
                self.slot_ctx(d, i, l),
                {"pk0_mont": pk0.blocks[d][i], "pk1_mont": pk1.blocks[d][i]},
                m.blocks[d][i], u.blocks[d][i], e0.blocks[d][i],
                e1.blocks[d][i], scale)
            return (ct.data,)

        shape = tuple(m.shape[:-1]) + (2, self.ctx.n_poly)
        data, = self.map_slots(body, (shape, 0, -3, m.rows))
        return Ciphertext(data=data, scale=scale)

    def encrypt_values_seeded(self, sk: dict, values, gen: torch.Generator,
                              a_seed: int,
                              derive: int = cipher.DERIVE_FOLD_CHUNK
                              ) -> Ciphertext:
        """float32[B, slots] -> seeded secret-key ciphertext, bit-identical
        to cipher.encrypt_values_seeded (same noise draws, same public `a`
        stream for a_seed and derive)."""
        with obs.kernel_launch("sharded.encrypt_values_seeded",
                               rows=int(values.shape[0])) as kl:
            return kl.done(self._encrypt_coeffs_seeded(
                sk, encoding.encode(values, self.ctx), gen, a_seed,
                self.ctx.delta, derive))

    def encrypt_coeffs_seeded(self, sk: dict, m_coeff, gen: torch.Generator,
                              a_seed: int, scale: float | None = None,
                              derive: int = cipher.DERIVE_FOLD_CHUNK
                              ) -> Ciphertext:
        """Seeded encryption of int32[B, L, N] residues with the draws of
        cipher.encrypt_coeffs_seeded."""
        with obs.kernel_launch("sharded.encrypt_coeffs_seeded",
                               rows=int(m_coeff.shape[0])) as kl:
            return kl.done(self._encrypt_coeffs_seeded(
                sk, m_coeff, gen, a_seed, scale, derive))

    def _encrypt_coeffs_seeded(self, sk: dict, m_coeff, gen: torch.Generator,
                               a_seed: int, scale: float | None,
                               derive: int) -> Ciphertext:
        e = cipher.sample_gaussian(gen, (m_coeff.shape[0], self.ctx.n_poly),
                                   self.ctx.device, self.ctx.error_sigma)
        return self.encrypt_coeffs_seeded_from_samples(sk, m_coeff, e, a_seed,
                                                       scale, derive)

    def encrypt_coeffs_seeded_from_samples(
            self, sk: dict, m_coeff, e_sym, a_seed: int,
            scale: float | None = None,
            derive: int = cipher.DERIVE_FOLD_CHUNK) -> Ciphertext:
        """Seeded encrypt per block: the block expands its rows' public `a`
        (global chunk ids [row offset, row offset + rows)) for every limb on
        its own device, keeps its limbs, and runs
        cipher.encrypt_coeffs_seeded_with_a."""
        l = m_coeff.shape[-2]
        m = self.place(m_coeff, 0, -2)
        e = self.place(e_sym, 0, None, m.rows)
        s = self._key(sk["s_mont"], l)
        for d in range(self.n_data):
            cipher.check_chunk_start(m.rows[d], derive)

        def body(d, i):
            c = self.slot_ctx(d, i, l)
            r0, r1 = m.row_range(d)
            lo, hi = m.limb_range(i)
            a = cipher.expand_a_rows(
                self.range_ctx(c.device, 0, self.ctx.n_limbs), a_seed, r0,
                r1 - r0, derive)[:, lo:hi].contiguous()
            ct = cipher.encrypt_coeffs_seeded_with_a(
                c, {"s_mont": s.blocks[d][i]}, m.blocks[d][i], e.blocks[d][i],
                a, scale)
            return (ct.data,)

        shape = tuple(m.shape[:-1]) + (2, self.ctx.n_poly)
        data, = self.map_slots(body, (shape, 0, -3, m.rows))
        return Ciphertext(data=data, scale=float(
            scale if scale is not None else self.ctx.delta))

    # -- decrypt --------------------------------------------------------------

    def decrypt_to_coeffs(self, sk: dict, ct: Ciphertext) -> torch.Tensor:
        """-> int32[B, L, N] coefficient residues on the context's device.
        mul_add and the inverse NTT run per block; the gather of the limb
        shards after them is the only movement of data between slots in a
        round (counted in `gathers`)."""
        l = ct.n_limbs
        x = self.place(ct.data, 0, -3)
        s = self._key(sk["s_mont"], l)

        def body(d, m):
            return (cipher.decrypt_to_coeffs(
                self.slot_ctx(d, m, l), {"s_mont": s.blocks[d][m]},
                Ciphertext(x.blocks[d][m])),)

        shape = tuple(x.shape[:-2]) + (x.shape[-1],)
        with obs.kernel_launch("sharded.decrypt") as kl:
            coeffs, = self.map_slots(body, (shape, 0, -2, x.rows))
            return kl.done(self.gather(coeffs))

    def decrypt_values(self, sk: dict, ct: Ciphertext) -> torch.Tensor:
        """-> float32[B, slots] (torch decode path, 2 limbs)."""
        return encoding.decode(self.decrypt_to_coeffs(sk, ct), self.ctx,
                               ct.scale)

    # -- aggregation ----------------------------------------------------------

    def _weights(self, weights) -> torch.Tensor:
        return torch.from_numpy(encoding.encode_weights_mont(
            weights, self.ctx).view(np.int32).copy())            # host [C, L]

    def weighted_sum(self, cts: Ciphertext, weights) -> Ciphertext:
        """Fused FedAvg aggregation: cts.data int32[C, B, L, 2, N] (clients
        leading) with chunks over data and limbs over model, one
        weighted_sum launch per block.  Bit-identical to
        cipher.weighted_sum."""
        l = cts.data.shape[-3]
        x = self.place(cts.data, 1, -3)
        w = self._weights(weights)

        def body(d, m):
            c = self.slot_ctx(d, m, l)
            lo, hi = x.limb_range(m)
            return (ops.weighted_sum(x.blocks[d][m], w[:, lo:hi].to(c.device),
                                     c, limb_axis=-3),)

        with obs.kernel_launch("sharded.weighted_sum",
                               n_clients=int(cts.data.shape[0])) as kl:
            data, = kl.done(self.map_slots(body,
                                           (x.shape[1:], 0, -3, x.rows)))
        return Ciphertext(data=data, scale=cts.scale * self.ctx.delta)

    def weighted_accum(self, acc: Ciphertext, ct: Ciphertext,
                       weight: float) -> Ciphertext:
        """Streaming fold acc + w (*) ct, one weighted_accum launch per
        block.  acc broadcasts to ct's shape: an accumulator of ct's shape
        is cut like ct, a smaller one (one row [L, 2, N]) is repeated on
        every data row and read in place by the kernel."""
        l = ct.n_limbs
        x = self.place(ct.data, 0, -3)
        full = tuple(acc.data.shape) == tuple(ct.data.shape)
        a = self.place(acc.data, 0 if full else None, -3,
                       x.rows if full else None)
        w = self._weights([weight])[0]

        def body(d, m):
            c = self.slot_ctx(d, m, l)
            lo, hi = x.limb_range(m)
            return (ops.weighted_accum(a.blocks[d][m], x.blocks[d][m],
                                       w[lo:hi].to(c.device), c,
                                       limb_axis=-3),)

        with obs.kernel_launch("sharded.weighted_accum") as kl:
            data, = kl.done(self.map_slots(body, (x.shape, 0, -3, x.rows)))
        return Ciphertext(data=data, scale=acc.scale)

    def weighted_accum_chunks(self, accs, cts, w_mont, limb_axis: int = -2,
                              out=None) -> BlockGrid:
        """Batched flush acc[k] + w[k] (*) ct[k]: accs, cts int32[K, ..., L,
        ...] with the limb axis at `limb_axis` (-2 for the ops layout, -3
        for ciphertext rows), w_mont int32[K, L'] per-row weights.  Rows
        over data, limbs over model, one launch per block; `out` may be
        `accs` (a BlockGrid), updated in place."""
        l = cts.shape[limb_axis]
        x = self.place(cts, 0, limb_axis)
        if not isinstance(accs, BlockGrid):
            accs = accs.expand(tuple(cts.shape))     # JAX's broadcast_to
        a = self.place(accs, 0, limb_axis, x.rows)
        w = self.place(w_mont if isinstance(w_mont, BlockGrid)
                       else w_mont[:, :l], 0, 1, x.rows)
        o = None if out is None else self.place(out, 0, limb_axis, x.rows)

        def body(d, m):
            return (ops.weighted_accum_chunks(
                a.blocks[d][m], x.blocks[d][m], w.blocks[d][m],
                self.slot_ctx(d, m, l), limb_axis=limb_axis,
                out=None if o is None else o.blocks[d][m]),)

        with obs.kernel_launch("sharded.weighted_accum_chunks",
                               rows=int(cts.shape[0])) as kl:
            res, = kl.done(self.map_slots(body,
                                          (x.shape, 0, limb_axis, x.rows)))
        return res if o is None else o
