"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU with nvcc and skips without one.  The
file imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.ckks import (cipher, encoding, params, sharded,
                                   threshold, transcipher)
from repro_torch.core.secure_agg import ProtectedUpdate
from repro_torch.kernels import (build, he_agg, lift, ntt, ops, pointwise,
                                  ref, tune)
from repro_torch.launch import fl_step, mesh as tmesh
from repro_torch.wire import compress, stream

from _flat_tables import FlatTables
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _residues(rng, ctx, rows, device):
    x = np.stack([rng.randint(0, q, (rows, ctx.n_poly)) for q in ctx.primes],
                 axis=-2)
    return torch.from_numpy(x.astype(np.int32)).to(device)


@pytest.mark.parametrize("n", [2, 32, 256, 1024, 8192, 16384])
def test_kernels_match_plain_versions(cuda, n):
    """N=16384 takes the NTT kernels' 66 KiB dynamic shared memory path,
    N <= 32 their one register pass.  N = 2 has no context (its 4-step
    tables need N >= 4), so it takes the flat tables alone.  The NTTs also
    run on one [L, N] row, keygen's shape."""
    if n >= 4:
        ctx = params.make_test_context(n_poly=n, n_limbs=2, device=cuda)
        t = ctx.device_tables
    else:
        t = FlatTables(n, 2, cuda)
        ctx = types.SimpleNamespace(primes=t.primes, n_poly=n)
    rng = np.random.RandomState(n)
    x, z = _residues(rng, ctx, 5, cuda), _residues(rng, ctx, 5, cuda)
    cts = torch.stack([x, z, x])
    w = torch.from_numpy(np.stack([rng.randint(0, q, 3) for q in ctx.primes],
                                  axis=1).astype(np.int32)).to(cuda)
    ops.reset_launch_counts()
    pairs = [
        (ntt.ntt_fwd_fused(x, t.psi_rev_mont, t.qs, t.qinv_negs),
         ref.ntt_fwd_fused(x, t.psi_rev_mont, t.qs, t.qinv_negs)),
        (ntt.ntt_inv_fused(x, t.psi_inv_rev_mont, t.n_inv_monts, t.qs,
                           t.qinv_negs),
         ref.ntt_inv_fused(x, t.psi_inv_rev_mont, t.n_inv_monts, t.qs,
                           t.qinv_negs)),
        (ntt.ntt_fwd_fused(x[0], t.psi_rev_mont, t.qs, t.qinv_negs),
         ref.ntt_fwd_fused(x[0], t.psi_rev_mont, t.qs, t.qinv_negs)),
        (ntt.ntt_inv_fused(x[0], t.psi_inv_rev_mont, t.n_inv_monts, t.qs,
                           t.qinv_negs),
         ref.ntt_inv_fused(x[0], t.psi_inv_rev_mont, t.n_inv_monts, t.qs,
                           t.qinv_negs)),
        (pointwise.mul_add_fused(x, z[:1], z, t.qs, t.qinv_negs),
         ref.mul_add_fused(x, z[:1], z, t.qs, t.qinv_negs)),
        (he_agg.he_weighted_sum_fused(cts, w, t.qs, t.qinv_negs),
         ref.he_weighted_sum_fused(cts, w, t.qs, t.qinv_negs)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got, want)
    assert ops.launch_counts() == {"ntt_fwd": 2, "ntt_inv": 2,
                                   "ntt4_fwd": 0, "ntt4_inv": 0,
                                   "mul_add": 1, "weighted_sum": 1,
                                   "weighted_accum": 0,
                                   "weighted_accum_chunks": 0,
                                   "mod_lift": 0, "mask_split": 0,
                                   "mask_merge": 0, "ssd_fwd": 0,
                                   "ssd_bwd": 0}


@pytest.mark.parametrize("n", [256, 8192])
def test_ntt4_kernels_match_plain_versions(cuda, n):
    """Every split the tuner sweeps, both 4-step kernels against the plain
    4-step version and the flat NTT, at B=5 (10 (row, limb) pairs)."""
    ctx = params.make_test_context(n_poly=n, n_limbs=2, device=cuda)
    t = ctx.device_tables
    x = _residues(np.random.RandomState(n + 4), ctx, 5, cuda)
    flat_fwd = ref.ntt_fwd_fused(x, t.psi_rev_mont, t.qs, t.qinv_negs)
    flat_inv = ref.ntt_inv_fused(x, t.psi_inv_rev_mont, t.n_inv_monts,
                                 t.qs, t.qinv_negs)
    configs = [c.config for c in tune.candidates("ntt_fwd", n, 2, 5)
               if c.backend == "ntt4"]
    assert len(configs) == 3
    ops.reset_launch_counts()
    for cfg in configs:
        s = ctx.split_device_tables(cfg.ntt4_split)
        fwd = ntt.ntt4_fwd_fused(x, s.ntt4_psi1_mont, s.ntt4_psi2_mont,
                                 s.ntt4_corr_mont, s.qs, s.qinv_negs,
                                 radix=cfg.radix, block_b=cfg.block_b)
        inv = ntt.ntt4_inv_fused(x, s.ntt4_psi1_inv_mont,
                                 s.ntt4_psi2_inv_mont, s.ntt4_corr_inv_mont,
                                 s.n_inv_monts, s.qs, s.qinv_negs,
                                 radix=cfg.radix, block_b=cfg.block_b)
        torch.cuda.synchronize()
        assert torch.equal(fwd, ref.ntt4_fwd_fused(
            x, s.ntt4_psi1_mont, s.ntt4_psi2_mont, s.ntt4_corr_mont, s.qs,
            s.qinv_negs, cfg.radix)), cfg
        assert torch.equal(fwd, flat_fwd), cfg
        assert torch.equal(inv, flat_inv), cfg
    counts = ops.launch_counts()
    assert (counts["ntt4_fwd"], counts["ntt4_inv"]) == (3, 3)
    assert counts["ntt_fwd"] == counts["ntt_inv"] == 0


@pytest.mark.parametrize("n", [4, 32, 1024, 16384])
def test_ntt4_kernels_at_every_split(cuda, n):
    """Every split of N (the twist after every stage it can follow: inside
    each register pass and on a pass edge), both directions, on rows one
    word off the 16-byte grid as well: equal to the flat kernel's output
    and to the plain inverse, and launched once per call."""
    ctx = params.make_test_context(n_poly=n, n_limbs=2, device=cuda)
    t = ctx.device_tables
    x = _residues(np.random.RandomState(n + 5), ctx, 3, cuda)
    buf = torch.zeros(x.numel() + 1, dtype=torch.int32, device=cuda)
    x_off = buf[1:].view(x.shape)
    x_off.copy_(x)
    flat_fwd = ntt.ntt_fwd_fused(x, t.psi_rev_mont, t.qs, t.qinv_negs)
    flat_inv = ref.ntt_inv_fused(x, t.psi_inv_rev_mont, t.n_inv_monts,
                                 t.qs, t.qinv_negs)
    splits = [(1 << k, n >> k) for k in range(1, n.bit_length() - 1)]
    ops.reset_launch_counts()
    for split in splits:
        s = ctx.split_device_tables(split)
        for xin in (x, x_off):
            fwd = ntt.ntt4_fwd_fused(xin, s.ntt4_psi1_mont, s.ntt4_psi2_mont,
                                     s.ntt4_corr_mont, s.qs, s.qinv_negs)
            inv = ntt.ntt4_inv_fused(xin, s.ntt4_psi1_inv_mont,
                                     s.ntt4_psi2_inv_mont,
                                     s.ntt4_corr_inv_mont, s.n_inv_monts,
                                     s.qs, s.qinv_negs)
            torch.cuda.synchronize()
            assert torch.equal(fwd, flat_fwd), split
            assert torch.equal(inv, flat_inv), split
    counts = ops.launch_counts()
    assert counts["ntt4_fwd"] == counts["ntt4_inv"] == 2 * len(splits)


def test_ntt_ops_resolve_to_the_4step_kernels_on_the_card(cuda):
    """A cuda cache entry sends ops.ntt_fwd / ntt_inv to the 4-step kernels
    (the flat ones stay at 0 launches), with the flat kernels' bits; the
    sweep's winner is never slower than the default; build lists ntt4."""
    assert "ntt4" in build.SOURCES and "ntt4" in build.load_all()
    ctx = params.make_test_context(n_poly=1024, n_limbs=2, device=cuda)
    x = _residues(np.random.RandomState(9), ctx, 3, cuda)
    tune.clear_cache()
    try:
        ops.reset_launch_counts()
        want = ops.ntt_fwd(x, ctx)
        want_inv = ops.ntt_inv(want, ctx)
        cfg = tune.KernelConfig(block_b=4, ntt4_split=(64, 16), radix=4)
        for op in tune.OPS:
            tune.put(op, 1024, 2, 3, "cuda", "ntt4", cfg)
        got = ops.ntt_fwd(x, ctx)
        got_inv = ops.ntt_inv(got, ctx)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got_inv, want_inv)
        assert torch.equal(got_inv, x)
        assert ops.launch_counts() == {
            "ntt_fwd": 1, "ntt_inv": 1, "ntt4_fwd": 1, "ntt4_inv": 1,
            "mul_add": 0, "weighted_sum": 0, "weighted_accum": 0,
            "weighted_accum_chunks": 0, "mod_lift": 0, "mask_split": 0,
            "mask_merge": 0, "ssd_fwd": 0, "ssd_bwd": 0}
        gen = torch.Generator(device=cuda).manual_seed(1)
        res = tune.sweep_op("ntt_inv", ctx, 3, gen, reps=2)
        assert res.platform == "cuda" and res.n_candidates == 4
        assert res.tuned_ms <= res.default_ms
    finally:
        tune.clear_cache()


def test_strided_operands_and_ciphertext_layout(cuda):
    """Decrypt's interleaved c0/c1 views and weighted_sum's limb_axis=-3."""
    ctx = params.make_test_context(n_poly=1024, n_limbs=2, device=cuda)
    t = ctx.device_tables
    rng = np.random.RandomState(1)
    data = torch.stack([_residues(rng, ctx, 4, cuda) for _ in range(2)],
                       dim=-2)                              # [B, L, 2, N]
    s = _residues(rng, ctx, 1, cuda)
    got = ops.mul_add(data[..., 1, :], s, data[..., 0, :], ctx)
    want = ref.mul_add_fused(data[..., 1, :], s, data[..., 0, :], t.qs,
                             t.qinv_negs)
    stack = torch.stack([data, data.flip(0)])
    w = torch.tensor([[5, 6], [7, 8]], dtype=torch.int32, device=cuda)
    agg = ops.weighted_sum(stack, w, ctx, limb_axis=-3)
    agg_want = ref.he_weighted_sum_fused(stack, w, t.qs, t.qinv_negs, -3)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(agg, agg_want)


@pytest.mark.parametrize("k", [1, 7, 300])
@pytest.mark.parametrize("limb_axis", [-2, -3])
def test_weighted_accum_chunks_matches_plain_version(cuda, k, limb_axis):
    """K not a power of two, both limb axes, rows weighted as if from
    different clients; in place (out=acc) and not."""
    ctx = params.make_test_context(n_poly=1024, n_limbs=3, delta_bits=20,
                                   device=cuda)
    t = ctx.device_tables
    rng = np.random.RandomState(k)
    rows = [_residues(rng, ctx, k, cuda) for _ in range(4)]   # [K, L, N]
    stack = -2 if limb_axis == -3 else -3     # the (c0, c1) axis
    acc = torch.stack(rows[:2], dim=stack)
    cts = torch.stack(rows[2:], dim=stack)
    w = torch.from_numpy(encoding.encode_weights_mont(
        [0.2, 0.3, 0.5], ctx).view(np.int32).copy()).to(cuda)[
            torch.arange(k, device=cuda) % 3].contiguous()
    want = ref.he_weighted_accum_chunks_fused(acc, cts, w, t.qs, t.qinv_negs,
                                              limb_axis)
    ops.reset_launch_counts()
    got = he_agg.he_weighted_accum_chunks_fused(acc, cts, w, t.qs,
                                                t.qinv_negs, limb_axis)
    inplace = acc.clone()
    he_agg.he_weighted_accum_chunks_fused(inplace, cts, w, t.qs, t.qinv_negs,
                                          limb_axis, out=inplace)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(inplace, want)
    assert ops.launch_counts()["weighted_accum_chunks"] == 2


@pytest.mark.parametrize("b", [1, 7, 300])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_weighted_accum_matches_plain_version(cuda, b, l):
    """Both limb axes; acc of ct's shape, one row broadcast over the batch
    (with and without its leading 1) and folded in place (out=acc)."""
    ctx = params.make_test_context(n_poly=1024, n_limbs=l,
                                   delta_bits=12 if l == 1 else 20,
                                   device=cuda)
    t = ctx.device_tables
    rng = np.random.RandomState(10 * b + l)
    rows = [_residues(rng, ctx, b, cuda) for _ in range(4)]    # [B, L, N]
    w = torch.from_numpy(encoding.encode_scalar_residues(
        0.375, ctx).view(np.int32).copy()).to(cuda)
    for limb_axis, stack in ((-3, -2), (-2, -3)):
        acc = torch.stack(rows[:2], dim=stack)
        ct = torch.stack(rows[2:], dim=stack)
        ops.reset_launch_counts()
        for a in (acc, acc[:1], acc[0]):
            got = he_agg.he_weighted_accum_fused(a, ct, w, t.qs, t.qinv_negs,
                                                 limb_axis)
            want = ref.he_weighted_accum_fused(a, ct, w, t.qs, t.qinv_negs,
                                               limb_axis)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        want = ref.he_weighted_accum_fused(acc, ct, w, t.qs, t.qinv_negs,
                                           limb_axis)
        assert he_agg.he_weighted_accum_fused(acc, ct, w, t.qs, t.qinv_negs,
                                              limb_axis, out=acc) is acc
        torch.cuda.synchronize()
        assert torch.equal(acc, want)
        assert ops.launch_counts()["weighted_accum"] == 4


@pytest.mark.parametrize("k", [1, 7, 300])
@pytest.mark.parametrize("l", [2, 3])
def test_mod_lift_matches_plain_version(cuda, k, l):
    """Full-range words, every edge of the u32 range among them, on rows of
    N=8192 (the main path's) and N=4 (one vector a row)."""
    ctx = params.make_test_context(n_poly=1024, n_limbs=l, delta_bits=20,
                                   device=cuda)
    qs = ctx.device_tables.qs
    rng = np.random.RandomState(k + l)
    for n in (8192, 4):
        x = rng.randint(0, 1 << 32, size=(k, n), dtype=np.uint64).astype(
            np.uint32)
        x.reshape(-1)[:4] = [0, 1 << 31, (1 << 32) - 2, (1 << 32) - 1]
        xt = torch.from_numpy(x.view(np.int32)).to(cuda)
        ops.reset_launch_counts()
        got = lift.mod_lift_fused(xt, qs)
        want = ref.mod_lift_fused(xt, qs)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert ops.launch_counts()["mod_lift"] == 1


def test_transcipher_round_on_the_card_matches_the_cpu(cuda):
    """provision, mask, pack, StreamIngest of two masked blobs (one a
    spanned provisioned range) and finalize: the same bits and bytes on the
    card as on the CPU."""
    rng = np.random.RandomState(8)
    n, b = 1024, 3
    s_mont = rng.randint(0, 1 << 20, (2, n))
    e = np.rint(3.2 * rng.randn(2, b, n))
    escrow_e = np.rint(3.2 * rng.randn(1, n))
    vals = rng.randn(2, b, n // 2).astype(np.float32)
    plain = rng.randn(300).astype(np.float32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        ctx = params.make_test_context(n_poly=n, n_limbs=2, delta_bits=20,
                                       device=dev)
        sk = {"s_mont": torch.from_numpy(s_mont.astype(np.int32)).to(dev)}
        ing = stream.StreamIngest(ctx)
        res, blobs = [], []
        for c, derive in enumerate((compress.DERIVE_CTR,
                                    compress.DERIVE_FOLD_CHUNK)):
            cm, sm = transcipher.provision_from_samples(
                ctx, sk, torch.from_numpy(e[c]).to(dev),
                torch.from_numpy(escrow_e).to(dev), 2 ** 64 - 5 + c,
                300 + c, chunk_offset=2 * c, derive=derive)
            ing.add_transcipher_materials(c, 0, sm)
            masked = transcipher.mask_values(ctx, cm, vals[c])
            blobs.append(stream.pack_masked_update_frames(
                compress.MaskedChunk(masked=masked, a_seed=cm.a_seed,
                                     scale=cm.scale,
                                     chunk_offset=cm.chunk_offset,
                                     derive=cm.derive),
                compress.seed_compress(cm.seed_ct, cm.escrow_a_seed,
                                       cm.derive),
                torch.from_numpy(plain).to(dev), cid=c, n_samples=1))
            ing.ingest(blobs[-1], 0.5)
            res += [sm.d, cm.seed_ct.data]
        glob = ing.finalize()
        res += [glob.ct.data, glob.plain.view(torch.int32)]
        out.append(([r.cpu() for r in res], blobs))
    (got, got_blobs), (want, want_blobs) = out
    assert got_blobs == want_blobs
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_round_on_the_card_matches_the_cpu(cuda):
    """Keygen, encrypt, weighted_sum and decrypt with the same draws on the
    card (kernels) and on the CPU (plain versions): the same bits."""
    rng = np.random.RandomState(2)
    n, b = 1024, 3
    draws = {"s": rng.randint(-1, 2, n), "e": np.rint(3.2 * rng.randn(n)),
             "u": rng.randint(-1, 2, (b, n)),
             "e0": np.rint(3.2 * rng.randn(b, n)),
             "e1": np.rint(3.2 * rng.randn(b, n))}
    out = []
    for dev in (cuda, torch.device("cpu")):
        ctx = params.make_test_context(n_poly=n, n_limbs=2, device=dev)
        a = np.stack([np.random.RandomState(3).randint(0, q, n)
                      for q in ctx.primes])
        d = {k: torch.from_numpy(v.astype(np.int32)).to(dev)
             for k, v in draws.items()}
        sk, pk = cipher.keygen_from_samples(
            ctx, d["s"], torch.from_numpy(a.astype(np.int32)).to(dev), d["e"])
        vals = np.random.RandomState(4).randn(b, ctx.slots).astype(np.float32)
        m = torch.from_numpy(encoding.encode_np(vals, ctx).view(np.int32))
        ct = cipher.encrypt_coeffs_from_samples(ctx, pk, m.to(dev), d["u"],
                                                d["e0"], d["e1"])
        agg = cipher.weighted_sum(ctx, cipher.Ciphertext(
            torch.stack([ct.data, ct.data]), ct.scale), [0.5, 0.5])
        out.append([sk["s_mont"].cpu(), ct.data.cpu(), agg.data.cpu(),
                    cipher.decrypt_to_coeffs(ctx, sk, agg).cpu()])
    for got, want in zip(*out):
        assert torch.equal(got, want)


@pytest.mark.parametrize("partitionable", [True, False])
def test_wire_round_on_the_card_matches_the_cpu(cuda, partitionable):
    """`a` expansion, seeded encrypt, packing and StreamIngest (with a
    rejected update and a checkpoint) give the same bits and bytes on the
    card as on the CPU, in both threefry layouts."""
    rng = np.random.RandomState(7)
    n, b = 1024, 3
    s_mont = rng.randint(0, 1 << 20, (2, n))
    e = np.rint(3.2 * rng.randn(b, n))
    vals = rng.randn(b, n // 2).astype(np.float32)
    plain = rng.randn(500).astype(np.float32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        ctx = params.make_test_context(
            n_poly=n, n_limbs=2, device=dev,
            threefry_partitionable=partitionable)
        sk = {"s_mont": torch.from_numpy(s_mont.astype(np.int32)).to(dev)}
        m = torch.from_numpy(encoding.encode_np(vals, ctx).view(np.int32))
        ing = stream.StreamIngest(ctx)
        res, blobs = [], []
        for derive, codec in ((compress.DERIVE_FOLD_CHUNK, "f32"),
                              (compress.DERIVE_CTR, "i8")):
            res.append(cipher.expand_a_rows(ctx, 2 ** 40 + 3, 2 ** 31 - 2,
                                            3, derive))
            ct = cipher.encrypt_coeffs_seeded_from_samples(
                ctx, sk, m.to(dev), torch.from_numpy(e).to(dev), 9 + derive,
                derive=derive)
            blobs.append(stream.pack_update_frames(
                ProtectedUpdate(ct=ct, plain=torch.from_numpy(plain).to(dev)),
                cid=derive, n_samples=1,
                seeded=compress.seed_compress(ct, 9 + derive, derive),
                plain_codec=codec))
            ing.ingest(blobs[-1], 0.5)
        with pytest.raises(stream.wf.WireError):
            ing.ingest(blobs[0][:-10], 0.5)
        arrays, meta = ing.export_state()
        resumed = stream.StreamIngest(ctx)
        resumed.restore_state(arrays, meta)
        resumed.ingest(blobs[1], 0.25)
        glob = resumed.finalize()
        res += [glob.ct.data, glob.plain.view(torch.int32)]
        out.append(([r.cpu() for r in res], blobs))
    (got, got_blobs), (want, want_blobs) = out
    assert got_blobs == want_blobs
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _sharded_round(ctx, mesh, draws, a, vals, plain):
    """Every op of the sharded engine on one mesh with injected draws;
    returns the outputs assembled on the CPU, the engine and its grids."""
    dev = ctx.device
    d = {k: torch.from_numpy(v.astype(np.int32)).to(dev)
         for k, v in draws.items()}
    eng = sharded.ShardedHe(ctx, mesh)
    sk, pk = eng.keygen_from_samples(d["s"], torch.from_numpy(a).to(dev),
                                     d["e"])
    m = torch.from_numpy(encoding.encode_np(vals, ctx).view(np.int32)).to(dev)
    ct = eng.encrypt_coeffs_from_samples(pk, m, d["u"], d["e0"], d["e1"])
    sct = eng.encrypt_coeffs_seeded_from_samples(sk, m, d["e0"], 21,
                                                 derive=compress.DERIVE_CTR)
    agg = eng.weighted_sum(cipher.Ciphertext(
        sharded.stack([ct.data, sct.data]), ct.scale), [0.25, 0.75])
    acc = eng.weighted_accum(cipher.Ciphertext(
        torch.zeros(ct.data.shape[1:], dtype=torch.int32, device=dev),
        ct.scale), ct, 0.25)
    acc = eng.weighted_accum(acc, sct, 0.75)
    spec = fl_step.HeAggSpec(2, vals.shape[0], plain.shape[0], ctx)
    step_ct, step_pt = fl_step.make_he_agg_step(spec, [0.25, 0.75], mesh)(
        torch.stack([ct.data.assemble(dev), sct.data.assemble(dev)]),
        torch.from_numpy(np.stack([plain, -plain])).to(dev))
    ing = stream.StreamIngest(ctx, sharded=eng)
    for i, c in enumerate((ct, sct)):
        ing.ingest(stream.pack_update_frames(
            ProtectedUpdate(ct=cipher.Ciphertext(c.data.assemble(dev),
                                                 c.scale),
                            plain=torch.from_numpy(plain).to(dev)),
            cid=i, n_samples=1), 0.25 + 0.5 * i)
    grids = [sk["s_mont"], pk["pk0_mont"], ct.data, sct.data, agg.data,
             acc.data, step_ct, step_pt]
    out = [g.assemble("cpu") for g in grids]
    out += [eng.decrypt_to_coeffs(sk, agg).cpu(),
            ing.finalize().ct.data.cpu()]
    return out, eng, grids


def test_sharded_round_on_the_card_matches_the_cpu(cuda):
    """The sharded engine on a (data 2, model 2) mesh that repeats the card,
    against the same mesh of the CPU: the same bits from every op, every
    block on its slot's device, one launch per block per op and two
    gathers (decrypt and the ingest's hand-off)."""
    rng = np.random.RandomState(9)
    n, b = 1024, 5
    draws = {"s": rng.randint(-1, 2, n), "e": np.rint(3.2 * rng.randn(n)),
             "u": rng.randint(-1, 2, (b, n)),
             "e0": np.rint(3.2 * rng.randn(b, n)),
             "e1": np.rint(3.2 * rng.randn(b, n))}
    vals = rng.randn(b, n // 2).astype(np.float32)
    plain = rng.randn(301).astype(np.float32)
    a = np.stack([rng.randint(0, q, n) for q in params.find_ntt_primes(
        n, 2)]).astype(np.int32)
    out, counts = [], []
    for dev in (cuda, torch.device("cpu")):
        ctx = params.make_test_context(n_poly=n, n_limbs=2, device=dev)
        mesh = tmesh.make_he_mesh(2, devices=[dev] * 4)
        assert mesh.shape == {"data": 2, "model": 2}
        ops.reset_launch_counts()
        res, eng, grids = _sharded_round(ctx, mesh, draws, a, vals, plain)
        counts.append(ops.launch_counts())
        assert all(g.on_slot_devices() for g in grids)
        assert eng.gathers == 2
        out.append(res)
    for got, want in zip(*out):
        assert torch.equal(got, want)
    assert counts[0] == {"ntt_fwd": 4 * 2 + 4 * 4 + 4 * 2, "ntt_inv": 4,
                      "ntt4_fwd": 0, "ntt4_inv": 0,
                      "mul_add": 4 * 2 + 4 + 4, "weighted_sum": 8,
                      "weighted_accum": 8, "weighted_accum_chunks": 8,
                      "mod_lift": 0, "mask_split": 0, "mask_merge": 0,
                      "ssd_fwd": 0, "ssd_bwd": 0}


def _threshold_round(ctx, draws, vals):
    """Additive keygen, an encryption under the joint pk, the partials and
    the combine, and a Shamir 2-of-3 decrypt, from fixed draws."""
    d = {k: torch.from_numpy(v.astype(np.int32)).to(ctx.device)
         for k, v in draws.items()}
    parties, pk = threshold.threshold_keygen_from_samples(ctx, d["a"],
                                                          d["s"], d["e"])
    m = torch.from_numpy(encoding.encode_np(vals, ctx).view(np.int32).copy()
                         ).to(ctx.device)
    ct = cipher.encrypt_coeffs_from_samples(ctx, pk, m, d["u"], d["e0"],
                                            d["e1"])
    partials = [threshold.partial_decrypt_from_samples(ctx, p, ct,
                                                       d["smudge"][i])
                for i, p in enumerate(parties)]
    s = parties[0].s_mont
    for p in parties[1:]:
        s = ops.mod_add(s, p.s_mont, ctx)
    shares = threshold.shamir_share_secret_from_samples(
        ctx, {"s_mont": s}, list(d["coeffs"]), 3, 2)
    shamir = [threshold.shamir_partial_decrypt_from_samples(
        ctx, shares[i], [2, 0], ct, d["smudge"][i]) for i in (2, 0)]
    out = {"pk0": pk["pk0_mont"], "pk1": pk["pk1_mont"], "ct": ct.data,
           "combined": threshold.combine_partials(ctx, ct, partials),
           "shamir": threshold.combine_partials(ctx, ct, shamir)}
    out.update({f"share {i}": p.s_mont for i, p in enumerate(parties)})
    return {k: v.cpu() for k, v in out.items()}, ct.scale


def test_threshold_round_on_the_card_matches_the_cpu(cuda):
    """The threshold bodies through the kernels equal the plain versions'
    bits, and both decrypt."""
    rng = np.random.RandomState(8)
    n, b = 1024, 3
    # delta 2**26: the smudging (sigma 2**12, three parties) is 2e-3 a slot
    gpu = params.make_test_context(n_poly=n, delta_bits=26, device=cuda)
    cpu = params.make_test_context(n_poly=n, delta_bits=26, device="cpu")
    draws = {"a": np.stack([rng.randint(0, q, n) for q in gpu.primes]),
             "s": rng.randint(-1, 2, (3, n)),
             "e": np.rint(3.2 * rng.randn(3, n)),
             "u": rng.randint(-1, 2, (b, n)),
             "e0": np.rint(3.2 * rng.randn(b, n)),
             "e1": np.rint(3.2 * rng.randn(b, n)),
             "smudge": np.rint(4096 * rng.randn(3, b, n)),
             "coeffs": np.stack([rng.randint(0, q, (1, n))
                                 for q in gpu.primes], axis=1)}
    vals = rng.randn(b, gpu.slots).astype(np.float32)
    ops.reset_launch_counts()
    card, scale = _threshold_round(gpu, draws, vals)
    counts = ops.launch_counts()
    assert counts["ntt_fwd"] == 3 * 2 + 4 + 3 + 2
    assert counts["mul_add"] == 2 + 3 + 2 and counts["ntt_inv"] == 2
    host, _ = _threshold_round(cpu, draws, vals)
    for k, v in host.items():
        assert torch.equal(card[k], v), k
    for k in ("combined", "shamir"):
        out = encoding.decode_np(card[k].numpy().view(np.uint32), cpu, scale)
        assert np.abs(out - vals).max() < 0.05


def test_obs_hooks_count_the_card_launches(cuda):
    """With obs enabled every kernel op on the card is one
    kernel_op_launches_total{backend="cuda"} and one he.<op> span, and its
    output is the disabled call's."""
    ctx = params.make_test_context(n_poly=1024, device=cuda)
    rng = np.random.RandomState(3)
    x, z = _residues(rng, ctx, 4, cuda), _residues(rng, ctx, 4, cuda)
    want = ops.mul_add(x, ops.ntt_fwd(z, ctx), z, ctx)
    obs.REGISTRY.reset()
    obs.configure(enabled=True, trace_path=None, reset=True)
    try:
        ops.reset_launch_counts()
        got = ops.mul_add(x, ops.ntt_fwd(z, ctx), z, ctx)
        counts = ops.launch_counts()
        events = [e for e in obs.get_tracer().events
                  if e.get("cat") == "kernel"]
    finally:
        obs.configure(enabled=False, trace_path=None, reset=True)
    assert torch.equal(got, want)
    assert counts["ntt_fwd"] == counts["mul_add"] == 1
    for op in ("ntt_fwd", "mul_add"):
        c = obs.REGISTRY.get("kernel_op_launches_total", op=op,
                             backend="cuda")
        assert c is not None and c.value == counts[op]
    assert [(e["name"], e["args"]["backend"]) for e in events] == [
        ("he.ntt_fwd", "cuda"), ("he.mul_add", "cuda")]


def test_wrappers_raise_on_what_they_do_not_take(cuda):
    ctx = params.make_test_context(n_poly=256, n_limbs=2, device=cuda)
    t = ctx.device_tables
    x = _residues(np.random.RandomState(5), ctx, 2, cuda)
    with pytest.raises(TypeError, match="int32"):
        ntt.ntt_fwd_fused(x.to(torch.int64), t.psi_rev_mont, t.qs,
                          t.qinv_negs)
    with pytest.raises(ValueError, match="contiguous"):
        ntt.ntt_fwd_fused(x.transpose(0, 1), t.psi_rev_mont, t.qs,
                          t.qinv_negs)
    with pytest.raises(ValueError, match="does not match"):
        ntt.ntt_fwd_fused(x[..., :128].contiguous(), t.psi_rev_mont, t.qs,
                          t.qinv_negs)
    ntt4 = (t.ntt4_psi1_mont, t.ntt4_psi2_mont, t.ntt4_corr_mont, t.qs,
            t.qinv_negs)
    with pytest.raises(ValueError, match="does not give N"):
        ntt.ntt4_fwd_fused(x, t.ntt4_psi1_mont[:, :8], *ntt4[1:])
    with pytest.raises(ValueError, match="radix"):
        ntt.ntt4_fwd_fused(x, *ntt4, radix=8)
    with pytest.raises(ValueError, match="block_b"):
        ntt.ntt4_fwd_fused(x, *ntt4, block_b=9)
    # N beyond the kernels' 2**14 (their padded shared row) is refused
    # before any launch; block_b no longer sizes shared memory

    def zeros(*shape):
        return torch.zeros(*shape, dtype=torch.int32, device=cuda)

    with pytest.raises(ValueError, match="limit"):
        ntt.ntt4_fwd_fused(zeros(1, 2, 32768), zeros(2, 128), zeros(2, 256),
                           zeros(2, 32768), zeros(2), zeros(2))
    with pytest.raises(ValueError, match="on cpu"):
        pointwise.mul_add_fused(x, x, x, t.qs.cpu(), t.qinv_negs)
    with pytest.raises(ValueError, match="aligned"):
        lift.mod_lift_fused(x.view(-1)[1:257], t.qs)
    with pytest.raises(ValueError, match="N must be a power of two"):
        lift.mod_lift_fused(x[..., :100].contiguous(), t.qs)
    with pytest.raises(ValueError, match="w_mont"):
        he_agg.he_weighted_sum_fused(torch.stack([x, x]), t.qs[None],
                                     t.qs, t.qinv_negs)
    with pytest.raises(ValueError, match="trailing broadcast"):
        he_agg.he_weighted_accum_fused(x[:, :1].contiguous(), x, t.qs, t.qs,
                                       t.qinv_negs)
    with pytest.raises(ValueError, match="contiguous"):
        he_agg.he_weighted_accum_fused(x[0].expand(x.shape), x, t.qs, t.qs,
                                       t.qinv_negs)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m",
                                  "mamba2-370m", "zamba2-7b"])
def test_smoke_model_on_the_card_matches_the_cpu(cuda, arch):
    """The same parameters and batch on the card and on the CPU (float32,
    TF32 off, remat on): loss to rtol 1e-5 and every gradient leaf to rtol
    1e-4 / atol 1e-6, the tolerances the CPU port holds against JAX.  The
    card's GEMMs reduce in another order, and the MoE combine's index_add
    sums each token's top_k rows in an unspecified order."""
    import dataclasses

    from repro_torch import configs, models
    from repro_torch.core import packing

    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              remat=True)
    cpu_model = models.build_model(cfg, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab, (2, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    card_model = models.build_model(cfg)
    move = lambda t: t.to(cuda)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want_loss, want = models.value_and_grad(cpu_model.loss_fn)(params,
                                                                   batch)
        loss, got = models.value_and_grad(card_model.loss_fn)(
            packing.tree_map(move, params), packing.tree_map(move, batch))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert card_model.device.type == "cuda"
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for g, w in zip(packing.tree_leaves(got), packing.tree_leaves(want)):
        assert g.device.type == "cuda"
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("wire", [False, True])
def test_fl_task_on_the_card_recovers_the_fedavg(cuda, wire):
    """FLTask.run() on the card (tests/test_fl.py's one-layer model, N=256
    context, the HE mask, two rounds): each round's recovered model within
    the quickstart's 1e-2 of the plaintext FedAvg of its local models, and
    the round's kernels launched on the card."""
    import dataclasses

    from repro_torch import configs, models
    from repro_torch.core import packing
    from repro_torch.core.secure_agg import AggregatorConfig
    from repro_torch.data import make_client_streams
    from repro_torch.fl import (ClientConfig, FLClient, FLRunConfig, FLTask,
                                WirePolicy)

    cfg = dataclasses.replace(configs.get_config("qwen1.5-0.5b", smoke=True),
                              n_layers=1, d_model=32, n_heads=2,
                              n_kv_heads=2, d_ff=64, vocab=61)
    model = models.build_model(cfg)
    streams = make_client_streams(3, cfg.vocab, seq_len=8, batch_size=2)
    clients = [FLClient(i, model, streams[i],
                        ClientConfig(local_steps=1, sensitivity_probes=1))
               for i in range(3)]
    task = FLTask(model, clients, AggregatorConfig(p_ratio=0.2),
                  FLRunConfig(n_rounds=2, wire_policy=WirePolicy() if wire
                              else None),
                  ctx=params.make_test_context(n_poly=256))
    sent = []
    for c in clients:
        def train(glob, real=c.local_train, c=c):
            local, loss = real(glob)
            sent.append((c.n_samples, packing.flatten_params(local)[0]))
            return local, loss
        c.local_train = train
    real_recover, errs = task._recover, []

    def recover(agg):
        glob = real_recover(agg)
        n = sum(k for k, _ in sent)
        fedavg = sum(k / n * v for k, v in sent)
        errs.append(float((packing.flatten_params(glob)[0] - fedavg)
                          .abs().max()))
        sent.clear()
        return glob
    task._recover = recover
    ops.reset_launch_counts()
    logs = task.run()
    assert [l.n_participating for l in logs] == [3, 3]
    assert len(errs) == 2 and max(errs) < 1e-2
    counts = ops.launch_counts()
    assert counts["ntt_fwd"] > 0 and counts["ntt_inv"] == 3
    assert counts["weighted_accum_chunks" if wire else "weighted_sum"] > 0
