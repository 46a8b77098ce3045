"""The port's sharded HE engine against its single-device path and against
the JAX package's `ShardedHe`.

Meshes repeat the CPU device: (data, model) in (1, 1), (2, 1), (1, 2),
(2, 2) and (4, 1), over L in {1, 2, 3} wherever the model size divides L,
with batches of 5 rows, which divide none of the data sizes above 1.  Every
op of the port's engine must equal the port's single-device path bit for
bit.  The deterministic ops, keygen and the public-key encrypt from injected
numpy draws, and the seeded encrypt from injected noise (both derive ids,
both threefry layouts) must equal the JAX engine's on the 4 host devices
that tests/conftest.py forces; the JAX engine's samplers are swapped for
table lookups of the same draws in a scoped monkeypatch, with JAX's compile
caches cleared on both sides of it.  JAX-packed seeded and masked blobs go
through the port's sharded StreamIngest, its unsharded one and the JAX
package's sharded one with the same bits.  N = 256 and the JAX `ref`
backend throughout.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core.ckks import cipher as jcipher
from repro.core.ckks import params as jparams
from repro.core.ckks import sharded as jsharded
from repro.core.ckks import transcipher as jtc
from repro.core.secure_agg import ProtectedUpdate as JUpdate
from repro.kernels import ref as jref
from repro.launch import fl_step as jfl_step
from repro.launch import mesh as jmesh
from repro.wire import compress as jcomp
from repro.wire import stream as jstream

from repro_torch import interop
from repro_torch.core.ckks import cipher, encoding, params, sharded
from repro_torch.core.secure_agg import (AggregatorConfig, ProtectedUpdate,
                                         SelectiveHEAggregator)
from repro_torch.kernels import ops
from repro_torch.launch import fl_step, mesh
from repro_torch.wire import compress, stream
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, B = 256, 5
CPU = torch.device("cpu")
DELTA_BITS = {1: 12, 2: 20, 3: 20}
SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1)]
CASES = [(s, l) for s in SHAPES for l in (1, 2, 3) if l % s[1] == 0]
JAX_CASES = [((2, 2), 2), ((4, 1), 3)]


@functools.lru_cache(maxsize=None)
def _ctx(l, partitionable=True):
    return params.make_test_context(n_poly=N, n_limbs=l,
                                    delta_bits=DELTA_BITS[l], device="cpu",
                                    threefry_partitionable=partitionable)


@functools.lru_cache(maxsize=None)
def _jctx(l):
    return jparams.make_test_context(n_poly=N, n_limbs=l,
                                     delta_bits=DELTA_BITS[l])


@pytest.fixture(scope="module")
def meshes():
    """(data, model) -> a port mesh repeating the CPU and the JAX mesh of
    as many host devices."""
    devs = jax.devices()
    return {s: (mesh.HeMesh(tuple((CPU,) * s[1] for _ in range(s[0]))),
                Mesh(np.asarray(devs[:s[0] * s[1]]).reshape(s),
                     ("data", "model")))
            for s in SHAPES}


def _t(a):
    return interop.residues_from_np(np.asarray(a), "cpu")


def _np(x):
    if isinstance(x, sharded.BlockGrid):
        x = x.assemble(CPU)
    return interop.residues_to_np(x)


def _residues(rng, ctx, shape):
    """uint32 residues [*shape, L, N] of ctx's primes."""
    return np.stack([rng.randint(0, q, shape + (N,)) for q in ctx.primes],
                    axis=-2).astype(np.uint32)


def _cts(rng, ctx, lead):
    """Ciphertext-layout residues uint32[*lead, L, 2, N]."""
    return np.moveaxis(_residues(rng, ctx, lead + (2,)), -2, -3).copy()


def _draws(rng, b=B):
    return {"u": rng.randint(-1, 2, (b, N)),
            "e0": np.rint(3.2 * rng.randn(b, N)),
            "e1": np.rint(3.2 * rng.randn(b, N))}


def _i32(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


# ---------------------------------------------------------------------------
# mesh factorization and the limb check
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("l", [1, 2, 3, 4])
def test_make_he_mesh_picks_jax_factorization(l, k):
    """The largest model size dividing both L and the slot count, as JAX's
    make_he_mesh; slots fill the grid row by row and may repeat a device."""
    got = mesh.make_he_mesh(l, devices=[CPU] * k)
    want = jmesh.make_he_mesh(l, k)
    assert (got.n_data, got.n_model) == tuple(want.devices.shape)
    assert got.shape == dict(want.shape)
    assert got.size == k and got.device(got.n_data - 1, 0) == CPU
    assert mesh.make_he_mesh(l, 1, devices=[CPU] * k).size == 1


def test_mesh_errors_and_host_mesh():
    with pytest.raises(RuntimeError, match="asked for 3 devices"):
        mesh.make_he_mesh(2, 3, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="rectangular"):
        mesh.HeMesh(((CPU, CPU), (CPU,)))
    host = mesh.make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1}
    flat = mesh.make_he_mesh(2, devices=[CPU] * 4).flattened()
    assert flat.shape == {"data": 4, "model": 1}


def test_check_limbs_raises_where_jax_does(meshes):
    """A limb count the model axis does not divide: keygen at L=3 and a
    weighted_sum of limb-dropped L=1 ciphertexts on model 2 raise
    ValueError in both packages."""
    tm, jm = meshes[(1, 2)]
    teng = sharded.ShardedHe(_ctx(3), tm)
    jeng = jsharded.ShardedHe(_jctx(3), jm)
    with pytest.raises(ValueError, match="not divisible"):
        teng.keygen(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not divisible"):
        jeng.keygen(jax.random.PRNGKey(0))
    data = _cts(np.random.RandomState(0), _ctx(1), (2, 3))
    teng = sharded.ShardedHe(_ctx(2), tm)
    jeng = jsharded.ShardedHe(_jctx(2), jm)
    with pytest.raises(ValueError, match="not divisible"):
        teng.weighted_sum(cipher.Ciphertext(_t(data), 1.0), [0.5, 0.5])
    with pytest.raises(ValueError, match="not divisible"):
        jeng.weighted_sum(jcipher.Ciphertext(jnp.asarray(data), 1.0),
                          [0.5, 0.5])


# ---------------------------------------------------------------------------
# the port's engine == the port's single-device path, every mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,l", CASES)
def test_keygen_and_encrypt_match_single_device(meshes, shape, l):
    """Keys, public-key encrypt and seeded encrypt (both derive ids) from
    the same generator states: the same bits and the same draws consumed;
    every block on its slot's device."""
    ctx, eng = _ctx(l), sharded.ShardedHe(_ctx(l), meshes[shape][0])
    g1, g2 = torch.Generator().manual_seed(l), torch.Generator().manual_seed(l)
    sk, pk = cipher.keygen(ctx, g1)
    ssk, spk = eng.keygen(g2)
    for k in ("pk0_mont", "pk1_mont"):
        assert spk[k].equals(pk[k]) and spk[k].on_slot_devices()
    assert ssk["s_mont"].equals(sk["s_mont"])
    vals = torch.randn(B, ctx.slots,
                       generator=torch.Generator().manual_seed(3))
    ct = cipher.encrypt_values(ctx, pk, vals, g1)
    sct = eng.encrypt_values(spk, vals, g2)
    assert sct.data.equals(ct.data) and sct.data.on_slot_devices()
    assert sct.scale == ct.scale
    for derive in cipher.DERIVES:
        want = cipher.encrypt_values_seeded(ctx, sk, vals, g1, 40 + derive,
                                            derive=derive)
        got = eng.encrypt_values_seeded(ssk, vals, g2, 40 + derive,
                                        derive=derive)
        assert got.data.equals(want.data) and got.data.on_slot_devices()
    assert torch.equal(torch.randint(0, 1 << 30, (4,), generator=g1),
                       torch.randint(0, 1 << 30, (4,), generator=g2))
    assert eng.gathers == 0


@pytest.mark.parametrize("shape,l", CASES)
def test_aggregation_ops_match_single_device(meshes, shape, l):
    """weighted_sum (tensor and BlockGrid inputs), weighted_accum (full,
    broadcast and one-row accumulators), weighted_accum_chunks in both
    layouts (in place) and decrypt: the single-device bits; decrypt is the
    one gather."""
    ctx, eng = _ctx(l), sharded.ShardedHe(_ctx(l), meshes[shape][0])
    rng = np.random.RandomState(10 * l + shape[0])
    data = _t(_cts(rng, ctx, (3, B)))
    w = [0.2, 0.3, 0.5]
    cts = cipher.Ciphertext(data, ctx.delta)
    want = cipher.weighted_sum(ctx, cts, w)
    got = eng.weighted_sum(cts, w)
    assert got.data.equals(want.data) and got.scale == want.scale
    grids = [eng.put_ciphertext(cipher.Ciphertext(data[i])).data
             for i in range(3)]
    assert eng.weighted_sum(cipher.Ciphertext(sharded.stack(grids),
                                              ctx.delta), w).data.equals(
        want.data)
    w1 = _i32(encoding.encode_scalar_residues(0.3, ctx).view(np.int32))
    for acc in (data[0], data[0, :1], data[0, 0]):
        out = eng.weighted_accum(cipher.Ciphertext(acc, ctx.delta),
                                 cipher.Ciphertext(data[1]), 0.3)
        assert out.data.equals(ops.weighted_accum(acc, data[1], w1, ctx,
                                                  limb_axis=-3))
        assert out.data.on_slot_devices()
    fold = cipher.Ciphertext(torch.zeros(data.shape[2:], dtype=torch.int32),
                             ctx.delta)
    for i in range(3):
        fold = eng.weighted_accum(fold, cipher.Ciphertext(data[i]), w[i])
    assert fold.data.equals(want.data)
    wk = _t(np.stack([rng.randint(0, q, B) for q in ctx.primes], axis=1))
    for limb_axis, x in ((-3, data[1]), (-2, data[1].movedim(-3, -2))):
        x = x.contiguous()
        acc = eng.place(data[2] if limb_axis == -3
                        else data[2].movedim(-3, -2).contiguous(),
                        0, limb_axis)
        ref = ops.weighted_accum_chunks(acc.assemble(CPU), x, wk, ctx,
                                        limb_axis=limb_axis)
        out = eng.weighted_accum_chunks(acc, x, wk, limb_axis=limb_axis,
                                        out=acc)
        assert out is acc and acc.equals(ref)
    assert eng.gathers == 0
    sk, _ = cipher.keygen(ctx, torch.Generator().manual_seed(1))
    assert torch.equal(eng.decrypt_to_coeffs(sk, got),
                       cipher.decrypt_to_coeffs(ctx, sk, want))
    assert eng.gathers == 1


@pytest.mark.parametrize("shape,l", CASES)
def test_selective_round_matches_single_device(meshes, shape, l):
    """client_protect and client_protect_seeded (sharded=), server_aggregate
    of BlockGrid updates (sharded=) and client_recover (sharded=): the
    single-device ciphertexts and the same recovered vector; the recover's
    decrypt is the only gather."""
    ctx, eng = _ctx(l), sharded.ShardedHe(_ctx(l), meshes[shape][0])
    rng = np.random.RandomState(l)
    params_ = {"w": torch.from_numpy(rng.randn(700).astype(np.float32))}
    agg = SelectiveHEAggregator.build(
        ctx, params_, torch.from_numpy(np.abs(rng.randn(700))),
        AggregatorConfig(p_ratio=0.9, dp_b=0.01))
    sk, pk = cipher.keygen(ctx, torch.Generator().manual_seed(2))
    ups, sups = [], []
    for i in range(3):
        p = {"w": params_["w"] + 0.1 * i}
        g1 = torch.Generator().manual_seed(20 + i)
        g2 = torch.Generator().manual_seed(20 + i)
        if i == 2:
            ups.append(agg.client_protect_seeded(p, sk, g1, 60 + i))
            sups.append(agg.client_protect_seeded(p, sk, g2, 60 + i,
                                                  sharded=eng))
        else:
            ups.append(agg.client_protect(p, pk, g1))
            sups.append(agg.client_protect(p, pk, g2, sharded=eng))
        assert sups[-1].ct.data.equals(ups[-1].ct.data)
        assert torch.equal(sups[-1].plain, ups[-1].plain)
    want = agg.server_aggregate(ups, [0.2, 0.3, 0.5])
    got = agg.server_aggregate(sups, [0.2, 0.3, 0.5], sharded=eng)
    assert got.ct.data.equals(want.ct.data)
    assert torch.equal(got.plain, want.plain)
    assert eng.gathers == 0
    assert torch.equal(agg.client_recover(got, sk, sharded=eng),
                       agg.client_recover(want, sk))
    assert eng.gathers == 1


@pytest.mark.parametrize("shape,l", CASES)
def test_sharded_ingest_matches_unsharded(meshes, shape, l):
    """Seeded (both derives) and full-ciphertext blobs (its chunks out of
    order) of chunk counts the data slots do not divide and a longer
    in-memory update, with a rejected update and a checkpoint restored
    into a fresh sharded ingest: the unsharded ingest's aggregate and
    state; finalize is the only gather."""
    ctx, eng = _ctx(l), sharded.ShardedHe(_ctx(l), meshes[shape][0])
    rng = np.random.RandomState(100 + l)
    sk = {"s_mont": _t(_residues(rng, ctx, ()))}
    blobs = []
    for i, derive in enumerate((1, 2, 0)):
        vals = torch.from_numpy(rng.randn(B, ctx.slots).astype(np.float32))
        plain = torch.from_numpy(rng.randn(33).astype(np.float32))
        if derive:
            ct = cipher.encrypt_values_seeded(
                ctx, sk, vals, torch.Generator().manual_seed(i), 70 + i,
                derive=derive)
            seeded = compress.seed_compress(ct, 70 + i, derive)
        else:
            ct = cipher.Ciphertext(_t(_cts(rng, ctx, (B,))), ctx.delta)
            seeded = None
        blobs.append(stream.pack_update_frames(
            ProtectedUpdate(ct, plain), cid=i, n_samples=1, seeded=seeded))
    frames, off = [], 0
    while off < len(blobs[2]):
        end = stream.wf.parse_frame(blobs[2], off)[3]
        frames.append(blobs[2][off:end])
        off = end
    # chunks out of order: every data slot gathers and scatters its rows
    blobs[2] = b"".join([frames[0]] + [frames[1 + c] for c in (4, 0, 3, 1, 2)]
                        + frames[6:])
    ref, ing = stream.StreamIngest(ctx), stream.StreamIngest(ctx,
                                                             sharded=eng)
    for s in (ref, ing):
        s.ingest(blobs[0], 0.2)
    before = ing.export_state()
    with pytest.raises(stream.wf.WireError):
        ing.ingest(blobs[1][:-7], 0.5)
    _same_state(ing.export_state(), before, rejected=1)
    resumed = stream.StreamIngest(ctx, sharded=eng)
    resumed.restore_state(*before)
    for s in (ref, resumed):
        s.ingest(blobs[1], 0.3)
        s.ingest_update(ProtectedUpdate(
            cipher.Ciphertext(_t(_cts(np.random.RandomState(5), ctx,
                                      (B + 2,))), ctx.delta),
            torch.ones(33)), 0.1)
        s.ingest(blobs[2], 0.5)
    _same_state(resumed.export_state(), ref.export_state())
    assert resumed._acc.on_slot_devices()
    assert eng.gathers == 0
    got, want = resumed.finalize(), ref.finalize()
    assert eng.gathers == 1
    assert torch.equal(got.ct.data, want.ct.data)
    assert torch.equal(got.plain, want.plain)


def _same_state(a, b, rejected=0):
    """Two exported states hold the same bits; `a` counts `rejected` more
    rejected updates."""
    (aa, am), (ba, bm) = a, b
    assert am == {**bm, "rejected": bm["rejected"] + rejected}
    for k in ba:
        np.testing.assert_array_equal(aa[k], ba[k])


@pytest.mark.parametrize("shape,l", CASES)
def test_fl_step_matches_single_device(meshes, shape, l):
    """make_he_agg_step over the mesh (limb-sharded where it can, chunk-only
    where not) and jit_he_agg_step: the single-device step's ciphertext and
    plaintext, block by block on their slots."""
    ctx, m = _ctx(l), meshes[shape][0]
    rng = np.random.RandomState(7 * l)
    for chunks in (4, 5):
        spec = fl_step.HeAggSpec(3, chunks, 31, ctx)
        cts = _t(_cts(rng, ctx, (3, chunks)))
        plain = torch.from_numpy(rng.randn(3, 31).astype(np.float32))
        w = [0.25, 0.25, 0.5]
        enc, pt = fl_step.make_he_agg_step(spec, w)(cts, plain)
        for step in (fl_step.make_he_agg_step(spec, w, m),
                     fl_step.jit_he_agg_step(spec, m, w)):
            genc, gpt = step(cts, plain)
            assert genc.equals(enc) and gpt.equals(pt)
            assert genc.on_slot_devices() and gpt.on_slot_devices()
            assert genc.mesh == (m if spec.limb_sharded(m)
                                 else m.flattened())


# ---------------------------------------------------------------------------
# the port's engine == the JAX package's engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,l", JAX_CASES)
def test_deterministic_ops_match_jax(meshes, shape, l):
    """weighted_sum, weighted_accum, weighted_accum_chunks and
    decrypt_to_coeffs on the same mesh shape: JAX's bits."""
    tm, jm = meshes[shape]
    ctx, jctx = _ctx(l), _jctx(l)
    teng, jeng = sharded.ShardedHe(ctx, tm), jsharded.ShardedHe(jctx, jm)
    rng = np.random.RandomState(30 + l)
    data = _cts(rng, ctx, (3, B))
    w = [0.1, 0.2, 0.7]
    got = teng.weighted_sum(cipher.Ciphertext(_t(data), 1.0), w)
    want = jeng.weighted_sum(jcipher.Ciphertext(jnp.asarray(data), 1.0), w)
    np.testing.assert_array_equal(_np(got.data), np.asarray(want.data))
    for acc in (data[0], data[0, 0]):
        got = teng.weighted_accum(cipher.Ciphertext(_t(acc), 1.0),
                                  cipher.Ciphertext(_t(data[1])), 0.3)
        want = jeng.weighted_accum(jcipher.Ciphertext(jnp.asarray(acc), 1.0),
                                   jcipher.Ciphertext(jnp.asarray(data[1])),
                                   0.3)
        np.testing.assert_array_equal(_np(got.data), np.asarray(want.data))
    accs = _residues(rng, ctx, (B, 2))                   # [K, 2, L, N]
    x = _residues(rng, ctx, (B, 2))
    wk = np.stack([rng.randint(0, q, B) for q in ctx.primes],
                  axis=1).astype(np.uint32)
    got = teng.weighted_accum_chunks(_t(accs), _t(x), _t(wk))
    want = jeng.weighted_accum_chunks(jnp.asarray(accs), jnp.asarray(x),
                                      jnp.asarray(wk))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    s = _residues(rng, ctx, ())
    got = teng.decrypt_to_coeffs({"s_mont": _t(s)},
                                 cipher.Ciphertext(_t(data[2])))
    want = jeng.decrypt_to_coeffs({"s_mont": jnp.asarray(s)},
                                  jcipher.Ciphertext(jnp.asarray(data[2])))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _lookup(keys, rows):
    """A traceable map from a PRNG key (one of `keys`) to its row."""
    tk, tr = jnp.asarray(np.asarray(keys)), jnp.asarray(np.asarray(rows))

    def find(key):
        return tr[jnp.argmax(jnp.all(tk == key[None], axis=-1))]

    return find


@pytest.fixture
def jax_samplers(monkeypatch):
    """Swap the JAX engine's samplers for lookups of injected draws; the
    compile caches are cleared before and after, so no graph traced with
    the swap outlives this test and none traced without it is reused."""
    jax.clear_caches()

    def install(ternary=None, gaussian=None, uniform=None):
        if ternary is not None:
            find = _lookup(*ternary)
            monkeypatch.setattr(
                jsharded, "_ternary_residues", lambda k, s, q: jnp.where(
                    find(k)[None] < 0, jnp.asarray(q)[:, None] - 1,
                    find(k)[None]).astype(jnp.uint32))
        if gaussian is not None:
            find_g = _lookup(*gaussian)
            monkeypatch.setattr(
                jsharded, "_gaussian_residues",
                lambda k, s, q, sigma: jref.mod_reduce_centered(
                    find_g(k)[None], jnp.asarray(q)[:, None]))
        if uniform is not None:
            find_u = _lookup(*uniform)
            monkeypatch.setattr(jsharded, "_uniform_residues",
                                lambda k, s, q: find_u(k))

    yield install
    monkeypatch.undo()
    jax.clear_caches()


@pytest.mark.parametrize("shape,l", JAX_CASES)
def test_keygen_and_encrypt_match_jax_with_injected_draws(
        meshes, shape, l, jax_samplers):
    """Keygen and public-key encrypt with the same numpy draws in both
    engines (JAX's looked up by the keys its graphs derive): JAX's bits."""
    tm, jm = meshes[shape]
    ctx, jctx = _ctx(l), _jctx(l)
    teng, jeng = sharded.ShardedHe(ctx, tm), jsharded.ShardedHe(jctx, jm)
    rng = np.random.RandomState(50 + l)
    s, e = rng.randint(-1, 2, N), np.rint(3.2 * rng.randn(N))
    a = _residues(rng, ctx, ())
    d = _draws(rng)
    m = _residues(rng, ctx, (B,))
    key, ekey = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    k_s, k_a, k_e = np.asarray(jax.random.split(key, 3))
    k3 = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(
        jcipher.derive_chunk_keys(ekey, 0, B)))          # [B, 3, 2]
    jax_samplers(ternary=(np.concatenate([k_s[None], k3[:, 0]]),
                          np.concatenate([s[None], d["u"]]).astype(np.int32)),
                 gaussian=(np.concatenate([k_e[None], k3[:, 1], k3[:, 2]]),
                           np.concatenate([e[None], d["e0"], d["e1"]])
                           .astype(np.int32)),
                 uniform=(k_a[None], a[None]))
    tsk, tpk = teng.keygen_from_samples(_i32(s), _t(a), _i32(e))
    jsk, jpk = jeng.keygen(key)
    for got, want in ((tsk["s_mont"], jsk["s_mont"]),
                      (tpk["pk0_mont"], jpk["pk0_mont"]),
                      (tpk["pk1_mont"], jpk["pk1_mont"])):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    got = teng.encrypt_coeffs_from_samples(tpk, _t(m), _i32(d["u"]),
                                           _i32(d["e0"]), _i32(d["e1"]))
    want = jeng.encrypt_coeffs(jpk, jnp.asarray(m), ekey)
    np.testing.assert_array_equal(_np(got.data), np.asarray(want.data))


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("derive", [1, 2])
def test_seeded_encrypt_matches_jax_with_injected_noise(
        meshes, derive, partitionable, jax_samplers):
    """The seeded encrypt's c1 (the public `a`, expanded per block from its
    global chunk ids) and c0 from the same noise: JAX's bits on the (2, 2)
    mesh, in both derive ids and both threefry layouts."""
    tm, jm = meshes[(2, 2)]
    ctx, jctx = _ctx(2, partitionable), _jctx(2)
    teng, jeng = sharded.ShardedHe(ctx, tm), jsharded.ShardedHe(jctx, jm)
    rng = np.random.RandomState(derive)
    s = _residues(rng, ctx, ())
    m = _residues(rng, ctx, (B,))
    e = np.rint(3.2 * rng.randn(B, N)).astype(np.int32)
    with jax.threefry_partitionable(partitionable):
        key = jax.random.PRNGKey(9)
        jax_samplers(gaussian=(np.asarray(jcipher.derive_chunk_keys(
            key, 0, B)), e))
        want = jeng.encrypt_coeffs_seeded({"s_mont": jnp.asarray(s)},
                                          jnp.asarray(m), key, 77,
                                          derive=derive)
        want = np.asarray(want.data)
    got = _np(teng.encrypt_coeffs_seeded_from_samples(
        {"s_mont": _t(s)}, _t(m), _i32(e), 77, derive=derive).data)
    np.testing.assert_array_equal(got[..., 1, :], want[..., 1, :])
    np.testing.assert_array_equal(got[..., 0, :], want[..., 0, :])


@pytest.mark.parametrize("limb_sharded", [True, False])
def test_fl_step_matches_jax(meshes, limb_sharded):
    """jit_he_agg_step on a (2, 2) mesh: limb-sharded at L=2 and chunk-only
    at L=3 (model 2 does not divide it); JAX's ciphertext bits and its
    plaintext sum within float32 rounding."""
    l = 2 if limb_sharded else 3
    tm, jm = meshes[(2, 2)]
    ctx, jctx = _ctx(l), _jctx(l)
    spec = fl_step.HeAggSpec(3, 4, 40, ctx)
    jspec = jfl_step.HeAggSpec(3, 4, 40, jctx)
    assert spec.limb_sharded(tm) == jspec.limb_sharded(jm) == limb_sharded
    rng = np.random.RandomState(l)
    cts = _cts(rng, ctx, (3, 4))
    plain = rng.randn(3, 40).astype(np.float32)
    w = [0.2, 0.5, 0.3]
    genc, gpt = fl_step.jit_he_agg_step(spec, tm, w)(
        _t(cts), torch.from_numpy(plain))
    wenc, wpt = jfl_step.jit_he_agg_step(jspec, jm, w)(jnp.asarray(cts),
                                                       jnp.asarray(plain))
    np.testing.assert_array_equal(_np(genc), np.asarray(wenc))
    np.testing.assert_allclose(gpt.assemble(CPU).numpy(), np.asarray(wpt),
                               rtol=4 * np.finfo(np.float32).eps, atol=1e-6)
    got = fl_step.HeAggSpec.for_model(10_000, 0.3, 3, 4, ctx)
    want = jfl_step.HeAggSpec.for_model(10_000, 0.3, 3, 4, jctx)
    assert (got.n_chunks, got.n_plain) == (want.n_chunks, want.n_plain)
    assert got.wire_bytes_per_client() == want.wire_bytes_per_client()
    assert {k: v[0] for k, v in got.input_specs().items()} == \
        {k: v.shape for k, v in want.input_specs().items()}


# ---------------------------------------------------------------------------
# the sharded ingest of JAX-packed blobs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_blobs():
    """Two JAX seeded blobs (both derives) and a JAX transcipher client's
    masked blob with its materials, under one secret key."""
    ctx, jctx = _ctx(2), _jctx(2)
    rng = np.random.RandomState(0)
    tsk, _ = cipher.keygen_from_samples(
        ctx, _i32(rng.randint(-1, 2, N)), _t(_residues(rng, ctx, ())),
        _i32(np.rint(3.2 * rng.randn(N))))
    jsk = {k: jnp.asarray(_np(v)) for k, v in tsk.items()}
    blobs = []
    for i, derive in enumerate((1, 2)):
        vals = jnp.asarray(rng.randn(B, jctx.slots).astype(np.float32))
        ct = jcipher.encrypt_values_seeded(jctx, jsk, vals,
                                           jax.random.PRNGKey(10 + i),
                                           a_seed=50 + i, derive=derive)
        blobs.append(jstream.pack_update_frames(
            JUpdate(ct=ct, plain=jnp.asarray(rng.randn(60), jnp.float32)),
            cid=i, n_samples=1,
            seeded=jcomp.seed_compress(ct, 50 + i, derive=derive)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtc.ops, "ntt_fwd", jax.jit(jtc.ops.ntt_fwd,
                                               static_argnums=1))
        jcm, jsm = jtc.provision(jctx, jsk, jax.random.PRNGKey(40), 700, B,
                                 derive=jcipher.DERIVE_CTR,
                                 keystream_seed=0x1234567890ABCDEF)
    mc = jcomp.MaskedChunk(
        masked=jtc.mask_values(jctx, jcm, rng.randn(B, jctx.slots).astype(
            np.float32) * 0.1), a_seed=jcm.a_seed, scale=jcm.scale,
        chunk_offset=jcm.chunk_offset, derive=jcm.derive)
    blobs.append(jstream.pack_masked_update_frames(
        mc, jcomp.seed_compress(jcm.seed_ct, jcm.escrow_a_seed, jcm.derive),
        np.arange(60, dtype=np.float32), cid=2, n_samples=1))
    tsm = interop.server_materials_from_np(
        np.asarray(jsm.d), "cpu", a_seed=jsm.a_seed,
        chunk_offset=jsm.chunk_offset, n_chunks=jsm.n_chunks,
        derive=jsm.derive, scale=jsm.scale)
    return blobs, jsm, tsm


def test_sharded_ingest_of_jax_blobs(meshes, jax_blobs):
    """The blobs through the port's sharded ingest on (2, 2), its
    unsharded ingest and the JAX package's sharded ingest: the same
    aggregate, plain sum, exported state and escrow frame; a rejected
    masked update leaves no trace; the state restores into a fresh sharded
    ingest."""
    blobs, jsm, tsm = jax_blobs
    tm, jm = meshes[(2, 2)]
    ctx, jctx = _ctx(2), _jctx(2)
    eng = sharded.ShardedHe(ctx, tm)
    mats = {(2, 0): tsm}
    ings = [stream.StreamIngest(ctx, sharded=eng,
                                transcipher_materials=mats),
            stream.StreamIngest(ctx, transcipher_materials=mats),
            jstream.StreamIngest(jctx, sharded=jsharded.ShardedHe(jctx, jm),
                                 transcipher_materials={(2, 0): jsm})]
    w = (0.25, 0.35, 0.4)
    for ing in ings:
        ing.ingest(blobs[0], w[0])
    before = ings[0].export_state()
    with pytest.raises(stream.wf.WireError):
        ings[0].ingest(blobs[2][:-3], w[2])
    _same_state(ings[0].export_state(), before, rejected=1)
    assert ings[0].escrow_seeds == {}
    ings[0] = stream.StreamIngest(ctx, sharded=eng,
                                  transcipher_materials=mats)
    ings[0].restore_state(*before)
    for ing in ings:
        ing.ingest(blobs[1], w[1])
        ing.ingest(blobs[2], w[2])
    (ja, jmeta) = ings[2].export_state()
    for ing in ings[:2]:
        ta, tmeta = ing.export_state()
        assert tmeta == jmeta
        for k in ja:
            np.testing.assert_array_equal(
                ta[k].view(np.uint32) if ta[k].dtype == np.float32 else ta[k],
                np.asarray(ja[k]).view(np.uint32)
                if ja[k].dtype == np.float32 else ja[k])
        esc_t, esc_j = ing.escrow_seeds[(2, 0)], ings[2].escrow_seeds[(2, 0)]
        np.testing.assert_array_equal(esc_t.c0, np.asarray(esc_j.c0))
    want = ings[2].finalize()
    for ing in ings[:2]:
        got = ing.finalize()
        np.testing.assert_array_equal(_np(got.ct.data),
                                      np.asarray(want.ct.data))
        np.testing.assert_array_equal(got.plain.numpy(),
                                      np.asarray(want.plain))
    assert eng.gathers == 1 and ings[0].accum_launches == 3
