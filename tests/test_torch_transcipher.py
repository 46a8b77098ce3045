"""The port's transcipher (thin-client) uplink against the JAX package.

Context: the reference suite's `make_test_context(n_poly=256, n_limbs=2,
delta_bits=20)`.  Every comparison with JAX is exact (bits and bytes): the
keystream pads in both derive ids and both threefry layouts, D from
`provision_from_samples` fed JAX's own noise draws, the masked words,
`server_unmask` (whole and spanned rows), the StreamIngest aggregate of
JAX-packed masked blobs, and the port's masked frames.  The rejection cases
mirror tests/test_transcipher.py: each rejected update leaves no trace, and
the escrow seed it overwrote is restored.
"""
import dataclasses
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.ckks import cipher as jcipher
from repro.core.ckks import encoding as jenc
from repro.core.ckks import params as jparams
from repro.core.ckks import transcipher as jtc
from repro.core.secure_agg import ProtectedUpdate as JProtectedUpdate
from repro.wire import compress as jwc
from repro.wire import stream as jws

from repro_torch import interop
from repro_torch.core.ckks import cipher as tcipher
from repro_torch.core.ckks import params as tparams
from repro_torch.core.ckks import threefry
from repro_torch.core.ckks import transcipher as ttc
from repro_torch.core.secure_agg import (AggregatorConfig,
                                         SelectiveHEAggregator)
from repro_torch.wire import compress as twc
from repro_torch.wire import format as twf
from repro_torch.wire import stream as tws
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, L, DELTA_BITS = 256, 2, 20
DERIVES = (jcipher.DERIVE_FOLD_CHUNK, jcipher.DERIVE_CTR)
B = 3
KS_SEED = 0xF00DFACE12345678            # >= 2**63: needs the raw u64 key
JCTX = jparams.make_test_context(n_poly=N, n_limbs=L, delta_bits=DELTA_BITS)


def _tctx(partitionable=True):
    return tparams.make_test_context(n_poly=N, n_limbs=L,
                                     delta_bits=DELTA_BITS, device="cpu",
                                     threefry_partitionable=partitionable)


TCTX = _tctx()


def _values(b=B, seed=0, scale=0.1):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, JCTX.slots) * scale).astype(np.float32)


def _jax_seeded_noise(key, b):
    """The gaussian symbols of JAX's seeded encrypt: chunk i from
    fold_in(key, i), rint(sigma * normal(N))."""
    return np.stack([np.asarray(jnp.rint(
        JCTX.error_sigma * jax.random.normal(jax.random.fold_in(key, i),
                                             (N,))).astype(jnp.int32))
        for i in range(b)])


@pytest.fixture(scope="module")
def keys():
    """A secret key (port keygen from numpy draws) in both packages."""
    rng = np.random.RandomState(0)
    tsk, _ = tcipher.keygen_from_samples(
        TCTX, torch.from_numpy(rng.randint(-1, 2, N)),
        torch.from_numpy(np.stack([rng.randint(0, q, N)
                                   for q in TCTX.primes]).astype(np.int32)),
        torch.from_numpy(np.rint(3.2 * rng.randn(N)).astype(np.int32)))
    return ({k: jnp.asarray(interop.residues_to_np(v))
             for k, v in tsk.items()}, tsk)


@pytest.fixture(scope="module")
def provisioned(keys):
    """derive -> (JAX cm, sm, port cm, sm) provisioned with the same noise,
    seed and a_seed; the port fed JAX's draws.  JAX's provision runs with
    its eager ntt_fwd compiled as one graph (the same function; op-by-op
    dispatch of its unrolled stages costs 16 s on the CPU)."""
    jsk, tsk = keys
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtc.ops, "ntt_fwd", jax.jit(jtc.ops.ntt_fwd,
                                               static_argnums=1))
        for derive in DERIVES:
            key, a_seed = jax.random.PRNGKey(40 + derive), 700 + derive
            out[derive] = jtc.provision(JCTX, jsk, key, a_seed, B,
                                        derive=derive,
                                        keystream_seed=KS_SEED)
    for derive in DERIVES:
        jcm, jsm = out[derive]
        key, a_seed = jax.random.PRNGKey(40 + derive), 700 + derive
        e = _jax_seeded_noise(key, B)
        escrow_e = _jax_seeded_noise(jax.random.fold_in(key, 0x5EED), 1)
        tcm, tsm = ttc.provision_from_samples(
            TCTX, tsk, torch.from_numpy(e), torch.from_numpy(escrow_e),
            KS_SEED, a_seed, derive=derive)
        out[derive] = (jcm, jsm, tcm, tsm)
    return out


def _port_sm(jsm):
    """A JAX ServerMaterials carried into the port."""
    return interop.server_materials_from_np(
        np.asarray(jsm.d), "cpu", a_seed=jsm.a_seed,
        chunk_offset=jsm.chunk_offset, n_chunks=jsm.n_chunks,
        derive=jsm.derive, scale=jsm.scale)


def _port_cm(jcm):
    return interop.client_materials_from_np(
        np.asarray(jcm.seed_ct.data), jcm.seed_ct.scale, "cpu",
        keystream_seed=jcm.keystream_seed, a_seed=jcm.a_seed,
        chunk_offset=jcm.chunk_offset, n_chunks=jcm.n_chunks,
        derive=jcm.derive, scale=jcm.scale, escrow_a_seed=jcm.escrow_a_seed)


def _digits_seed(ctx, sk, ct):
    dig = tcipher.decrypt_values_np(ctx, sk, ct).ravel()[:4]
    return sum(int(round(float(d))) << (16 * i) for i, d in enumerate(dig))


# ---------------------------------------------------------------------------
# keystream pads, D, masked words, unmask: bit for bit
# ---------------------------------------------------------------------------


def test_raw_key_takes_the_whole_u64_range():
    assert threefry.raw_key(2 ** 64 - 1).tolist() == [2 ** 32 - 1] * 2
    assert threefry.raw_key(KS_SEED).tolist() == [KS_SEED >> 32,
                                                  KS_SEED & 0xFFFFFFFF]
    for bad in (-1, 2 ** 64):
        with pytest.raises(ValueError, match="u64"):
            threefry.raw_key(bad)


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("derive", DERIVES)
def test_expand_pad_rows_bit_identical(derive, partitionable):
    """Seeds below and above 2**63; rows [5, 9): the pads of any slice."""
    tctx = _tctx(partitionable)
    for seed in (999, KS_SEED):
        with jax.threefry_partitionable(partitionable):
            want = np.asarray(jtc.expand_pad_rows(N, seed, 5, 4, derive))
        got = interop.residues_to_np(
            ttc.expand_pad_rows(tctx, seed, 5, 4, derive))
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 1 << 30 and got.max() < 3 << 30


@pytest.mark.parametrize("derive", DERIVES)
def test_provision_from_samples_bit_identical(derive, provisioned, keys):
    """D equals JAX's.  seed_ct is the seeded encryption (held to JAX's in
    tests/test_torch_cipher.py) of the float64-encoded escrow coefficients
    with the escrow noise, and decrypts to the seed."""
    _, tsk = keys
    jcm, jsm, tcm, tsm = provisioned[derive]
    np.testing.assert_array_equal(interop.residues_to_np(tsm.d),
                                  np.asarray(jsm.d))
    for f in ("a_seed", "chunk_offset", "n_chunks", "derive", "scale"):
        assert getattr(tsm, f) == getattr(jsm, f)
        assert getattr(tcm, f) == getattr(jcm, f)
    assert (tcm.keystream_seed, tcm.escrow_a_seed) == \
        (jcm.keystream_seed, jcm.escrow_a_seed)
    key = jax.random.fold_in(jax.random.PRNGKey(40 + derive), 0x5EED)
    want = tcipher.encrypt_coeffs_seeded_from_samples(
        TCTX, tsk, interop.residues_from_np(jenc.encode_np(
            jtc.escrow_values(KS_SEED, JCTX), JCTX), "cpu"),
        torch.from_numpy(_jax_seeded_noise(key, 1)), jcm.escrow_a_seed,
        derive=derive)
    assert torch.equal(tcm.seed_ct.data, want.data)
    assert _digits_seed(TCTX, tsk, tcm.seed_ct) == KS_SEED


@pytest.mark.parametrize("derive", DERIVES)
def test_mask_values_bit_identical(derive):
    """300 rows: encode_centered's row blocks give JAX's coefficients."""
    v = _values(b=300, seed=3)
    fields = dict(keystream_seed=KS_SEED, a_seed=5, chunk_offset=2,
                  n_chunks=300, derive=derive, scale=JCTX.delta,
                  seed_ct=None, escrow_a_seed=0)
    want = jtc.mask_values(JCTX, jtc.ClientMaterials(**fields), v)
    got = ttc.mask_values(TCTX, ttc.ClientMaterials(**fields),
                          torch.from_numpy(v))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("derive", DERIVES)
def test_server_unmask_bit_identical(derive, provisioned, keys):
    """JAX's materials and masked rows through the port's unmask, whole and
    as the spanned row [1, 2); the port's own materials give the same, and
    JAX's client materials carried across mask to the same words."""
    jcm, jsm, _, tsm = provisioned[derive]
    masked = jtc.mask_values(JCTX, jcm, _values())
    np.testing.assert_array_equal(
        ttc.mask_values(TCTX, _port_cm(jcm), _values()), masked)
    for rows, start in ((masked, 0), (masked[1:2], 1)):
        want = jtc.server_unmask(JCTX, jsm, rows, start)
        for sm in (_port_sm(jsm), tsm):
            got = ttc.server_unmask(TCTX, sm, rows, start)
            np.testing.assert_array_equal(interop.residues_to_np(got.data),
                                          np.asarray(want.data))
            assert got.scale == want.scale
    with pytest.raises(ValueError, match="provisioned range"):
        ttc.server_unmask(TCTX, tsm, masked[:2], 2)


def _jax_blob(jcm, v, plain, cid, rnd=0):
    mc = jwc.MaskedChunk(masked=jtc.mask_values(JCTX, jcm, v),
                         a_seed=jcm.a_seed, scale=jcm.scale,
                         chunk_offset=jcm.chunk_offset, derive=jcm.derive)
    sct = jwc.seed_compress(jcm.seed_ct, jcm.escrow_a_seed, jcm.derive)
    return jws.pack_masked_update_frames(mc, sct, plain, cid=cid,
                                         n_samples=2, rnd=rnd)


@pytest.mark.parametrize("derive", DERIVES)
def test_ingest_of_jax_masked_blobs_bit_identical(derive, provisioned,
                                                   keys):
    """A JAX client's masked blob after a seeded one, into both packages'
    StreamIngest: the same aggregate bits, plain sum and escrow frame."""
    jcm, jsm, _, _ = provisioned[derive]
    v, plain = _values(seed=8), np.arange(9, dtype=np.float32)
    blob = _jax_blob(jcm, v, plain, cid=1)
    ct = jcipher.encrypt_coeffs_seeded(
        JCTX, keys[0], jnp.asarray(jenc.encode_np(_values(seed=9), JCTX)),
        jax.random.PRNGKey(77), 31, derive=derive)
    seeded = jws.pack_update_frames(
        JProtectedUpdate(ct=ct, plain=jnp.asarray(plain[::-1].copy())),
        cid=2, n_samples=1, seeded=jwc.seed_compress(ct, 31, derive))
    jing = jws.StreamIngest(JCTX, transcipher_materials={(1, 0): jsm})
    ting = tws.StreamIngest(TCTX, transcipher_materials={(1, 0):
                                                         _port_sm(jsm)})
    for ing in (jing, ting):
        ing.ingest(seeded, 0.25)
        meta = ing.ingest(blob, 0.75)
        assert meta.transcipher and not meta.seeded
    want, got = jing.finalize(), ting.finalize()
    np.testing.assert_array_equal(interop.residues_to_np(got.ct.data),
                                  np.asarray(want.ct.data))
    np.testing.assert_array_equal(got.plain.numpy(), np.asarray(want.plain))
    assert got.ct.scale == want.ct.scale
    assert ting.accum_launches == 2 and ting.peak_chunk_buffers == B
    esc_t, esc_j = ting.escrow_seeds[(1, 0)], jing.escrow_seeds[(1, 0)]
    np.testing.assert_array_equal(esc_t.c0, np.asarray(esc_j.c0))
    assert (esc_t.seed, esc_t.derive) == (esc_j.seed, esc_j.derive)


@pytest.mark.parametrize("codec", ["f32", "i8"])
def test_masked_frames_byte_identical(codec, provisioned):
    """The port's pack_masked_update_frames gives JAX's bytes for the same
    masked words, escrow ciphertext and plain part."""
    jcm, _, tcm, _ = provisioned[jcipher.DERIVE_CTR]
    v, plain = _values(seed=11), np.linspace(-1, 1, 7).astype(np.float32)
    masked = ttc.mask_values(TCTX, tcm, v)
    want = jws.pack_masked_update_frames(
        jwc.MaskedChunk(masked=masked, a_seed=jcm.a_seed, scale=jcm.scale,
                        derive=jcm.derive),
        jwc.seed_compress(jcm.seed_ct, jcm.escrow_a_seed, jcm.derive),
        plain, cid=4, n_samples=3, rnd=2, plain_codec=codec)
    got = tws.pack_masked_update_frames(
        twc.MaskedChunk(masked=masked, a_seed=tcm.a_seed, scale=tcm.scale,
                        derive=tcm.derive),
        interop.seeded_from_np(np.asarray(jcm.seed_ct.data)[..., 0, :],
                               jcm.escrow_a_seed, jcm.seed_ct.scale, "cpu",
                               derive=jcm.derive),
        torch.from_numpy(plain), cid=4, n_samples=3, rnd=2,
        plain_codec=codec)
    assert got == want
    assert ttc.masked_uplink_bytes(B, N) * L == \
        ttc.seeded_uplink_bytes(B, L, N) == 4 * B * L * N


# ---------------------------------------------------------------------------
# the port's own provisioning, and the round through the aggregator
# ---------------------------------------------------------------------------


def test_provision_draws_a_secret_seed_and_checks_it(keys):
    _, tsk = keys
    cm1, sm1 = ttc.provision(TCTX, tsk, torch.Generator().manual_seed(1),
                             12345, 2)
    cm2, _ = ttc.provision(TCTX, tsk, torch.Generator().manual_seed(2),
                           12345, 2)
    assert cm1.keystream_seed != cm2.keystream_seed
    assert 0 <= cm1.keystream_seed < 1 << 64
    assert not hasattr(sm1, "keystream_seed")
    assert _digits_seed(TCTX, tsk, cm1.seed_ct) == cm1.keystream_seed
    assert cm1.escrow_a_seed == 12345 + ttc.ESCROW_SEED_OFFSET
    cm3, _ = ttc.provision(TCTX, tsk, torch.Generator().manual_seed(1),
                           12345, 2, keystream_seed=0xDEADBEEF)
    assert cm3.keystream_seed == 0xDEADBEEF
    with pytest.raises(ValueError, match="64 bits"):
        ttc.provision(TCTX, tsk, torch.Generator(), 12345, 2,
                      keystream_seed=1 << 64)


def test_client_validation(keys):
    _, tsk = keys
    cm, _ = ttc.provision(TCTX, tsk, torch.Generator().manual_seed(0), 1, 1)
    big = np.zeros((1, N), dtype=np.int64)
    big[0, 0] = 1 << ttc.BOUND_BITS
    with pytest.raises(ValueError, match="delta"):
        ttc.mask_coeffs_centered(TCTX, cm, big)
    big[0, 0] = -(1 << ttc.BOUND_BITS) + 1
    assert ttc.mask_coeffs_centered(TCTX, cm, big).dtype == np.uint32
    with pytest.raises(ValueError, match="chunks"):
        ttc.mask_coeffs_centered(TCTX, cm, np.zeros((3, N), np.int64))


@pytest.mark.parametrize("chunk_offset", [0, 3])
def test_unmasked_round_decrypts(keys, chunk_offset):
    """Provisioned at a chunk offset, the unmasked rows still decrypt: the
    zero encryption uses the rows the unmask expands."""
    _, tsk = keys
    v = _values(b=2, seed=6)
    cm, sm = ttc.provision(TCTX, tsk, torch.Generator().manual_seed(3), 77,
                           2, chunk_offset=chunk_offset)
    ct = ttc.server_unmask(TCTX, sm, ttc.mask_values(TCTX, cm, v),
                           chunk_offset)
    assert np.abs(tcipher.decrypt_values_np(TCTX, tsk, ct) - v).max() < 1e-3


def test_aggregator_round_recovers_fedavg(keys):
    _, tsk = keys
    gen = torch.Generator().manual_seed(0)
    model = {"w": torch.randn(60, 10, generator=gen)}
    agg = SelectiveHEAggregator.build(TCTX, model,
                                      torch.randn(600, generator=gen).abs(),
                                      AggregatorConfig(p_ratio=0.4))
    ing = tws.StreamIngest(TCTX)
    for cid in range(2):
        cm, sm = ttc.provision(TCTX, tsk, gen, 50 + cid, agg.part.n_chunks)
        ing.add_transcipher_materials(cid, 1, sm)
        masked, plain = agg.client_protect_transcipher(
            {"w": model["w"] + cid}, cm, gen)
        ing.ingest(tws.pack_masked_update_frames(
            twc.MaskedChunk(masked=masked, a_seed=cm.a_seed, scale=cm.scale,
                            derive=cm.derive),
            twc.seed_compress(cm.seed_ct, cm.escrow_a_seed, cm.derive),
            plain, cid=cid, n_samples=1, rnd=1), 0.5)
    rec = agg.client_recover_params(ing.finalize(), tsk)
    assert float((rec["w"] - model["w"] - 0.5).abs().max()) < 1e-2


# ---------------------------------------------------------------------------
# rejections: atomic, escrow rolled back
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_materials(keys):
    _, tsk = keys
    return ttc.provision(TCTX, tsk, torch.Generator().manual_seed(5), 88, B)


def _port_blob(cm, v=None, cid=2, rnd=0, version=None):
    v = _values(seed=4) if v is None else v
    mc = twc.MaskedChunk(masked=ttc.mask_values(TCTX, cm, v),
                         a_seed=cm.a_seed, scale=cm.scale,
                         chunk_offset=cm.chunk_offset, derive=cm.derive)
    sct = twc.seed_compress(cm.seed_ct, cm.escrow_a_seed, cm.derive)
    return tws.pack_masked_update_frames(mc, sct, np.zeros(4, np.float32),
                                         cid=cid, n_samples=1, rnd=rnd,
                                         version=version)


def _untouched(ing, rejected):
    assert ing.rejected_updates == rejected and ing._acc is None
    assert not ing._pending and not ing.escrow_seeds


def test_unprovisioned_update_rejected_then_healed(port_materials):
    cm, sm = port_materials
    blob = _port_blob(cm, cid=3, rnd=1)
    ing = tws.StreamIngest(TCTX)
    with pytest.raises(twf.WireError, match="no transcipher materials"):
        ing.ingest(blob, 1.0)
    _untouched(ing, 1)
    ing.add_transcipher_materials(3, 1, sm)
    ing.ingest(blob, 1.0)
    assert ing.finalize().ct.data.shape == (B, L, 2, N)


@pytest.mark.parametrize("field,match", [
    ("a_seed", "do not match the provisioned"),
    ("derive", "do not match the provisioned"),
    ("chunk_offset", "provisioned range"),
    ("n_chunks", "provisioned range")])
def test_mismatched_materials_rejected(port_materials, field, match):
    cm, sm = port_materials
    bad = dataclasses.replace(sm, **{
        "a_seed": {"a_seed": sm.a_seed + 1},
        "derive": {"derive": jcipher.DERIVE_FOLD_CHUNK},
        "chunk_offset": {"chunk_offset": 1},
        "n_chunks": {"n_chunks": B - 1}}[field])
    ing = tws.StreamIngest(TCTX, transcipher_materials={(2, 0): bad})
    with pytest.raises(twf.WireError, match=match):
        ing.ingest(_port_blob(cm), 1.0)
    _untouched(ing, 1)


def test_rejected_update_restores_prior_escrow_seed(port_materials):
    cm, sm = port_materials
    ing = tws.StreamIngest(TCTX, transcipher_materials={(6, 2): sm})
    ing.ingest(_port_blob(cm, cid=6, rnd=2), 1.0)
    before = ing.escrow_seeds[(6, 2)]
    bad = dataclasses.replace(cm, a_seed=cm.a_seed + 1,
                              escrow_a_seed=cm.escrow_a_seed + 7)
    with pytest.raises(twf.WireError, match="do not match the provisioned"):
        ing.ingest(_port_blob(bad, cid=6, rnd=2), 1.0)
    assert ing.escrow_seeds[(6, 2)] is before
    assert ing.rejected_updates == 1 and not ing._pending
    assert ing.finalize().ct.data.shape == (B, L, 2, N)


def test_chunk_kind_must_match_declared_ct_kind(port_materials, keys):
    _, tsk = keys
    cm, sm = port_materials
    v = _values(b=1, seed=22)
    cm1, sm1 = ttc.provision(TCTX, tsk, torch.Generator().manual_seed(16),
                             66, 1)
    arr, qscale = twc.quantize_plain(np.zeros(3, np.float32), "f32")

    def blob(kind, *inner):
        return b"".join([
            twf.frame(twf.T_UPDATE_BEGIN, tws._BEGIN.pack(1, 1, 0, 1, kind)),
            *inner, twf.serialize_plain_segment(arr, "f32", qscale),
            twf.frame(twf.T_UPDATE_END, b"")])

    def chunk(inner):
        return twf.frame(twf.T_CT_CHUNK, struct.pack("<I", 0) + inner)

    masked = chunk(twf.serialize_masked_chunk(twc.MaskedChunk(
        masked=ttc.mask_values(TCTX, cm1, v), a_seed=cm1.a_seed,
        scale=cm1.scale, derive=cm1.derive)))
    ct = tcipher.encrypt_values_seeded(TCTX, tsk, torch.from_numpy(v),
                                       torch.Generator().manual_seed(17), 66)
    seeded = chunk(twf.serialize_seeded_ciphertext(twc.seed_compress(ct,
                                                                     66)))
    escrow = twf.serialize_transcipher_seed(
        twc.seed_compress(cm1.seed_ct, cm1.escrow_a_seed, cm1.derive))
    ing = tws.StreamIngest(TCTX, transcipher_materials={(1, 0): sm1})
    for kind, inner in ((tws.CT_FULL, masked), (tws.CT_SEEDED, masked),
                        (tws.CT_TRANSCIPHER, seeded)):
        with pytest.raises(twf.WireError, match="declared ct_kind"):
            ing.ingest(blob(kind, escrow if kind == tws.CT_TRANSCIPHER
                            else b"", inner), 1.0)
    with pytest.raises(twf.WireError, match="unknown ct_kind"):
        ing.ingest(blob(7, seeded), 1.0)
    with pytest.raises(twf.WireError, match="non-transcipher"):
        ing.ingest(blob(tws.CT_SEEDED, escrow, seeded), 1.0)
    _untouched(ing, 5)
    ing.ingest(blob(tws.CT_TRANSCIPHER, escrow, masked), 1.0)
    assert set(ing.escrow_seeds) == {(1, 0)}


def test_transcipher_frames_are_v2_only(port_materials):
    cm, _ = port_materials
    with pytest.raises(twf.WireError, match="v1"):
        _port_blob(cm, version=1)
    with pytest.raises(twf.WireError, match="v1"):
        twf.serialize_transcipher_seed(
            twc.seed_compress(cm.seed_ct, cm.escrow_a_seed, cm.derive),
            version=1)
