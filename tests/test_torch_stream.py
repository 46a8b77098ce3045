"""The port's streaming ingest against the JAX package's, bit for bit.

JAX-packed blobs (both derive ids, wire v1 and v2, the f32/f16/i8 plain
codecs) go through the port's `StreamIngest` and the JAX package's; the
aggregates, plaintext sums and exported checkpoints must be identical.  A
rejected update must leave the port's state exactly as if it had never
arrived; checkpoints cross between the packages in both directions; the
selective-wire golden vectors (made with jax_threefry_partitionable=False)
are reproduced through the port's encrypt, packing and ingest.
"""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ckks import cipher as jcipher
from repro.core.ckks import encoding as jenc
from repro.core.ckks import params as jparams
from repro.core.secure_agg import ProtectedUpdate as JUpdate
from repro.kernels import ref as jref
from repro.wire import compress as jcomp
from repro.wire import format as jwf
from repro.wire import stream as jstream

from repro_torch import interop, obs
from repro_torch.core import packing as tpacking
from repro_torch.core import selection as tselection
from repro_torch.core.ckks import cipher as tcipher
from repro_torch.core.ckks import params as tparams
from repro_torch.core.secure_agg import (AggregatorConfig, ProtectedUpdate,
                                         SelectiveHEAggregator)
from repro_torch.wire import compress as tcomp
from repro_torch.wire import format as twf
from repro_torch.wire import stream as tstream

import gold
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_CHUNKS = 3
N_PLAIN = 200
WEIGHTS = (0.2, 0.3, 0.5)


@pytest.fixture(scope="module")
def keys():
    jctx = jparams.make_test_context()
    sk, pk = jcipher.keygen(jctx, jax.random.PRNGKey(0))
    return {"jctx": jctx, "sk": sk, "pk": pk,
            "tctx": tparams.make_test_context(device="cpu")}


def _client(keys, i, derive, seeded=True):
    """Client i's JAX update: seeded (a_seed 50 + i) or public-key."""
    jctx = keys["jctx"]
    rng = np.random.RandomState(100 + i)
    vals = jnp.asarray(rng.randn(N_CHUNKS, jctx.slots).astype(np.float32))
    plain = jnp.asarray(rng.randn(N_PLAIN).astype(np.float32))
    if seeded:
        ct = jcipher.encrypt_values_seeded(jctx, keys["sk"], vals,
                                           jax.random.PRNGKey(10 + i),
                                           a_seed=50 + i, derive=derive)
    else:
        ct = jcipher.encrypt_values(jctx, keys["pk"], vals,
                                    jax.random.PRNGKey(10 + i))
    return JUpdate(ct=ct, plain=plain)


def _jax_blobs(keys, derive=1, version=2, codec="f32", seeded=True):
    blobs = []
    for i in range(3):
        upd = _client(keys, i, derive, seeded)
        sct = (jcomp.seed_compress(upd.ct, 50 + i, derive=derive)
               if seeded else None)
        blobs.append(jstream.pack_update_frames(
            upd, cid=i, n_samples=i + 1, seeded=sct, plain_codec=codec,
            version=version))
    return blobs


def _assert_same_state(tst, jst):
    """Port and JAX ingests (or two ports) hold the same bits."""
    (ta, tm), (ja, jm) = tst.export_state(), jst.export_state()
    assert tm == jm
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and ta[k].shape == ja[k].shape, k
        np.testing.assert_array_equal(ta[k].view(np.uint32)
                                      if ta[k].dtype == np.float32
                                      else ta[k],
                                      ja[k].view(np.uint32)
                                      if ja[k].dtype == np.float32
                                      else ja[k])


def _assert_same_aggregate(tglob, jglob):
    np.testing.assert_array_equal(interop.residues_to_np(tglob.ct.data),
                                  np.asarray(jglob.ct.data))
    np.testing.assert_array_equal(tglob.plain.numpy().view(np.uint32),
                                  np.asarray(jglob.plain).view(np.uint32))
    assert tglob.ct.scale == jglob.ct.scale


CASES = [(1, 1, "f32"), (1, 1, "i8"), (1, 2, "f16"), (1, 2, "i8"),
         (2, 2, "f32"), (2, 2, "f16")]


@pytest.mark.parametrize("derive,version,codec", CASES)
def test_jax_blobs_ingest_bit_identical(keys, derive, version, codec):
    """The aggregate, plain sum, checkpoint and counters of the port's
    ingest equal the JAX package's; each JAX seeded ciphertext carried
    across and packed by the port gives the JAX bytes."""
    blobs = _jax_blobs(keys, derive, version, codec)
    for i, blob in enumerate(blobs):
        upd = _client(keys, i, derive)
        tupd = interop.protected_update_from_np(
            np.asarray(upd.ct.data), upd.ct.scale, np.asarray(upd.plain),
            "cpu")
        assert tstream.pack_update_frames(
            tupd, cid=i, n_samples=i + 1,
            seeded=tcomp.seed_compress(tupd.ct, 50 + i, derive),
            plain_codec=codec, version=version) == blob
    ji, ti = jstream.StreamIngest(keys["jctx"]), \
        tstream.StreamIngest(keys["tctx"])
    for blob, w in zip(blobs, WEIGHTS):
        assert ti.ingest(blob, w) == \
            tstream.UpdateMeta(**vars(ji.ingest(blob, w)))
    _assert_same_state(ti, ji)
    _assert_same_aggregate(ti.finalize(), ji.finalize())
    assert (ti.accum_launches, ti.peak_chunk_buffers, ti.clients_ingested,
            ti.bytes_ingested) == (ji.accum_launches, ji.peak_chunk_buffers,
                                   ji.clients_ingested, ji.bytes_ingested)


def test_full_ciphertext_blobs_and_in_memory_ingest(keys):
    """Public-key (CT_FULL) updates, then one more in memory
    (ingest_update): the same bits as the JAX package."""
    blobs = _jax_blobs(keys, seeded=False)
    ji, ti = jstream.StreamIngest(keys["jctx"]), \
        tstream.StreamIngest(keys["tctx"])
    for blob, w in zip(blobs, WEIGHTS):
        ji.ingest(blob, w)
        ti.ingest(blob, w)
    upd = _client(keys, 7, 1)
    ji.ingest_update(upd, 0.125)
    ti.ingest_update(interop.protected_update_from_np(
        np.asarray(upd.ct.data), upd.ct.scale, np.asarray(upd.plain), "cpu"),
        0.125)
    _assert_same_state(ti, ji)
    _assert_same_aggregate(ti.finalize(), ji.finalize())


def test_limb_dropped_full_ciphertexts_bit_identical(keys):
    """Full-ciphertext updates with one limb left (rescaled): the ingest
    takes its row shape from the first chunk and the kernel the first
    limb's tables, as the JAX package's does."""
    rescale = jax.jit(jcipher.rescale, static_argnums=0)
    blobs = []
    for i in range(2):
        upd = _client(keys, i, 1, seeded=False)
        upd = JUpdate(ct=rescale(keys["jctx"], upd.ct), plain=upd.plain)
        blobs.append(jstream.pack_update_frames(upd, cid=i, n_samples=1))
    ji, ti = jstream.StreamIngest(keys["jctx"]), \
        tstream.StreamIngest(keys["tctx"])
    for blob, w in zip(blobs, WEIGHTS):
        ji.ingest(blob, w)
        ti.ingest(blob, w)
    tglob = ti.finalize()
    assert tglob.ct.n_limbs == 1
    _assert_same_aggregate(tglob, ji.finalize())


def test_out_of_order_chunks_bit_identical(keys):
    """Chunk frames in another order than their indices: the flush gathers
    and scatters accumulator rows by index, with JAX's bits."""
    blobs = []
    for blob in _jax_blobs(keys, derive=2):
        f = _frames(blob)
        blobs.append(b"".join([f[0], f[3], f[1], f[2]] + f[4:]))
    ji, ti = jstream.StreamIngest(keys["jctx"]), \
        tstream.StreamIngest(keys["tctx"])
    for blob, w in zip(blobs, WEIGHTS):
        ji.ingest(blob, w)
        ti.ingest(blob, w)
    _assert_same_aggregate(ti.finalize(), ji.finalize())


def test_launch_and_buffer_invariants(keys):
    """One accumulate launch per update and at most one update's rows
    resident: the quickstart's invariants."""
    ti = tstream.StreamIngest(keys["tctx"])
    for blob, w in zip(_jax_blobs(keys), WEIGHTS):
        meta = ti.ingest(blob, w)
        assert meta.n_chunks == N_CHUNKS and meta.seeded
        assert not ti._pending and obs.REGISTRY.get(
            "wire_ingest_resident_chunks", ingest=ti.ingest_id).value == 0
    assert ti.accum_launches == ti.clients_ingested == 3
    assert ti.peak_chunk_buffers == N_CHUNKS
    assert tstream.peek_update_meta(_jax_blobs(keys)[2]).cid == 2


# ---------------------------------------------------------------------------
# rejected updates leave no trace
# ---------------------------------------------------------------------------


def _frames(blob):
    out, off = [], 0
    while off < len(blob):
        _, _, _, end = jwf.parse_frame(blob, off)
        out.append(blob[off:end])
        off = end
    return out


def _patch(frame_bytes, off, fmt, value):
    b = bytearray(frame_bytes)
    struct.pack_into(fmt, b, off, value)
    return bytes(b)


# offsets inside a CT_CHUNK frame holding a v2 seeded frame: outer header
# (16), chunk index (4), inner header (16), f64 scale, u64 seed, u32
# chunk_offset, u8 derive
_IDX, _SCALE, _SEED, _OFFSET, _DERIVE = 16, 36, 44, 52, 56


def _corrupt(kind, blob):
    f = _frames(blob)                 # BEGIN, 3 x CT_CHUNK, PLAIN, END
    last = len(f) - 3                 # the last CT_CHUNK
    if kind == "truncated":
        return blob[:-5]
    if kind == "dropped_chunk":
        del f[2]
    elif kind == "duplicate_chunk":
        f[2] = f[1]
    elif kind == "chunk_index_out_of_range":
        f[1] = _patch(f[1], _IDX, "<I", 99)
    elif kind == "mixed_scale":
        f[last] = _patch(f[last], _SCALE, "<d", 2.0)
    elif kind == "seed_overflow":
        f[last] = _patch(f[last], _SEED, "<Q", 2 ** 64 - 1)
    elif kind == "chunk_offset_overflow":
        f[last] = _patch(f[last], _OFFSET, "<I", 2 ** 31)
    elif kind == "unknown_derive":
        f[last] = _patch(f[last], _DERIVE, "<B", 9)
    elif kind == "plain_shape":
        f[-2] = jwf.serialize_plain_segment(np.zeros(7, np.float32), "f32",
                                            1.0)
    elif kind == "transcipher_seed_frame":
        sct = jcomp.SeededCiphertext(c0=np.zeros((1, 2, 256), np.uint32),
                                     seed=1, scale=1.0)
        f.insert(1, jwf.serialize_transcipher_seed(sct))
    elif kind == "missing_end":
        del f[-1]
    return b"".join(f)


KINDS = ["truncated", "dropped_chunk", "duplicate_chunk",
         "chunk_index_out_of_range", "mixed_scale", "seed_overflow",
         "chunk_offset_overflow", "unknown_derive", "plain_shape",
         "transcipher_seed_frame", "missing_end"]


@pytest.mark.parametrize("kind", KINDS)
def test_corrupted_blob_rejected_and_rolled_back(keys, kind):
    """Both packages reject the corrupted update; the port's state equals
    that of an ingest that never saw it, and the round continues to the
    JAX package's aggregate."""
    blobs = _jax_blobs(keys)
    bad = _corrupt(kind, blobs[1])
    ji = jstream.StreamIngest(keys["jctx"])
    ti = tstream.StreamIngest(keys["tctx"])
    clean = tstream.StreamIngest(keys["tctx"])
    for ing in (ji, ti, clean):
        ing.ingest(blobs[0], WEIGHTS[0])
    with pytest.raises(jwf.WireError):
        ji.ingest(bad, WEIGHTS[1])
    with pytest.raises(twf.WireError):
        ti.ingest(bad, WEIGHTS[1])
    assert ti.rejected_updates == ji.rejected_updates == 1
    # the counters are read-only registry series: count the rejection the
    # clean ingest never saw on its own series
    obs.counter("wire_ingest_rejected_updates",
                ingest=clean.ingest_id).inc()
    _assert_same_state(ti, clean)
    for ing in (ji, ti):
        ing.ingest(blobs[2], WEIGHTS[2])
    _assert_same_aggregate(ti.finalize(), ji.finalize())


def test_rejection_on_a_fresh_ingest_unpins_its_shape(keys):
    """A rejected first update must not pin the scale or the row shape."""
    blobs = _jax_blobs(keys)
    ti = tstream.StreamIngest(keys["tctx"])
    with pytest.raises(twf.WireError):
        ti.ingest(_corrupt("mixed_scale", blobs[0]), 1.0)
    assert ti._shape is None and ti._in_scale is None and ti._acc is None
    ti.ingest(blobs[0], 1.0)
    ji = jstream.StreamIngest(keys["jctx"])
    ji.ingest(blobs[0], 1.0)
    _assert_same_aggregate(ti.finalize(), ji.finalize())


def test_fuzzed_blobs_reject_without_trace(keys):
    """Random byte mutations and truncations: each update is accepted or
    raises WireError, and a rejection changes nothing but the count."""
    blob = _jax_blobs(keys)[0]
    rng = np.random.RandomState(3)
    ti = tstream.StreamIngest(keys["tctx"])
    ti.ingest(blob, 0.5)
    rejected = 0
    for _ in range(40):
        b = bytearray(blob)
        if rng.rand() < 0.5:
            b = b[:rng.randint(0, len(blob))]
        else:
            b[rng.randint(0, len(b))] ^= 1 + rng.randint(0, 255)
        before, meta = ti.export_state()
        try:
            ti.ingest(bytes(b), 0.5)
        except twf.WireError:
            rejected += 1
            after, meta_after = ti.export_state()
            assert meta_after["rejected"] == meta["rejected"] + 1
            for k in before:
                np.testing.assert_array_equal(after[k], before[k])
    assert rejected > 0


def test_transcipher_update_rejected_and_rolled_back(keys):
    """A CT_TRANSCIPHER update (framed by the JAX package) from a client
    with no provisioned transcipher materials raises WireError, and leaves
    no trace, its escrow frame included."""
    rng = np.random.RandomState(6)
    mc = jcomp.MaskedChunk(
        masked=rng.randint(0, 2 ** 32, (2, 256),
                           dtype=np.uint64).astype(np.uint32),
        a_seed=19, scale=2.0 ** 20, derive=jcomp.DERIVE_CTR)
    escrow = jcomp.SeededCiphertext(c0=np.zeros((1, 2, 256), np.uint32),
                                    seed=7, scale=1.0,
                                    derive=jcomp.DERIVE_CTR)
    blob = jstream.pack_masked_update_frames(
        mc, escrow, np.zeros(N_PLAIN, np.float32), cid=5, n_samples=1)
    assert tstream.peek_update_meta(blob).transcipher
    ti = tstream.StreamIngest(keys["tctx"])
    ti.ingest(_jax_blobs(keys)[0], 1.0)
    clean = tstream.StreamIngest(keys["tctx"])
    clean.ingest(_jax_blobs(keys)[0], 1.0)
    with pytest.raises(twf.WireError, match="no transcipher materials"):
        ti.ingest(blob, 1.0)
    # the counters are read-only registry series: count the rejection the
    # clean ingest never saw on its own series
    obs.counter("wire_ingest_rejected_updates",
                ingest=clean.ingest_id).inc()
    _assert_same_state(ti, clean)
    assert not ti.escrow_seeds


# ---------------------------------------------------------------------------
# checkpoints, finalize
# ---------------------------------------------------------------------------


def test_checkpoint_crosses_between_packages(keys):
    """JAX export_state -> port restore_state -> further ingests, and the
    port's export restored into JAX, give the bits of JAX doing it all."""
    blobs = _jax_blobs(keys, derive=2)
    ref = jstream.StreamIngest(keys["jctx"])
    for blob, w in zip(blobs, WEIGHTS):
        ref.ingest(blob, w)
    ji = jstream.StreamIngest(keys["jctx"])
    ji.ingest(blobs[0], WEIGHTS[0])
    ti = tstream.StreamIngest(keys["tctx"])
    ti.restore_state(*ji.export_state())
    ti.ingest(blobs[1], WEIGHTS[1])
    back = jstream.StreamIngest(keys["jctx"])
    back.restore_state(*ti.export_state())
    back.ingest(blobs[2], WEIGHTS[2])
    ti.ingest(blobs[2], WEIGHTS[2])
    _assert_same_state(ti, ref)
    _assert_same_aggregate(ti.finalize(), ref.finalize())
    np.testing.assert_array_equal(np.asarray(back.finalize().ct.data),
                                  np.asarray(ref.finalize().ct.data))
    with pytest.raises(RuntimeError, match="fresh"):
        ti.restore_state(*ji.export_state())


def test_finalize_errors_and_later_ingests(keys):
    ti = tstream.StreamIngest(keys["tctx"])
    with pytest.raises(twf.WireError, match="no updates"):
        ti.finalize()
    blobs = _jax_blobs(keys)
    ti.ingest(blobs[0], 0.5)
    first = ti.finalize()
    kept = (first.ct.data.clone(), first.plain.clone())
    ti.ingest(blobs[1], 0.5)
    assert torch.equal(first.ct.data, kept[0])
    assert torch.equal(first.plain, kept[1])
    arrays, meta = ti.export_state()
    holed = tstream.StreamIngest(keys["tctx"])
    holed.restore_state({**arrays, "chunk_idx": arrays["chunk_idx"][[0, 2]],
                         "acc_ct": arrays["acc_ct"][[0, 2]]}, meta)
    with pytest.raises(twf.WireError, match="missing ciphertext chunks"):
        holed.finalize()


# ---------------------------------------------------------------------------
# port clients, and the golden selective vectors
# ---------------------------------------------------------------------------


def test_port_client_blobs_ingest_identically_in_both_packages(keys):
    """Port clients (client_protect_seeded, noise from a generator) pack
    blobs that the JAX StreamIngest folds to the port's bits, and the
    round recovers the plaintext FedAvg."""
    tctx = keys["tctx"]
    gen = torch.Generator().manual_seed(5)
    sk, _ = tcipher.keygen(tctx, gen)
    model = {"w": torch.randn(40, 30, generator=gen),
             "b": torch.randn(77, generator=gen)}
    agg = SelectiveHEAggregator.build(
        tctx, model, torch.rand(1277, generator=gen),
        AggregatorConfig(p_ratio=0.3))
    ji = jstream.StreamIngest(keys["jctx"])
    ti = tstream.StreamIngest(tctx)
    expect = 0
    for i, w in enumerate(WEIGHTS):
        client = {k: v + 0.1 * i for k, v in model.items()}
        upd = agg.client_protect_seeded(client, sk, gen, a_seed=70 + i,
                                        derive=tcipher.DERIVE_CTR)
        blob = tstream.pack_update_frames(
            upd, cid=i, n_samples=1,
            seeded=tcomp.seed_compress(upd.ct, 70 + i, tcipher.DERIVE_CTR),
            plain_codec="f16")
        ji.ingest(blob, w)
        ti.ingest(blob, w)
        expect = expect + w * tpacking.flatten_params(client)[0]
    glob = ti.finalize()
    _assert_same_aggregate(glob, ji.finalize())
    got = tpacking.flatten_params(agg.client_recover_params(glob, sk))[0]
    assert float((got - expect).abs().max()) < 1e-2


def _golden_round(name):
    """gold.compute_kats' selective path with the port doing the split,
    the seeded encrypt (JAX's coefficients and noise symbols), the packing
    and the ingest."""
    spec = gold.KAT_CONTEXTS[name]
    jctx = jparams.make_context(**spec)
    tctx = tparams.make_context(**spec, device="cpu",
                                threefry_partitionable=False)
    rng = np.random.RandomState(12345)
    for _ in range(2):                   # the NTT and encrypt KAT inputs
        jref.rand_limbed_np(rng, jctx, (2,))
    sk, _ = jcipher.keygen(jctx, jax.random.PRNGKey(0))
    tsk = interop.keys_from_np({k: np.asarray(v) for k, v in sk.items()},
                               "cpu")
    n_total = 5 * jctx.slots // 2
    part = tpacking.make_partition(
        tselection.top_p_mask(torch.from_numpy(rng.rand(n_total)), 0.45),
        jctx.slots)
    encode = jax.jit(jenc.encode_jnp, static_argnums=1)
    blobs = []
    for i in range(2):
        vec = torch.from_numpy(rng.randn(n_total).astype(np.float32))
        enc_vals, plain = tpacking.split_by_mask(vec, part)
        key = jax.random.PRNGKey(10 + i)
        b = enc_vals.shape[0]
        e = np.stack([np.asarray(jnp.rint(jctx.error_sigma * jax.random.normal(
            jax.random.fold_in(key, j), (jctx.n_poly,))).astype(jnp.int32))
            for j in range(b)])
        coeffs = np.asarray(encode(jnp.asarray(enc_vals.numpy()), jctx))
        ct = tcipher.encrypt_coeffs_seeded_from_samples(
            tctx, tsk, interop.residues_from_np(coeffs, "cpu"),
            torch.from_numpy(e), a_seed=1234 + i)
        blobs.append(tstream.pack_update_frames(
            ProtectedUpdate(ct=ct, plain=plain), cid=i, n_samples=i + 1,
            rnd=0, seeded=tcomp.seed_compress(ct, 1234 + i),
            plain_codec="i8", version=2))
    ing = tstream.StreamIngest(tctx)
    for blob, w in zip(blobs, [0.25, 0.75]):
        ing.ingest(blob, w)
    return blobs[0], ing.finalize()


@pytest.mark.parametrize("name", sorted(gold.KAT_CONTEXTS))
def test_selective_golden_vectors_through_the_port(name):
    kats = gold.load_kats()
    with jax.threefry_partitionable(False):
        blob, glob = _golden_round(name)
    np.testing.assert_array_equal(
        np.frombuffer(blob, dtype=np.uint8).astype(np.uint32),
        kats[f"{name}/selective_wire"])
    np.testing.assert_array_equal(interop.residues_to_np(glob.ct.data),
                                  kats[f"{name}/selective_agg"])
