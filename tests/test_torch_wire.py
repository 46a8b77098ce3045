"""The port's wire format, compression and bandwidth ledger against the JAX
package's `repro.wire`, byte for byte.

Every serializer must emit the reference's bytes for the same inputs (both
wire versions, every frame type, the f32/f16/i8 plain codecs); the port's
decoder must read the reference's frames back to the same values; and the
robustness rule of `tests/test_wire.py` holds for the port's decoder: any
truncated or mutated frame decodes or raises WireError, nothing else.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.wire as jwire
from repro.core import packing as jpacking
from repro.core.ckks import cipher as jcipher
from repro.core.ckks import params as jparams
from repro.core.secure_agg import ProtectedUpdate as JUpdate
from repro.kernels import ref as jref
from repro.wire import budget as jbudget
from repro.wire import compress as jcomp
from repro.wire import format as jwf
from repro.wire import stream as jstream

import repro_torch.wire as twire
from repro_torch import interop
from repro_torch.core import packing as tpacking
from repro_torch.core.ckks import params as tparams
from repro_torch.wire import budget as tbudget
from repro_torch.wire import compress as tcomp
from repro_torch.wire import format as twf
from repro_torch.wire import stream as tstream
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CODECS = ("f32", "f16", "i8")


@pytest.fixture(scope="module")
def mat():
    """JAX-made ciphertexts and keys at N=256, L=2, and the port's
    copies."""
    jctx = jparams.make_test_context()
    tctx = tparams.make_test_context(device="cpu")
    sk, pk = jcipher.keygen(jctx, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    coeffs = jnp.asarray(jref.rand_limbed_np(rng, jctx, (2,)))
    seeded = {d: jcipher.encrypt_coeffs_seeded(
        jctx, sk, coeffs, jax.random.PRNGKey(1), a_seed=2 ** 40 + 3,
        derive=d) for d in (jcomp.DERIVE_FOLD_CHUNK, jcomp.DERIVE_CTR)}
    ct = jcipher.encrypt_coeffs(jctx, pk, coeffs, jax.random.PRNGKey(2))
    plain = rng.randn(300).astype(np.float32)
    plain[:3] = [0.0, 1e-40, -65504.0]       # zero, subnormal, f16 edge
    mask = rng.rand(700) < 0.3
    return {"jctx": jctx, "tctx": tctx, "sk": sk, "pk": pk, "ct": ct,
            "seeded": seeded, "plain": plain, "mask": mask,
            "masked": rng.randint(0, 2 ** 32, (2, 256),
                                  dtype=np.uint64).astype(np.uint32)}


def _tct(ct):
    return interop.ciphertext_from_np(np.asarray(ct.data), ct.scale, "cpu")


def _tupd(ct, plain):
    return interop.protected_update_from_np(np.asarray(ct.data), ct.scale,
                                            plain, "cpu")


def _tsct(sct):
    return interop.seeded_from_np(np.asarray(sct.c0), sct.seed, sct.scale,
                                  "cpu", sct.chunk_offset, sct.derive)


def _masked(mat, mod):
    return mod.MaskedChunk(masked=mat["masked"], a_seed=2 ** 41 + 1,
                           scale=2.0 ** 20, chunk_offset=3,
                           derive=jcomp.DERIVE_CTR)


# ---------------------------------------------------------------------------
# serializers: the reference's bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("version", [1, 2])
def test_ciphertext_and_seeded_frames_byte_identical(mat, version):
    ct = mat["ct"]
    assert twf.serialize_ciphertext(_tct(ct), version=version) == \
        jwf.serialize_ciphertext(ct, version=version)
    for d, sct_full in mat["seeded"].items():
        jsct = jcomp.seed_compress(sct_full, 2 ** 40 + 3, derive=d)
        tsct = tcomp.seed_compress(_tct(sct_full), 2 ** 40 + 3, derive=d)
        if version == 1 and d != jcomp.DERIVE_FOLD_CHUNK:
            for wf, s in ((jwf, jsct), (twf, tsct)):
                with pytest.raises(wf.WireError, match="not expressible"):
                    wf.serialize_seeded_ciphertext(s, version=1)
            continue
        assert twf.serialize_seeded_ciphertext(tsct, version=version) == \
            jwf.serialize_seeded_ciphertext(jsct, version=version)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("version", [1, 2])
def test_update_frames_byte_identical(mat, version, codec):
    """serialize_update (full and seeded) and pack_update_frames with each
    plain codec."""
    ct, plain = mat["ct"], mat["plain"]
    sct_full = mat["seeded"][jcomp.DERIVE_FOLD_CHUNK]
    jsct = jcomp.seed_compress(sct_full, 2 ** 40 + 3)
    assert twf.serialize_update(_tupd(ct, plain), plain_codec=codec,
                                version=version) == \
        jwf.serialize_update(JUpdate(ct=ct, plain=jnp.asarray(plain)),
                             plain_codec=codec, version=version)
    assert twf.serialize_update(_tupd(sct_full, plain), seeded=_tsct(jsct),
                                plain_codec=codec, version=version) == \
        jwf.serialize_update(JUpdate(ct=sct_full, plain=jnp.asarray(plain)),
                             seeded=jsct, plain_codec=codec, version=version)
    assert tstream.pack_update_frames(
        _tupd(sct_full, plain), cid=4, n_samples=9, rnd=2,
        seeded=_tsct(jsct), plain_codec=codec, version=version) == \
        jstream.pack_update_frames(
            JUpdate(ct=sct_full, plain=jnp.asarray(plain)), cid=4,
            n_samples=9, rnd=2, seeded=jsct, plain_codec=codec,
            version=version)


def test_transcipher_keyset_and_partition_frames_byte_identical(mat):
    """The v2-only transcipher frames (and their v1 refusal), the keyset,
    and the partition with int32 index arrays."""
    jmc, tmc = _masked(mat, jcomp), _masked(mat, tcomp)
    assert twf.serialize_masked_chunk(tmc) == jwf.serialize_masked_chunk(jmc)
    jsct = jcomp.seed_compress(mat["seeded"][jcomp.DERIVE_CTR], 5,
                               derive=jcomp.DERIVE_CTR)
    assert twf.serialize_transcipher_seed(_tsct(jsct)) == \
        jwf.serialize_transcipher_seed(jsct)
    for fn, arg in ((twf.serialize_masked_chunk, tmc),
                    (twf.serialize_transcipher_seed, _tsct(jsct))):
        with pytest.raises(twf.WireError, match="v1"):
            fn(arg, version=1)
    assert twf.serialize_keyset(interop.keys_from_np(
        {k: np.asarray(v) for k, v in mat["pk"].items()}, "cpu")) == \
        jwf.serialize_keyset(mat["pk"])
    tpart = tpacking.make_partition(torch.from_numpy(mat["mask"]), 128)
    jpart = jpacking.make_partition(mat["mask"], 128)
    blob = twf.serialize_partition(tpart)
    assert blob == jwf.serialize_partition(jpart)
    back, _ = twf.deserialize(blob)
    assert torch.equal(back.mask, tpart.mask) and back.slots == 128


@pytest.mark.parametrize("codec", CODECS)
def test_quantize_and_dequantize_match_jax(mat, codec):
    for x in (mat["plain"], np.zeros(5, np.float32),
              np.zeros(0, np.float32), np.float32([1e-45, -1e-45])):
        # a subnormal amax: both cast the i8 scale to float32, where it is
        # 0, and divide by it (the same bytes; numpy warns)
        with np.errstate(divide="ignore"):
            jarr, jscale = jcomp.quantize_plain(x, codec)
            tarr, tscale = tcomp.quantize_plain(torch.from_numpy(x), codec)
        assert tarr.dtype == jarr.dtype and tarr.tobytes() == jarr.tobytes()
        assert tscale == jscale
        np.testing.assert_array_equal(
            tcomp.dequantize_plain(tarr, codec, tscale).view(np.uint32),
            jcomp.dequantize_plain(jarr, codec, jscale).view(np.uint32))


# ---------------------------------------------------------------------------
# decoder: the reference's frames read back to the same values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("version", [1, 2])
def test_jax_frames_deserialize_to_the_same_values(mat, version):
    tctx = mat["tctx"]
    ct, plain = mat["ct"], mat["plain"]
    got, end = twf.deserialize(jwf.serialize_ciphertext(ct, version=version))
    assert end > 0 and got.scale == ct.scale
    np.testing.assert_array_equal(interop.residues_to_np(got.data),
                                  np.asarray(ct.data))
    sct_full = mat["seeded"][jcomp.DERIVE_FOLD_CHUNK]
    jsct = jcomp.seed_compress(sct_full, 2 ** 40 + 3)
    got, _ = twf.deserialize(jwf.serialize_seeded_ciphertext(
        jsct, version=version))
    assert (got.seed, got.scale, got.chunk_offset, got.derive) == \
        (jsct.seed, jsct.scale, jsct.chunk_offset, jsct.derive)
    np.testing.assert_array_equal(got.c0, np.asarray(jsct.c0))
    for codec in CODECS:
        blob = jwf.serialize_update(
            JUpdate(ct=sct_full, plain=jnp.asarray(plain)), seeded=jsct,
            plain_codec=codec, version=version)
        want, _ = jwf.deserialize(blob, mat["jctx"])
        got, _ = twf.deserialize(blob, tctx)
        np.testing.assert_array_equal(interop.residues_to_np(got.ct.data),
                                      np.asarray(want.ct.data))
        np.testing.assert_array_equal(got.plain.numpy().view(np.uint32),
                                      np.asarray(want.plain).view(np.uint32))
    keys, _ = twf.deserialize(jwf.serialize_keyset(mat["pk"]))
    for k, v in mat["pk"].items():
        np.testing.assert_array_equal(interop.residues_to_np(keys[k]),
                                      np.asarray(v))


def test_jax_transcipher_frames_deserialize(mat):
    jmc = _masked(mat, jcomp)
    got, _ = twf.deserialize(jwf.serialize_masked_chunk(jmc))
    assert isinstance(got, tcomp.MaskedChunk)
    assert (got.a_seed, got.scale, got.chunk_offset, got.derive) == \
        (jmc.a_seed, jmc.scale, jmc.chunk_offset, jmc.derive)
    np.testing.assert_array_equal(got.masked, jmc.masked)
    jsct = jcomp.seed_compress(mat["seeded"][jcomp.DERIVE_CTR], 5,
                               derive=jcomp.DERIVE_CTR)
    got, _ = twf.deserialize(jwf.serialize_transcipher_seed(jsct))
    assert isinstance(got, tcomp.SeededCiphertext)
    assert got.derive == jcomp.DERIVE_CTR and got.seed == 5


def test_unknown_version_and_derive_rejected(mat):
    jsct = jcomp.seed_compress(mat["seeded"][jcomp.DERIVE_FOLD_CHUNK], 3)
    blob = bytearray(jwf.serialize_seeded_ciphertext(jsct))
    bad = bytes(blob[:4]) + b"\x03" + bytes(blob[5:])
    with pytest.raises(twf.WireError, match="REPRO_WIRE_VERSION"):
        twf.deserialize(bad)
    # the v2 derive byte follows f64 scale, u64 seed, u32 offset
    blob[twf.HEADER_BYTES + 20] = 9
    with pytest.raises(twf.WireError, match="seed-derivation id 9"):
        twf.deserialize(bytes(blob))


def _corpus(mat):
    """Valid port-made frames of every type, both versions, both derives."""
    ct = _tct(mat["ct"])
    sct = tcomp.seed_compress(_tct(mat["seeded"][1]), 5)
    sct_ctr = tcomp.seed_compress(_tct(mat["seeded"][2]), 6, derive=2)
    upd = _tupd(mat["seeded"][1], mat["plain"][:40])
    out = [twf.serialize_keyset(interop.keys_from_np(
               {k: np.asarray(v) for k, v in mat["pk"].items()}, "cpu")),
           twf.serialize_partition(tpacking.make_partition(
               torch.from_numpy(mat["mask"]), 128)),
           twf.serialize_seeded_ciphertext(sct_ctr),
           twf.serialize_masked_chunk(_masked(mat, tcomp)),
           twf.serialize_transcipher_seed(sct_ctr)]
    for v in (1, 2):
        out += [twf.serialize_ciphertext(ct, version=v),
                twf.serialize_seeded_ciphertext(sct, version=v),
                twf.serialize_update(upd, version=v),
                twf.serialize_update(upd, seeded=sct, plain_codec="i8",
                                     version=v)]
    return out


def test_fuzz_truncation_always_wire_error(mat):
    for blob in _corpus(mat):
        cuts = set(range(0, min(len(blob), 64))) | {
            len(blob) * k // 23 for k in range(23)} | {len(blob) - 1}
        for cut in sorted(c for c in cuts if c < len(blob)):
            with pytest.raises(twf.WireError):
                twf.deserialize(blob[:cut], mat["tctx"])


def test_fuzz_mutation_decodes_or_raises_wire_error(mat):
    rng = np.random.RandomState(0)
    for blob in _corpus(mat):
        out, end = twf.deserialize(blob, mat["tctx"])
        assert end == len(blob) and out is not None
        positions = np.concatenate([np.arange(min(len(blob), 48)),
                                    rng.randint(0, len(blob), size=48)])
        for pos in positions:
            b = bytearray(blob)
            b[pos] ^= 1 + rng.randint(0, 255)
            try:
                twf.deserialize(bytes(b), mat["tctx"])
            except twf.WireError:
                pass


def test_fuzz_garbage_and_resized_buffers(mat):
    rng = np.random.RandomState(1)
    for n in (0, 1, twf.HEADER_BYTES - 1, twf.HEADER_BYTES, 64, 4096):
        try:
            twf.deserialize(rng.bytes(n))
        except twf.WireError:
            pass
    for blob in _corpus(mat)[:2]:
        grown = bytearray(blob)
        grown[8:16] = (2 ** 62).to_bytes(8, "little")     # payload_len
        with pytest.raises(twf.WireError):
            twf.deserialize(bytes(grown))


def test_frame_reader_splits_any_slicing(mat):
    blob = b"".join(_corpus(mat)[:4])
    want = list(twf.iter_frames(blob))
    rd = twf.FrameReader()
    got = []
    rng = np.random.RandomState(2)
    off = 0
    while off < len(blob):
        step = int(rng.randint(1, 700))
        rd.feed(blob[off:off + step])
        off += step
        got += list(rd)
    assert [(t, f, bytes(p)) for t, f, p in want] == got


# ---------------------------------------------------------------------------
# bandwidth ledger, package surface, version pin
# ---------------------------------------------------------------------------


def test_ledger_record_blob_classes_match_jax(mat):
    sct_full = mat["seeded"][jcomp.DERIVE_FOLD_CHUNK]
    jsct = jcomp.seed_compress(sct_full, 2 ** 40 + 3)
    plain = jnp.asarray(mat["plain"])
    blobs = [
        (jstream.pack_update_frames(JUpdate(ct=sct_full, plain=plain),
                                    cid=1, n_samples=2, seeded=jsct,
                                    plain_codec="f16"), 1, jbudget.UPLINK),
        (jstream.pack_update_frames(JUpdate(ct=mat["ct"], plain=plain),
                                    cid=2, n_samples=2), 2, jbudget.UPLINK),
        (jwf.serialize_update(JUpdate(ct=mat["ct"], plain=plain)), 0,
         jbudget.DOWNLINK),
        (jwf.serialize_keyset(mat["pk"]), 0, jbudget.DOWNLINK),
    ]
    jl, tl = jbudget.BandwidthLedger(), tbudget.BandwidthLedger()
    for blob, cid, direction in blobs:
        assert tl.record_blob(blob, rnd=3, cid=cid, direction=direction) \
            == jl.record_blob(blob, rnd=3, cid=cid, direction=direction) \
            == len(blob)
    assert [tuple(vars(r).values()) for r in tl.records] == \
        [tuple(vars(r).values()) for r in jl.records]
    assert tl.report_rows() == jl.report_rows()
    jpart = jpacking.make_partition(mat["mask"], 128)
    tpart = tpacking.make_partition(torch.from_numpy(mat["mask"]), 128)
    assert tl.compression_summary(mat["tctx"], tpart, 3) == \
        jl.compression_summary(mat["jctx"], jpart, 3)


def test_wire_package_exports_the_reference_names():
    assert sorted(twire.__all__) == sorted(jwire.__all__)
    assert twf.VERSION == jwf.VERSION
    assert twf.SUPPORTED_VERSIONS == jwf.SUPPORTED_VERSIONS
    assert tcomp.DERIVES == jcomp.DERIVES


_PIN_CHECK = """
import importlib, os
os.environ["REPRO_WIRE_VERSION"] = "1"
from repro_torch.wire import format as f
print(f.EMIT_VERSION, f.frame(f.T_UPDATE_END, b"")[4])
os.environ["REPRO_WIRE_VERSION"] = "7"
try:
    importlib.reload(f)
except ValueError as e:
    print(type(e).__name__, str(e).split(";")[0])
"""


def test_wire_version_env_pin_is_read_as_the_reference_reads_it():
    """REPRO_WIRE_VERSION=1 pins every emitted frame to v1; an unsupported
    value fails at import with WireError."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "REPRO_WIRE_VERSION")}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _PIN_CHECK], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "1 1", "WireError REPRO_WIRE_VERSION='7' is not a supported wire "
        "version"]
