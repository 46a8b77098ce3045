"""The port's threefry key stream and public `a` expansion against JAX.

`repro_torch.core.ckks.threefry` must give JAX's PRNGKey, fold_in, split,
32-bit random bits and uint32 randint bit for bit, in both layouts of
`jax_threefry_partitionable`; the seeded ciphertext's c1 rows that
`cipher.expand_a_rows` regenerates from (a_seed, derive id) must equal the
JAX package's for both derive ids.  The layout is switched with JAX's
context manager only (never a global config update: other tests share the
worker process).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ckks import cipher as jcipher
from repro.core.ckks import params as jparams

from repro_torch import interop
from repro_torch.core.ckks import cipher as tcipher
from repro_torch.core.ckks import params as tparams
from repro_torch.core.ckks import threefry

import gold
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

LAYOUTS = (True, False)
SEEDS = (0, 77, 2 ** 31 + 5, 2 ** 40 + 3)
# q of the 3-limb N=256 test context and edge spans of randint: 1, just
# above 2**16 (where JAX's multiplier wraps to 0), and the largest u32
MAXVALS = np.asarray([[1073479681], [65537], [4294967295], [1]],
                     dtype=np.uint32)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _tkey(key):
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _eq(port, want):
    np.testing.assert_array_equal(port.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS + (-1, 2 ** 63 - 1, -2 ** 63))
def test_prng_key_matches_jax(seed):
    """Seeds of 2**32 and more keep only their low word (2**40 + 3 ->
    [0, 3]), as JAX's conversion with 64-bit mode off does."""
    _eq(threefry.prng_key(seed), _jkey(seed))


@pytest.mark.parametrize("seed", [2 ** 63, 2 ** 64 - 1, -2 ** 63 - 1])
def test_prng_key_overflows_like_jax(seed):
    with pytest.raises(OverflowError):
        _jkey(seed)
    with pytest.raises(OverflowError):
        threefry.prng_key(seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_key_ops_and_draws_match_jax(partitionable, seed):
    """split, fold_in, random bits (odd and even sizes) and randint with a
    per-row maxval column, for one key and for a batch of keys."""
    with jax.threefry_partitionable(partitionable):
        k = _jkey(seed)
        tk = _tkey(k)
        for num in (2, 3):
            _eq(threefry.split(tk, num, partitionable),
                jax.random.split(k, num))
        for data in (0, 7, 2 ** 32 - 1):
            _eq(threefry.fold_in(tk, data), jax.random.fold_in(k, data))
        for shape in ((7,), (3, 5), (2, 8)):
            _eq(threefry.random_bits(tk, shape, partitionable),
                jax.random.bits(k, shape, dtype=jnp.uint32))
        maxval = jnp.asarray(MAXVALS)
        tmax = torch.from_numpy(MAXVALS.astype(np.int64))
        _eq(threefry.randint_u32(tk, (4, 33), tmax, partitionable),
            jax.random.randint(k, (4, 33), jnp.uint32(0), maxval,
                               dtype=jnp.uint32))
        keys = jax.random.split(k, 3)
        want = np.stack([np.asarray(jax.random.randint(
            kk, (4, 6), jnp.uint32(0), maxval, dtype=jnp.uint32))
            for kk in keys])
        _eq(threefry.randint_u32(_tkey(keys), (4, 6), tmax, partitionable),
            want)


def test_fold_in_data_out_of_uint32_range_raises():
    with pytest.raises(OverflowError):
        threefry.fold_in(threefry.prng_key(1), 2 ** 32)
    with pytest.raises(OverflowError):
        threefry.fold_in(threefry.prng_key(1), -1)


# ---------------------------------------------------------------------------
# per-chunk derivation and the public `a` rows
# ---------------------------------------------------------------------------

# (derive, start): FOLD_CHUNK ids cross the int32 edge, CTR counters wrap
# past 2**32
DERIVE_STARTS = [(jcipher.DERIVE_FOLD_CHUNK, 0),
                 (jcipher.DERIVE_FOLD_CHUNK, 2 ** 31 - 2),
                 (jcipher.DERIVE_CTR, 5),
                 (jcipher.DERIVE_CTR, 2 ** 32 - 2)]


@pytest.mark.parametrize("derive,start", DERIVE_STARTS)
@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_derive_chunk_keys_match_jax(partitionable, derive, start):
    with jax.threefry_partitionable(partitionable):
        base = _jkey(2 ** 40 + 3)
        _eq(tcipher.derive_chunk_keys(_tkey(base), start, 4, derive,
                                      partitionable),
            jcipher.derive_chunk_keys(base, start, 4, derive))


@pytest.mark.parametrize("derive,start", [(jcipher.DERIVE_FOLD_CHUNK, 2 ** 31),
                                          (jcipher.DERIVE_CTR, 2 ** 32),
                                          (jcipher.DERIVE_CTR, -1)])
def test_derive_start_out_of_range_raises_like_jax(derive, start):
    base = _jkey(3)
    with pytest.raises(OverflowError):
        jcipher.derive_chunk_keys(base, start, 2, derive)
    with pytest.raises(OverflowError):
        tcipher.derive_chunk_keys(_tkey(base), start, 2, derive)


def test_unknown_derive_id_raises():
    with pytest.raises(ValueError, match="unknown seed-derivation id"):
        tcipher.derive_chunk_keys(threefry.prng_key(0), 0, 1, 9)


@pytest.mark.parametrize("derive", [jcipher.DERIVE_FOLD_CHUNK,
                                    jcipher.DERIVE_CTR])
@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_expand_a_rows_matches_jax(partitionable, derive):
    """N=256, L=3; seeds below and above 2**32; start offsets 0 and 3."""
    jctx = jparams.make_test_context(n_poly=256, n_limbs=3, delta_bits=12)
    tctx = tparams.make_test_context(n_poly=256, n_limbs=3, delta_bits=12,
                                     device="cpu",
                                     threefry_partitionable=partitionable)
    with jax.threefry_partitionable(partitionable):
        for seed in (77, 2 ** 40 + 3):
            for start in (0, 3):
                np.testing.assert_array_equal(
                    interop.residues_to_np(tcipher.expand_a_rows(
                        tctx, seed, start, 3, derive)),
                    np.asarray(jcipher.expand_a_rows(jctx, seed, start, 3,
                                                     derive)))


def test_expand_a_for_ids_equals_contiguous_rows():
    """The ingest expands rows by explicit ids in any grouping: the same
    bits as the contiguous expansion."""
    tctx = tparams.make_test_context(n_poly=256, device="cpu")
    rows = tcipher.expand_a_rows(tctx, 5, 0, 6)
    ids = torch.tensor([4, 1, 5])
    assert torch.equal(tcipher.expand_a_for_ids(tctx, 5, ids), rows[ids])


@pytest.mark.parametrize("name", sorted(gold.KAT_CONTEXTS))
def test_expand_a_rows_reproduces_golden_seeded_c1(name):
    """The golden file was made with the layout False: the c1 half of its
    encrypt_seeded vector (a_seed 77, 2 chunks) is the port's expansion."""
    kats = gold.load_kats()
    tctx = tparams.make_context(**gold.KAT_CONTEXTS[name], device="cpu",
                                threefry_partitionable=False)
    np.testing.assert_array_equal(
        interop.residues_to_np(tcipher.expand_a_rows(tctx, 77, 0, 2)),
        kats[f"{name}/encrypt_seeded"][..., 1, :])
