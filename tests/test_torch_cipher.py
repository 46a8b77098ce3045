"""The port's cipher against the JAX package, bit for bit.

Keygen and encrypt are fed the same numpy-made draws (ternary symbols,
rounded gaussians, uniform residues) in the port's `*_from_samples` bodies
and in the same composition of `repro.kernels.ops` that the JAX package's
jitted graphs run; the resulting keys and ciphertexts must be identical.
JAX-made ciphertexts and keys carried across through `interop` must decrypt
and aggregate to identical residues.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.ckks import cipher as jcipher
from repro.core.ckks import encoding as jenc
from repro.core.ckks import params as jparams
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch import interop
from repro_torch.core.ckks import cipher as tcipher
from repro_torch.core.ckks import params as tparams
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

NS = (256, 1024)
SIGMA = 3.2


def _ctxs(n):
    return (jparams.make_test_context(n_poly=n, n_limbs=2),
            tparams.make_test_context(n_poly=n, n_limbs=2, device="cpu"))


def _draws(rng, jctx, b):
    n = jctx.n_poly
    return {
        "s": rng.randint(-1, 2, n), "e": np.rint(SIGMA * rng.randn(n)),
        "a": np.stack([rng.randint(0, q, n) for q in jctx.primes]),
        "u": rng.randint(-1, 2, (b, n)),
        "e0": np.rint(SIGMA * rng.randn(b, n)),
        "e1": np.rint(SIGMA * rng.randn(b, n)),
    }


def _jax_centered(v, jctx):
    """The JAX package's residue map for small signed draws."""
    return jref.mod_reduce_centered(v.astype(jnp.int32)[..., None, :],
                                    jctx.tables.qs[:, None])


def _jax_keygen(jctx, d):
    """cipher._keygen_graph with the draws injected."""
    s = jops.ntt_fwd(_jax_centered(d["s"], jctx), jctx)
    s_mont = jops.to_mont(s, jctx)
    a = d["a"].astype(jnp.uint32)
    e = jops.ntt_fwd(_jax_centered(d["e"], jctx), jctx)
    pk0 = jops.mod_add(jops.mod_neg(jops.mont_mul(a, s_mont, jctx), jctx), e,
                       jctx)
    return ({"s_mont": s_mont},
            {"pk0_mont": jops.to_mont(pk0, jctx),
             "pk1_mont": jops.to_mont(a, jctx)})


def _jax_encrypt(jctx, pk, m_coeff, d):
    """cipher._encrypt_body with the draws injected."""
    m = jops.ntt_fwd(m_coeff, jctx)
    u = jops.ntt_fwd(_jax_centered(d["u"], jctx), jctx)
    e0 = jops.ntt_fwd(_jax_centered(d["e0"], jctx), jctx)
    e1 = jops.ntt_fwd(_jax_centered(d["e1"], jctx), jctx)
    c0 = jops.mul_add(u, pk["pk0_mont"][None], jops.mod_add(e0, m, jctx),
                      jctx)
    c1 = jops.mul_add(u, pk["pk1_mont"][None], e1, jctx)
    return jnp.stack([c0, c1], axis=-2)


def _port_draws(d):
    return {k: torch.from_numpy(v.astype(np.int32)) for k, v in d.items()}


@pytest.fixture(scope="module", params=NS, ids=lambda n: f"n{n}")
def jax_material(request):
    """Per N: JAX keys, a JAX ciphertext of 3 rows and 3 more to aggregate."""
    n = request.param
    jctx, tctx = _ctxs(n)
    jsk, jpk = jcipher.keygen(jctx, jax.random.PRNGKey(n))
    rng = np.random.RandomState(n)
    vals = rng.randn(3, jctx.slots).astype(np.float32)
    # one compiled encrypt graph per N: every ciphertext has 3 rows
    jct = jcipher.encrypt_coeffs(jctx, jpk,
                                 jnp.asarray(jenc.encode_np(vals, jctx)),
                                 jax.random.PRNGKey(n + 1))
    jcts = [jcipher.encrypt_coeffs(
        jctx, jpk, jnp.asarray(jref.rand_limbed_np(rng, jctx, (3,))),
        jax.random.PRNGKey(10 + i)) for i in range(3)]
    return dict(jctx=jctx, tctx=tctx, jsk=jsk, jct=jct, jcts=jcts)


@pytest.mark.parametrize("n", NS)
def test_keygen_and_encrypt_bit_identical_with_injected_draws(n):
    jctx, tctx = _ctxs(n)
    rng = np.random.RandomState(n)
    d = _draws(rng, jctx, b=3)
    td = _port_draws(d)
    jsk, jpk = jax.jit(functools.partial(_jax_keygen, jctx))(d)
    tsk, tpk = tcipher.keygen_from_samples(tctx, td["s"], td["a"], td["e"])
    for want, got in ((jsk, tsk), (jpk, tpk)):
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(interop.residues_to_np(got[k]),
                                          np.asarray(want[k]), err_msg=k)
    m = jref.rand_limbed_np(rng, jctx, (3,))
    want = jax.jit(functools.partial(_jax_encrypt, jctx))(jpk, m, d)
    ct = tcipher.encrypt_coeffs_from_samples(
        tctx, tpk, interop.residues_from_np(m, "cpu"), td["u"], td["e0"],
        td["e1"])
    assert ct.scale == jctx.delta and ct.n_limbs == 2
    np.testing.assert_array_equal(interop.residues_to_np(ct.data),
                                  np.asarray(want))


def test_decrypt_of_jax_ciphertext_is_bit_identical(jax_material):
    j = jax_material
    jctx, tctx, jsk, jct = j["jctx"], j["tctx"], j["jsk"], j["jct"]
    sk = interop.keys_from_np({k: np.asarray(v) for k, v in jsk.items()},
                              "cpu")
    ct = interop.ciphertext_from_np(np.asarray(jct.data), jct.scale, "cpu")
    np.testing.assert_array_equal(
        interop.residues_to_np(tcipher.decrypt_to_coeffs(tctx, sk, ct)),
        np.asarray(jcipher.decrypt_to_coeffs(jctx, jsk, jct)))
    jdecode = jax.jit(jenc.decode_jnp, static_argnums=(1, 2))
    np.testing.assert_allclose(
        tcipher.decrypt_values(tctx, sk, ct).numpy(),
        np.asarray(jdecode(jcipher.decrypt_to_coeffs(jctx, jsk, jct), jctx,
                           jct.scale)), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        tcipher.decrypt_values_np(tctx, sk, ct),
        jcipher.decrypt_values_np(jctx, jsk, jct))


def test_homomorphic_ops_on_jax_ciphertexts_are_bit_identical(jax_material):
    j = jax_material
    jctx, tctx, jcts = j["jctx"], j["tctx"], j["jcts"]
    cts = [interop.ciphertext_from_np(np.asarray(c.data), c.scale, "cpu")
           for c in jcts]
    w = [0.2, 0.3, 0.5]
    jstack = jcipher.Ciphertext(data=jnp.stack([c.data for c in jcts]),
                                scale=jcts[0].scale)
    tstack = tcipher.Ciphertext(data=torch.stack([c.data for c in cts]),
                                scale=cts[0].scale)
    jsum = jcipher.weighted_sum(jctx, jstack, w)
    tsum = tcipher.weighted_sum(tctx, tstack, w)
    assert tsum.scale == jsum.scale
    np.testing.assert_array_equal(interop.residues_to_np(tsum.data),
                                  np.asarray(jsum.data))
    np.testing.assert_array_equal(
        interop.residues_to_np(tcipher.add(tctx, cts[0], cts[1]).data),
        np.asarray(jcipher.add(jctx, jcts[0], jcts[1]).data))
    jmul = jcipher.mul_plain_scalar(jctx, jcts[2], 0.75)
    tmul = tcipher.mul_plain_scalar(tctx, cts[2], 0.75)
    assert tmul.scale == jmul.scale
    np.testing.assert_array_equal(interop.residues_to_np(tmul.data),
                                  np.asarray(jmul.data))


def test_sampled_round_trip_decrypts():
    """keygen/encrypt with generator draws (not JAX's stream) still give a
    working scheme, and the same seed gives the same ciphertext."""
    _, tctx = _ctxs(256)
    sk, pk = tcipher.keygen(tctx, torch.Generator().manual_seed(1))
    vals = torch.from_numpy(
        np.random.RandomState(2).randn(2, tctx.slots).astype(np.float32))
    ct = tcipher.encrypt_values(tctx, pk, vals,
                                torch.Generator().manual_seed(3))
    again = tcipher.encrypt_values(tctx, pk, vals,
                                   torch.Generator().manual_seed(3))
    assert torch.equal(ct.data, again.data)
    assert ct.data.dtype == torch.int32 and ct.data.shape == (2, 2, 2, 256)
    np.testing.assert_allclose(tcipher.decrypt_values(tctx, sk, ct).numpy(),
                               vals.numpy(), rtol=0, atol=1e-2)


def test_interop_refuses_mismatched_contexts():
    jctx, tctx = _ctxs(256)
    interop.check_context(tctx, jctx.primes, jctx.n_poly, jctx.delta_bits)
    with pytest.raises(ValueError, match="primes"):
        interop.check_context(tctx, jparams.make_test_context(
            n_poly=1024).primes)
    with pytest.raises(ValueError, match="delta"):
        interop.check_context(tctx, jctx.primes, delta_bits=26)


def test_interop_round_trips_keys_and_ciphertexts(jax_material):
    j = jax_material
    jsk = {k: np.asarray(v) for k, v in j["jsk"].items()}
    back = interop.keys_to_np(interop.keys_from_np(jsk, "cpu"))
    assert set(back) == set(jsk)
    for k in jsk:
        np.testing.assert_array_equal(back[k], jsk[k])
    data, scale = interop.ciphertext_to_np(interop.ciphertext_from_np(
        np.asarray(j["jct"].data), j["jct"].scale, "cpu"))
    assert data.dtype == np.uint32 and scale == j["jct"].scale
    np.testing.assert_array_equal(data, np.asarray(j["jct"].data))


# ---------------------------------------------------------------------------
# seeded encrypt, rescale, drop_limbs, mul_plain_vec (the wire slice)
# ---------------------------------------------------------------------------


def _ctxs_l(n, l, partitionable=True):
    return (jparams.make_test_context(n_poly=n, n_limbs=l, delta_bits=12),
            tparams.make_test_context(n_poly=n, n_limbs=l, delta_bits=12,
                                      device="cpu",
                                      threefry_partitionable=partitionable))


def _jax_seeded_noise(key, b, n):
    """The gaussian symbols JAX's seeded encrypt draws: chunk i from
    fold_in(key, i), rint(sigma * normal(N))."""
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(b))
    return np.stack([np.asarray(jnp.rint(SIGMA * jax.random.normal(
        k, (n,))).astype(jnp.int32)) for k in keys])


@pytest.mark.parametrize("derive", [jcipher.DERIVE_FOLD_CHUNK,
                                    jcipher.DERIVE_CTR])
@pytest.mark.parametrize("partitionable", [True, False])
def test_seeded_encrypt_bit_identical_with_jax_noise(partitionable, derive):
    """The same coefficients and the same gaussian symbols (drawn through
    JAX's per-chunk keys) give the JAX package's seeded ciphertext."""
    jctx, tctx = _ctxs_l(256, 3, partitionable)
    rng = np.random.RandomState(11)
    coeffs = jref.rand_limbed_np(rng, jctx, (3,))
    key = jax.random.PRNGKey(4)
    with jax.threefry_partitionable(partitionable):
        sk, _ = jcipher.keygen(jctx, jax.random.PRNGKey(0))
        want = jcipher.encrypt_coeffs_seeded(jctx, sk, jnp.asarray(coeffs),
                                             key, a_seed=2 ** 40 + 3,
                                             derive=derive)
        e = _jax_seeded_noise(key, 3, jctx.n_poly)
    tsk = interop.keys_from_np({k: np.asarray(v) for k, v in sk.items()},
                               "cpu")
    got = tcipher.encrypt_coeffs_seeded_from_samples(
        tctx, tsk, interop.residues_from_np(coeffs, "cpu"),
        torch.from_numpy(e), 2 ** 40 + 3, derive=derive)
    np.testing.assert_array_equal(interop.residues_to_np(got.data),
                                  np.asarray(want.data))
    assert got.scale == want.scale


def test_seeded_encrypt_with_generator_decrypts():
    """The sampled seeded path: noise from a torch.Generator, c1 from the
    public stream; decrypts within the CKKS noise."""
    _, tctx = _ctxs(256)
    gen = torch.Generator().manual_seed(3)
    sk, _ = tcipher.keygen(tctx, gen)
    vals = torch.randn(2, tctx.slots, generator=gen)
    ct = tcipher.encrypt_values_seeded(tctx, sk, vals, gen, a_seed=9,
                                       derive=tcipher.DERIVE_CTR)
    assert torch.equal(ct.c1, tcipher.expand_a(tctx, 9, 2,
                                               tcipher.DERIVE_CTR))
    dec = tcipher.decrypt_values_np(tctx, sk, ct)
    assert np.abs(dec - vals.numpy()).max() < 1e-3


@pytest.mark.parametrize("l", [2, 3])
def test_rescale_drop_limbs_and_mul_plain_vec_bit_identical(l):
    jctx, tctx = _ctxs_l(256, l)
    rng = np.random.RandomState(12 + l)
    data = np.ascontiguousarray(
        jref.rand_limbed_np(rng, jctx, (2, 2)).transpose(0, 2, 1, 3))
    jct = jcipher.Ciphertext(data=jnp.asarray(data), scale=2.0 ** 24)
    tct = interop.ciphertext_from_np(data, 2.0 ** 24, "cpu")
    # jitted: the reference's eager rescale dispatches its unrolled NTT
    # stages op by op, seconds on the CPU
    jrescale = jax.jit(jcipher.rescale, static_argnums=0)
    jdrop = jax.jit(jcipher.drop_limbs, static_argnums=(0, 2))
    for j, t in ((jrescale(jctx, jct), tcipher.rescale(tctx, tct)),
                 (jdrop(jctx, jct, 1), tcipher.drop_limbs(tctx, tct, 1))):
        np.testing.assert_array_equal(interop.residues_to_np(t.data),
                                      np.asarray(j.data))
        assert t.scale == j.scale
    pt = jref.rand_limbed_np(rng, jctx, ())
    np.testing.assert_array_equal(
        interop.residues_to_np(tcipher.mul_plain_vec(
            tctx, tct, interop.residues_from_np(pt, "cpu")).data),
        np.asarray(jcipher.mul_plain_vec(jctx, jct, jnp.asarray(pt)).data))
    with pytest.raises(ValueError):
        tcipher.drop_limbs(tctx, tct, 0)
