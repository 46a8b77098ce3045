"""The port's threshold keys against the JAX package's, bit for bit.

Each `*_from_samples` body of `repro_torch.core.ckks.threshold` is fed the
draws that the JAX package's key schedule makes (the same splits and
fold_ins as `repro.core.ckks.threshold`), and must give the JAX function's
bits: the joint pk and shares of the additive keygen, partial decryptions,
their combination, Shamir shares, Lagrange coefficients and Shamir partial
decryptions.  Shares cross between the packages through `interop`.  The
round trips of `tests/test_ckks.py` run again on the port's own samplers,
and so does the key authorities' flow of `examples/threshold_fl.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ckks import cipher as jcipher
from repro.core.ckks import encoding as jenc
from repro.core.ckks import params as jparams
from repro.core.ckks import threshold as jthr

from repro_torch import interop
from repro_torch.core.ckks import cipher as tcipher
from repro_torch.core.ckks import encoding as tenc
from repro_torch.core.ckks import params as tparams
from repro_torch.core.ckks import threshold as tthr
from repro_torch.fl import KeyAuthority, ThresholdKeyAuthority
from repro_torch.kernels import ops as tops
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 256
N_PARTIES = 3
# the round trips' bound, as tests/test_ckks.py: the smudging noise
# (sigma 2**12 a party) is about 0.1 a slot at N = 256, delta = 2**20
ATOL = 0.5


@pytest.fixture(scope="module")
def ctxs():
    jctx = jparams.make_test_context(n_poly=N, n_limbs=2)
    tctx = tparams.make_test_context(n_poly=N, n_limbs=2, device="cpu")
    interop.check_context(tctx, jctx.primes, N, jctx.delta_bits)
    return jctx, tctx


def _t(arr):
    """Signed draws as an int32 tensor."""
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _ternary(key, shape):
    """cipher._ternary_residues' draw as symbols in {-1, 0, 1}."""
    return np.asarray(jax.random.randint(key, shape, 0, 3)) - 1


def _gaussian(key, shape, sigma):
    """cipher._gaussian_residues' draw as rounded gaussians."""
    return np.asarray(jnp.rint(float(sigma) * jax.random.normal(key, shape))
                      .astype(jnp.int32))


def _keygen_draws(jctx, key, n_parties):
    """threshold_keygen's key schedule (threshold.py:46-55)."""
    n = jctx.n_poly
    k_a, k_rest = jax.random.split(key)
    a = np.asarray(jcipher._uniform_residues(k_a, (n,), jctx.tables.qs))
    s, e = [], []
    for i in range(n_parties):
        k_s, k_e = jax.random.split(jax.random.fold_in(k_rest, i))
        s.append(_ternary(k_s, (n,)))
        e.append(_gaussian(k_e, (n,), jctx.error_sigma))
    return a, np.stack(s), np.stack(e)


def _eq(t, j):
    np.testing.assert_array_equal(interop.residues_to_np(t), np.asarray(j))


def _jax_ct(jctx, pk, b, seed):
    vals = np.random.RandomState(seed).randn(b, jctx.slots).astype(np.float32)
    ct = jcipher.encrypt_coeffs(jctx, pk, jnp.asarray(jenc.encode_np(vals,
                                                                     jctx)),
                                jax.random.PRNGKey(seed))
    return vals, ct


@pytest.fixture(scope="module")
def additive(ctxs):
    """JAX's 3-party keygen and a one-row ciphertext under its joint pk, and
    the port's keygen from the same draws."""
    jctx, tctx = ctxs
    key = jax.random.PRNGKey(9)
    jparties, jpk = jthr.threshold_keygen(jctx, key, N_PARTIES)
    a, s, e = _keygen_draws(jctx, key, N_PARTIES)
    tparties, tpk = tthr.threshold_keygen_from_samples(
        tctx, interop.residues_from_np(a, "cpu"), _t(s), _t(e))
    vals, jct = _jax_ct(jctx, jpk, 1, 10)
    tct = interop.ciphertext_from_np(np.asarray(jct.data), jct.scale, "cpu")
    return {"jparties": jparties, "jpk": jpk, "tparties": tparties,
            "tpk": tpk, "vals": vals, "jct": jct, "tct": tct}


def test_keygen_joint_pk_and_shares_equal_jax(additive):
    for k in ("pk0_mont", "pk1_mont"):
        _eq(additive["tpk"][k], additive["jpk"][k])
    assert [p.index for p in additive["tparties"]] == list(range(N_PARTIES))
    for tp, jp in zip(additive["tparties"], additive["jparties"]):
        _eq(tp.s_mont, jp.s_mont)


@pytest.mark.parametrize("sigma", [tthr.DEFAULT_SMUDGE_SIGMA, 0.0])
def test_partial_decrypt_and_combine_equal_jax(ctxs, additive, sigma):
    """Each party's partial from JAX's smudging draw, then the combine;
    the shares enter the port through interop."""
    jctx, tctx = ctxs
    jct, tct = additive["jct"], additive["tct"]
    shares = interop.threshold_parties_to_np(additive["tparties"])
    parties = interop.threshold_parties_from_np(shares, "cpu")
    jparts, tparts = [], []
    for i, (jp, tp) in enumerate(zip(additive["jparties"], parties)):
        key = jax.random.PRNGKey(30 + i)
        jparts.append(jthr.partial_decrypt(jctx, jp, jct, key, sigma))
        e = _gaussian(key, (jct.data.shape[0], N), sigma)
        tparts.append(tthr.partial_decrypt_from_samples(tctx, tp, tct,
                                                        _t(e)))
        _eq(tparts[-1], jparts[-1])
    _eq(tthr.combine_partials(tctx, tct, tparts),
        jthr.combine_partials(jctx, jct, jparts))


def test_zero_smudge_combine_is_the_joint_key_decrypt(ctxs, additive):
    """With no smudging, the combine is decryption under s = sum_i s_i:
    NTT-domain sums are exact mod q."""
    _, tctx = ctxs
    tct = additive["tct"]
    zero = torch.zeros((tct.data.shape[0], N), dtype=torch.int32)
    parts = [tthr.partial_decrypt_from_samples(tctx, p, tct, zero)
             for p in additive["tparties"]]
    s = additive["tparties"][0].s_mont
    for p in additive["tparties"][1:]:
        s = tops.mod_add(s, p.s_mont, tctx)
    assert torch.equal(tthr.combine_partials(tctx, tct, parts),
                       tcipher.decrypt_to_coeffs(tctx, {"s_mont": s}, tct))


def _shamir_coeff_draws(jctx, key, threshold):
    """shamir_share_secret's key schedule (threshold.py:97-99)."""
    return np.stack([np.asarray(jcipher._uniform_residues(
        k, (jctx.n_poly,), jctx.tables.qs))
        for k in jax.random.split(key, threshold - 1)])


@pytest.fixture(scope="module")
def shamir(ctxs):
    jctx, tctx = ctxs
    jsk, jpk = jcipher.keygen(jctx, jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(13)
    jparties = jthr.shamir_share_secret(jctx, jsk, key, n_parties=5,
                                        threshold=3)
    coeffs = interop.residues_from_np(_shamir_coeff_draws(jctx, key, 3),
                                      "cpu")
    tparties = tthr.shamir_share_secret_from_samples(
        tctx, interop.keys_from_np(jsk, "cpu"), list(coeffs), 5, 3)
    vals, jct = _jax_ct(jctx, jpk, 1, 14)
    tct = interop.ciphertext_from_np(np.asarray(jct.data), jct.scale, "cpu")
    return {"jparties": jparties, "tparties": tparties, "jsk": jsk,
            "vals": vals, "jct": jct, "tct": tct}


def test_shamir_shares_equal_jax(shamir):
    assert [p.index for p in shamir["tparties"]] == list(range(5))
    for tp, jp in zip(shamir["tparties"], shamir["jparties"]):
        _eq(tp.share, jp.share)


@pytest.mark.parametrize("active", [[0, 1], [0, 2, 4], [4, 1, 3],
                                    [0, 1, 2, 3, 4]])
def test_lagrange_at_zero_equals_jax_and_interpolates(ctxs, active):
    jctx, _ = ctxs
    for q in jctx.primes:
        lams = tthr._lagrange_at_zero(active, q)
        assert lams == jthr._lagrange_at_zero(active, q)
        # f = 7 + 5x + 3x^2 + 2x^3, cut below len(active) terms, is
        # recovered at 0
        coefs = [7, 5, 3, 2][: len(active)]
        f = [sum(c * pow(i + 1, k, q) for k, c in enumerate(coefs)) % q
             for i in active]
        assert sum(l * v for l, v in zip(lams, f)) % q == 7


@pytest.mark.parametrize("active", [[0, 2, 4], [3, 1, 0]])
def test_shamir_partial_decrypt_equals_jax(ctxs, shamir, active):
    """Each active party's Shamir partial from JAX's smudging draw, its
    share crossing through interop; the combined subset recovers the
    values."""
    jctx, tctx = ctxs
    jct, tct = shamir["jct"], shamir["tct"]
    parties = interop.shamir_parties_from_np(
        interop.shamir_parties_to_np(shamir["tparties"]), "cpu")
    tparts = []
    for i in active:
        key = jax.random.PRNGKey(50 + i)
        want = jthr.shamir_partial_decrypt(jctx, shamir["jparties"][i],
                                           active, jct, key)
        e = _gaussian(key, (jct.data.shape[0], N), tthr.DEFAULT_SMUDGE_SIGMA)
        tparts.append(tthr.shamir_partial_decrypt_from_samples(
            tctx, parties[i], active, tct, _t(e)))
        _eq(tparts[-1], want)
    out = tenc.decode_np(interop.residues_to_np(
        tthr.combine_partials(tctx, tct, tparts)), tctx, tct.scale)
    np.testing.assert_allclose(out, shamir["vals"], atol=ATOL)


# ---------------------------------------------------------------------------
# the round trips of tests/test_ckks.py, on the port's samplers
# ---------------------------------------------------------------------------


def _port_ct(tctx, pk, b, seed, gen):
    vals = np.random.RandomState(seed).randn(b, tctx.slots).astype(np.float32)
    m = interop.residues_from_np(tenc.encode_np(vals, tctx), "cpu")
    return vals, tcipher.encrypt_coeffs(tctx, pk, m, gen)


def _decode(tctx, coeffs, scale):
    return tenc.decode_np(interop.residues_to_np(coeffs), tctx, scale)


def test_additive_roundtrip(ctxs):
    _, tctx = ctxs
    gen = torch.Generator().manual_seed(9)
    parties, pk = tthr.threshold_keygen(tctx, gen, 3)
    vals, ct = _port_ct(tctx, pk, 2, 9, gen)
    partials = [tthr.partial_decrypt(tctx, p, ct, gen) for p in parties]
    out = _decode(tctx, tthr.combine_partials(tctx, ct, partials), ct.scale)
    np.testing.assert_allclose(out, vals, atol=ATOL)


def test_missing_party_fails(ctxs):
    _, tctx = ctxs
    gen = torch.Generator().manual_seed(11)
    parties, pk = tthr.threshold_keygen(tctx, gen, 3)
    vals, ct = _port_ct(tctx, pk, 1, 11, gen)
    partials = [tthr.partial_decrypt(tctx, p, ct, gen) for p in parties[:2]]
    out = _decode(tctx, tthr.combine_partials(tctx, ct, partials), ct.scale)
    assert np.abs(out - vals).max() > 1.0


def test_shamir_roundtrip(ctxs):
    _, tctx = ctxs
    gen = torch.Generator().manual_seed(13)
    sk, pk = tcipher.keygen(tctx, gen)
    parties = tthr.shamir_share_secret(tctx, sk, gen, n_parties=5,
                                       threshold=3)
    vals, ct = _port_ct(tctx, pk, 1, 13, gen)
    active = [0, 2, 4]
    partials = [tthr.shamir_partial_decrypt(tctx, parties[i], active, ct, gen)
                for i in active]
    out = _decode(tctx, tthr.combine_partials(tctx, ct, partials), ct.scale)
    np.testing.assert_allclose(out, vals, atol=ATOL)
    with pytest.raises(ValueError, match="coefficient polynomials"):
        tthr.shamir_share_secret_from_samples(tctx, sk, [], 5, 3)


# ---------------------------------------------------------------------------
# the key authorities (examples/threshold_fl.py's key flow)
# ---------------------------------------------------------------------------


def test_key_authority_on_a_cpu_context(ctxs):
    _, tctx = ctxs
    ka = KeyAuthority(tctx, seed=3)
    pk, sk = ka.client_keys()
    assert ka.public_context() is tctx
    want_sk, want_pk = tcipher.keygen(tctx, torch.Generator().manual_seed(3))
    assert torch.equal(sk["s_mont"], want_sk["s_mont"])
    assert all(torch.equal(pk[k], want_pk[k]) for k in want_pk)
    vals, ct = _port_ct(tctx, pk, 1, 4, torch.Generator().manual_seed(4))
    out = tcipher.decrypt_values_np(tctx, sk, ct)
    np.testing.assert_allclose(out, vals, atol=3e-3)


def test_threshold_key_authority_flow(ctxs):
    """Two parties: the authority's keys are threshold_keygen's from the
    seed, and its partials and combine decrypt a ciphertext under the
    joint pk."""
    _, tctx = ctxs
    ta = ThresholdKeyAuthority(2, tctx, seed=2)
    assert ta.n_parties == 2 and ta.party(1) is ta.parties[1]
    want, want_pk = tthr.threshold_keygen(
        tctx, torch.Generator().manual_seed(2), 2)
    assert all(torch.equal(ta.public_key()[k], want_pk[k]) for k in want_pk)
    assert all(torch.equal(p.s_mont, w.s_mont)
               for p, w in zip(ta.parties, want))
    gen = torch.Generator().manual_seed(3)
    vals, ct = _port_ct(tctx, ta.public_key(), 8, 0, gen)
    partials = [ta.partial_decrypt(i, ct, gen) for i in range(2)]
    out = _decode(tctx, ta.combine(ct, partials), ct.scale)
    np.testing.assert_allclose(out, vals, atol=ATOL)
