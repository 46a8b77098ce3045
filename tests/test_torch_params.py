"""The port's CKKS parameters against the JAX package: the same primes and
the same per-limb tables, and the same bits once on the device."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.ckks import params as jparams

from repro_torch.core.ckks import params as tparams

import gold
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SPECS = [dict(n_poly=8192, n_limbs=2, delta_bits=26)] + [
    dict(spec) for _, spec in sorted(gold.KAT_CONTEXTS.items())]


@pytest.mark.parametrize("spec", SPECS,
                         ids=lambda s: f"n{s['n_poly']}_l{s['n_limbs']}")
def test_primes_and_tables_equal_reference(spec):
    jctx = jparams.make_context(**spec)
    tctx = tparams.make_context(**spec, device="cpu")
    assert tctx.primes == jctx.primes
    assert (tctx.slots, tctx.delta, tctx.big_q) == (jctx.slots, jctx.delta,
                                                     jctx.big_q)
    for f in dataclasses.fields(tparams.LimbTables):
        want = getattr(jctx.tables, f.name)
        got = getattr(tctx.tables, f.name)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want, err_msg=f.name)
        dev = getattr(tctx.device_tables, f.name)
        assert dev.dtype == torch.int32
        np.testing.assert_array_equal(dev.numpy().view(np.uint32), want,
                                      err_msg=f.name)
    for jl, tl in zip(jctx.limbs, tctx.limbs):
        assert (tl.q, tl.qinv_neg, tl.r2, tl.one_mont) == \
            (jl.q, jl.qinv_neg, jl.r2, jl.one_mont)


def test_take_slices_like_reference():
    jt = jparams.make_context(n_poly=256, n_limbs=3, delta_bits=12).tables
    tctx = tparams.make_context(n_poly=256, n_limbs=3, delta_bits=12,
                                device="cpu")
    for l in (1, 2, 3):
        np.testing.assert_array_equal(tctx.tables.take(l).psi_rev_mont,
                                      jt.take(l).psi_rev_mont)
        assert tctx.device_tables.take(l).qs.shape == (l,)
    with pytest.raises(ValueError):
        tctx.tables.take(4)


def test_size_model_matches_reference():
    jctx = jparams.make_context()
    tctx = tparams.make_context(device="cpu")
    for packed in (True, False):
        assert tctx.ciphertext_bytes(packed) == jctx.ciphertext_bytes(packed)
    assert tctx.num_ciphertexts(46_398_771) == \
        jctx.num_ciphertexts(46_398_771) == 11_328
    with pytest.raises(ValueError, match="headroom"):
        tparams.make_context(n_poly=256, n_limbs=1, delta_bits=20,
                             device="cpu")
