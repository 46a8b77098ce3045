"""The port's checkpoint store: the JAX package's `tests/test_ckpt.py` cases
run again on `repro_torch.ckpt.store` (with torch leaves beside numpy ones),
and checkpoints cross between the packages: leaf names equal
`jax.tree_util.tree_flatten_with_path`'s, a tree either package writes the
other restores, and a `StreamIngest` checkpoint written by one package
resumes in the other to the uninterrupted aggregate bit for bit.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import store as jstore
from repro.core.ckks import params as jparams
from repro.wire import stream as jstream

from repro_torch import interop
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt import store
from repro_torch.core.ckks import cipher as tcipher
from repro_torch.core.ckks import params as tparams
from repro_torch.core.secure_agg import (AggregatorConfig,
                                         SelectiveHEAggregator)
from repro_torch.wire import compress as tcomp
from repro_torch.wire import stream as tstream
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def tree(seed=0):
    r = np.random.RandomState(seed)
    return {"acc": r.randint(0, 2**32 - 1, size=(3, 2, 8)).astype(np.uint32),
            "plain": torch.from_numpy(r.randn(5).astype(np.float32)),
            "nested": {"w": r.randn(2, 2).astype(np.float64)}}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_tree_equal(a, b):
    assert sorted(a) == sorted(b)
    np.testing.assert_array_equal(_np(a["acc"]), _np(b["acc"]))
    np.testing.assert_array_equal(_np(a["plain"]), _np(b["plain"]))
    np.testing.assert_array_equal(_np(a["nested"]["w"]),
                                  _np(b["nested"]["w"]))


# ---------------------------------------------------------------------------
# the JAX package's store tests, on the port's store
# ---------------------------------------------------------------------------


def test_save_restore_roundtrip_bitexact(tmp_path):
    t = tree()
    extra = {"round": 3, "weights": [0.25, 0.75]}
    store.save_checkpoint(str(tmp_path), 7, t, extra)
    out, step, x = store.restore_checkpoint(str(tmp_path), tree(1))
    assert step == 7 and x == extra
    assert_tree_equal(out, t)
    # dtypes survive (u32 residues must not round-trip through float), and
    # restore hands back numpy leaves
    assert out["acc"].dtype == np.uint32
    assert isinstance(out["plain"], np.ndarray)
    assert out["plain"].dtype == np.float32


def test_restore_absent_returns_nones(tmp_path):
    assert store.restore_checkpoint(str(tmp_path), tree()) == (None,) * 3
    assert store.latest_step(str(tmp_path)) is None
    assert store.latest_step(str(tmp_path / "never_made")) is None
    assert store.read_manifest(str(tmp_path)) is None


def test_rotation_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    for s in range(1, 8):
        mgr.save(s, tree(s), {"s": s})
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == [f"step_{s:08d}" for s in (5, 6, 7)]
    out, step, x = mgr.restore(tree())
    assert step == 7 and x == {"s": 7}
    assert_tree_equal(out, tree(7))


def test_partial_write_crash_leaves_latest_intact(tmp_path):
    """A writer killed mid-checkpoint leaves only a .tmp_ckpt_* dir; the
    next reader must see the previous complete checkpoint untouched."""
    store.save_checkpoint(str(tmp_path), 4, tree(4), {"ok": True})
    torn = tmp_path / ".tmp_ckpt_torn"
    torn.mkdir()
    (torn / "payload.npz").write_bytes(b"\x00partial")
    assert store.latest_step(str(tmp_path)) == 4
    out, step, x = store.restore_checkpoint(str(tmp_path), tree())
    assert step == 4 and x == {"ok": True}
    assert_tree_equal(out, tree(4))
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(5, tree(5))
    assert store.latest_step(str(tmp_path)) == 5


@pytest.mark.parametrize("stray", ["step_final", "step_", "step_3b",
                                   "step_00000009_old"])
def test_latest_step_ignores_non_integer_step_dirs(tmp_path, stray):
    store.save_checkpoint(str(tmp_path), 2, tree())
    (tmp_path / stray).mkdir()
    assert store.latest_step(str(tmp_path)) == 2
    out, step, _ = store.restore_checkpoint(str(tmp_path), tree())
    assert step == 2
    assert_tree_equal(out, tree())


def test_latest_step_ignores_step_named_files(tmp_path):
    store.save_checkpoint(str(tmp_path), 1, tree())
    (tmp_path / "step_00000099").write_text("not a dir")
    assert store.latest_step(str(tmp_path)) == 1


def test_read_manifest_latest_and_explicit(tmp_path):
    store.save_checkpoint(str(tmp_path), 1, tree(), {"r": 1})
    store.save_checkpoint(str(tmp_path), 2, tree(), {"r": 2})
    assert store.read_manifest(str(tmp_path))["extra"] == {"r": 2}
    m1 = store.read_manifest(str(tmp_path), step=1)
    assert m1["extra"] == {"r": 1} and m1["step"] == 1
    assert store.read_manifest(str(tmp_path), step=9) is None


def test_save_overwrites_same_step_atomically(tmp_path):
    store.save_checkpoint(str(tmp_path), 3, tree(0), {"v": "old"})
    store.save_checkpoint(str(tmp_path), 3, tree(1), {"v": "new"})
    out, step, x = store.restore_checkpoint(str(tmp_path), tree())
    assert step == 3 and x == {"v": "new"}
    assert_tree_equal(out, tree(1))
    assert os.listdir(tmp_path) == ["step_00000003"]


def test_manifest_is_plain_json(tmp_path):
    store.save_checkpoint(str(tmp_path), 5, tree(), {"round": 0})
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        m = json.load(f)
    assert m["step"] == 5 and m["extra"] == {"round": 0}
    assert sorted(m["names"]) == ["acc", "nested/w", "plain"]


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _mixed_tree():
    r = np.random.RandomState(7)
    return {"z": [r.randn(2).astype(np.float32),
                  (torch.arange(4, dtype=torch.int32), None)],
            "a": {"k2": np.uint32(9) * np.ones(3, np.uint32),
                  "k10": torch.ones(2, 2, dtype=torch.float64)},
            "m": None}


def test_names_and_order_equal_jax():
    t = _mixed_tree()
    names, leaves = store._flatten_with_names(t)
    jt = jax.tree_util.tree_map(_np, t)
    jnames, jleaves, _ = jstore._flatten_with_names(jt)
    assert names == jnames
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(_np(a), b)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trees_cross_between_packages(tmp_path, writer):
    t = _mixed_tree()
    jt = jax.tree_util.tree_map(_np, t)
    if writer == "port":
        store.save_checkpoint(str(tmp_path), 4, t, {"by": writer})
        out, step, extra = jstore.restore_checkpoint(str(tmp_path), jt)
    else:
        jstore.save_checkpoint(str(tmp_path), 4, jt, {"by": writer})
        out, step, extra = store.restore_checkpoint(str(tmp_path), t)
    assert step == 4 and extra == {"by": writer}
    assert out["m"] is None and out["z"][1][1] is None
    got = jax.tree_util.tree_leaves(out)
    want = jax.tree_util.tree_leaves(jt)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(a, b)


WEIGHTS = (0.2, 0.3, 0.5)


@pytest.fixture(scope="module")
def blobs():
    """Three port clients' seeded blobs, which both packages ingest."""
    tctx = tparams.make_test_context(device="cpu")
    gen = torch.Generator().manual_seed(5)
    sk, _ = tcipher.keygen(tctx, gen)
    model = {"w": torch.randn(30, 20, generator=gen),
             "b": torch.randn(40, generator=gen)}
    agg = SelectiveHEAggregator.build(tctx, model,
                                      torch.rand(640, generator=gen),
                                      AggregatorConfig(p_ratio=0.5))
    out = []
    for i in range(3):
        client = {k: v + 0.1 * i for k, v in model.items()}
        upd = agg.client_protect_seeded(client, sk, gen, a_seed=80 + i)
        out.append(tstream.pack_update_frames(
            upd, cid=i, n_samples=1, plain_codec="f16",
            seeded=tcomp.seed_compress(upd.ct, 80 + i)))
    jctx = jparams.make_test_context()
    interop.check_context(tctx, jctx.primes, jctx.n_poly, jctx.delta_bits)
    return tctx, jctx, out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stream_checkpoint_resumes_across_packages(tmp_path, blobs, writer):
    """One package ingests blob 0 and checkpoints its export_state; the
    other restores it, ingests blobs 1 and 2, and ends bit-identical to an
    uninterrupted JAX ingest."""
    tctx, jctx, bl = blobs
    ref = jstream.StreamIngest(jctx)
    for b, w in zip(bl, WEIGHTS):
        ref.ingest(b, w)
    want_arrays, want_meta = ref.export_state()
    like = {k: None for k in ("acc_ct", "acc_plain", "chunk_idx")}
    if writer == "jax":
        first = jstream.StreamIngest(jctx)
        first.ingest(bl[0], WEIGHTS[0])
        arrays, meta = first.export_state()
        jstore.save_checkpoint(str(tmp_path), 1, arrays, meta)
        mgr = CheckpointManager(str(tmp_path), keep=1)
        got, step, extra = mgr.restore({k: 0 for k in like})
        resumed = tstream.StreamIngest(tctx)
    else:
        first = tstream.StreamIngest(tctx)
        first.ingest(bl[0], WEIGHTS[0])
        arrays, meta = first.export_state()
        CheckpointManager(str(tmp_path), keep=1).save(1, arrays, meta)
        got, step, extra = jstore.restore_checkpoint(
            str(tmp_path), {k: 0 for k in like})
        resumed = jstream.StreamIngest(jctx)
    assert step == 1 and extra == meta
    resumed.restore_state(got, extra)
    for b, w in zip(bl[1:], WEIGHTS[1:]):
        resumed.ingest(b, w)
    arrays, meta = resumed.export_state()
    assert meta == want_meta
    for k, v in want_arrays.items():
        np.testing.assert_array_equal(np.asarray(arrays[k]).view(v.dtype), v)
    fin, want = resumed.finalize(), ref.finalize()
    data = fin.ct.data
    data = (interop.residues_to_np(data) if isinstance(data, torch.Tensor)
            else np.asarray(data))
    np.testing.assert_array_equal(data, np.asarray(want.ct.data))
    plain = fin.plain
    plain = plain.numpy() if isinstance(plain, torch.Tensor) else plain
    np.testing.assert_array_equal(np.asarray(plain).view(np.uint32),
                                  np.asarray(want.plain).view(np.uint32))
