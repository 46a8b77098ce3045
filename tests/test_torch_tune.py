"""The port's autotuner (kernels/tune.py) and the NTT dispatch through it.

What the JAX package's tests/test_tune.py checks on the CPU, for the port:
shape keys and the config's JSON; the cache's save / load round trip; stale
entries (another platform, an unknown op, the JAX package's backend names, a
malformed config, a block_b or N no kernel runs) skipped one by one, so the
JAX package's own `tuning/cpu.json` loads nothing; a missing or unreadable
file; the generation counter; resolve's hit and miss; the candidate space
(the NTTs only: the other kernels are not tuned) and the roofline pruning,
inert in today's space and never pruning the default; a sweep on the CPU.
Then the dispatch: `ops.ntt_fwd` / `ntt_inv` with a forced "ntt4" entry
reach the plain 4-step version with the flat bits, and the Algorithm 1
round, single-device and on a (data 2, model 2) mesh of the CPU, gives the
same bits with every NTT forced onto the 4-step path.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core.ckks import cipher, params, sharded
from repro_torch.core.secure_agg import AggregatorConfig, SelectiveHEAggregator
from repro_torch.kernels import ntt, ops, ref, tune
from repro_torch.launch import mesh
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CFG4 = tune.KernelConfig(block_b=2, ntt4_split=(32, 8), radix=4)


@pytest.fixture(autouse=True)
def _empty_cache():
    """Every test starts and ends with an empty tuning cache."""
    tune.clear_cache()
    yield
    tune.clear_cache()


def _ctx(n=256, l=2):
    return params.make_test_context(n_poly=n, n_limbs=l, device="cpu")


def _x(ctx, b, seed=0):
    rng = np.random.RandomState(seed)
    return interop.residues_from_np(
        np.stack([rng.randint(0, q, (b, ctx.n_poly)) for q in ctx.primes],
                 axis=-2).astype(np.uint32), "cpu")


# ---------------------------------------------------------------------------
# keys, configs and the cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [tune.KernelConfig(block_b=1), CFG4,
                                 tune.KernelConfig(block_b=4,
                                                   ntt4_split=(64, 128))])
def test_shape_key_and_config_json(cfg):
    assert tune.shape_key("ntt_fwd", 8192, 2, 11328, "cuda") == \
        "ntt_fwd|N8192|L2|B11328|cuda"
    doc = json.loads(json.dumps(cfg.to_json()))
    assert tune.KernelConfig.from_json(doc) == cfg
    assert tune.default_config("ntt_inv") == tune.KernelConfig(block_b=1)


def test_cache_round_trip(tmp_path):
    tune.put("ntt_fwd", 256, 2, 5, "cpu", "ntt4", CFG4, tuned_ms=1.0,
             default_ms=2.0)
    tune.put("ntt_inv", 256, 2, 5, "cpu", "flat",
             tune.default_config("ntt_inv"))
    path = tmp_path / "cache.json"
    tune.save_cache(str(path))
    tune.clear_cache()
    assert tune.resolve("ntt_fwd", 256, 2, 5, "cpu") == \
        ("flat", tune.default_config("ntt_fwd"))
    assert tune.load_cache(str(path), "cpu") == 2
    assert tune.resolve("ntt_fwd", 256, 2, 5, "cpu") == ("ntt4", CFG4)
    assert tune.resolve("ntt_inv", 256, 2, 5, "cpu") == \
        ("flat", tune.default_config("ntt_inv"))
    doc = json.loads(path.read_text())
    assert doc["version"] == tune.CACHE_VERSION
    assert doc["meta"]["platform"] == tune.default_platform()
    assert doc["entries"]["ntt_fwd|N256|L2|B5|cpu"]["tuned_ms"] == 1.0
    assert tune.provenance() == {"generation": tune.generation(),
                                 "cache_path": str(path), "entries": 2}


STALE = {
    "another platform": ("ntt_fwd|N256|L2|B5|tpu", "ntt4", CFG4.to_json()),
    "unknown op": ("no_such_op|N256|L2|B5|cpu", "flat", {"block_b": 1}),
    "JAX backend ref": ("ntt_fwd|N256|L2|B5|cpu", "ref", {"block_b": 8}),
    "JAX backend pallas": ("ntt_fwd|N256|L2|B5|cpu", "pallas",
                           {"block_b": 8}),
    "JAX backend pallas4": ("ntt_fwd|N256|L2|B5|cpu", "pallas4",
                            CFG4.to_json()),
    "ntt4 for mul_add": ("mul_add|N256|L2|B5|cpu", "ntt4", CFG4.to_json()),
    "malformed block_b": ("ntt_fwd|N256|L2|B5|cpu", "ntt4",
                          {"block_b": "huge"}),
    "missing block_b": ("ntt_fwd|N256|L2|B5|cpu", "ntt4", {"radix": 4}),
    "bad radix": ("ntt_fwd|N256|L2|B5|cpu", "ntt4",
                  {"block_b": 1, "ntt4_split": [32, 8], "radix": 8}),
    "split not of N": ("ntt_fwd|N256|L2|B5|cpu", "ntt4",
                       {"block_b": 1, "ntt4_split": [16, 8]}),
    "block_b over ntt.MAX_BLOCK_B": ("ntt_fwd|N256|L2|B5|cpu", "ntt4",
                                     {"block_b": 16}),
    "N over the kernels' 2**14": ("ntt_fwd|N32768|L2|B5|cpu", "ntt4",
                                  {"block_b": 1, "ntt4_split": [128, 256]}),
    "malformed key": ("ntt_fwd|N256|cpu", "ntt4", CFG4.to_json()),
}


@pytest.mark.parametrize("kind", sorted(STALE))
def test_stale_entry_skipped_alone(tmp_path, kind):
    """The stale entry loads as no entry; the good one beside it loads."""
    key, backend, config = STALE[kind]
    doc = {"version": tune.CACHE_VERSION, "entries": {
        "ntt_inv|N256|L2|B3|cpu": {"backend": "ntt4",
                                   "config": CFG4.to_json()},
        key: {"backend": backend, "config": config}}}
    path = tmp_path / "stale.json"
    path.write_text(json.dumps(doc))
    assert tune.load_cache(str(path), "cpu") == 1
    assert tune.resolve("ntt_inv", 256, 2, 3, "cpu") == ("ntt4", CFG4)
    assert tune.resolve("ntt_fwd", 256, 2, 5, "cpu")[0] == "flat"
    assert tune.resolve("ntt_fwd", 8192, 2, 11328, "cpu")[0] == "flat"


def test_jax_cache_steers_nothing():
    """The JAX package's tuning/cpu.json names only JAX backends: 0
    entries, and the file is only read."""
    path = REPO / "tuning" / "cpu.json"
    before = path.read_bytes()
    assert tune.load_cache(str(path), "cpu") == 0
    assert tune.n_entries() == 0
    assert path.read_bytes() == before


def test_missing_and_unreadable_files_load_empty(tmp_path):
    tune.put("ntt_fwd", 256, 2, 5, "cpu", "ntt4", CFG4)
    assert tune.load_cache(str(tmp_path / "absent.json"), "cpu") == 0
    assert tune.n_entries() == 0
    garbage = tmp_path / "garbage.json"
    garbage.write_text("{not json")
    with pytest.warns(RuntimeWarning, match="could not be loaded"):
        assert tune.load_cache(str(garbage), "cpu") == 0
    garbage.write_text("[1, 2]")
    with pytest.warns(RuntimeWarning):
        assert tune.load_cache(str(garbage), "cpu") == 0


def test_generation_bumps_on_put_load_and_clear(tmp_path):
    g0 = tune.generation()
    tune.put("ntt_fwd", 256, 2, 5, "cpu", "ntt4", CFG4)
    g1 = tune.generation()
    tune.load_cache(str(tmp_path / "absent.json"), "cpu")
    g2 = tune.generation()
    tune.clear_cache()
    assert g0 < g1 < g2 < tune.generation()


def test_resolve_hit_and_miss():
    tune.put("ntt_inv", 8192, 2, 11328, "cuda", "ntt4", tune.KernelConfig(
        block_b=4, ntt4_split=(128, 64), radix=2))
    assert tune.resolve("ntt_inv", 8192, 2, 11328, "cuda")[1].ntt4_split == \
        (128, 64)
    for miss in (("ntt_inv", 8192, 2, 11328, "cpu"),
                 ("ntt_inv", 8192, 2, 11327, "cuda"),
                 ("ntt_fwd", 8192, 2, 11328, "cuda")):
        assert tune.resolve(*miss) == ("flat", tune.KernelConfig(block_b=1))


def test_put_refuses_what_no_kernel_runs():
    with pytest.raises(ValueError):
        tune.put("ntt_fwd", 256, 2, 5, "cpu", "pallas4", CFG4)
    with pytest.raises(ValueError):
        tune.put("weighted_sum", 256, 2, 5, "cpu", "ntt4", CFG4)
    with pytest.raises(ValueError):
        tune.put("ntt_fwd", 512, 2, 5, "cpu", "ntt4", CFG4)
    with pytest.raises(ValueError, match="bad config"):
        tune.put("ntt_fwd", 256, 2, 5, "cpu", "ntt4",
                 tune.KernelConfig(block_b=ntt.MAX_BLOCK_B + 1))
    # the kernels' padded shared row exists up to N = 2**14; block_b no
    # longer grows it
    tune.put("ntt_inv", 16384, 2, 5, "cpu", "ntt4",
             tune.KernelConfig(block_b=4))
    assert ntt.smem_bytes(8192) == 33_788 and ntt.smem_bytes(32) == 0
    # the 4-step's row plus its shared psi1 / psi2 copy (ntt4.cu)
    assert ntt.smem_bytes(8192, (32, 256)) == 33_788 + 1_184
    assert ntt.smem_bytes(4, (2, 2)) == 4 * 35
    assert ntt.smem_bytes(16384) == 67_580 <= ntt.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="beyond"):
        tune.put("ntt_inv", 32768, 2, 5, "cpu", "ntt4",
                 tune.KernelConfig(block_b=1, ntt4_split=(128, 256)))


# ---------------------------------------------------------------------------
# candidates, pruning, the sweep
# ---------------------------------------------------------------------------


def test_candidates_at_full_width():
    """The flat kernel and the 4-step kernel at each candidate split: the
    split is the only field that changes a launch (radix and block_b name
    the same kernel), so each candidate is a different launch."""
    cands = tune.candidates("ntt_fwd", 8192, 2, 11328)
    assert len(cands) == 4 and len(set(cands)) == 4
    assert cands[0] == tune.Candidate("flat", tune.KernelConfig(block_b=1))
    assert [c.config for c in cands[1:]] == [
        tune.KernelConfig(block_b=1, ntt4_split=split, radix=2)
        for split in ((32, 256), (64, 128), (128, 64))]
    assert all(c.backend == "ntt4" for c in cands[1:])
    # the same space at every batch and up to N = 16384
    for op, n, b in (("ntt_inv", 8192, 1), ("ntt_fwd", 16384, 100),
                     ("ntt_fwd", 4, 1)):
        got = tune.candidates(op, n, 2, b)
        assert [c.config.ntt4_split for c in got[1:]] == \
            list(params.ntt4_split_candidates(n))


@pytest.mark.parametrize("op", ["mul_add", "mod_lift", "weighted_sum",
                                "weighted_accum", "weighted_accum_chunks"])
def test_kernels_without_a_geometry_are_not_tuned(op, tmp_path):
    """The other five kernels have no geometry parameter: the tuner knows
    no such op, and a cache entry for one loads as stale."""
    ctx = _ctx()
    with pytest.raises(ValueError, match="unknown op"):
        tune.candidates(op, 256, 2, 4)
    with pytest.raises(ValueError, match="unknown op"):
        tune.put(op, 256, 2, 4, "cpu", "flat", tune.KernelConfig(block_b=1))
    with pytest.raises(ValueError, match="unknown op"):
        tune.sweep_op(op, ctx, 4, torch.Generator().manual_seed(1), reps=1)
    with pytest.raises(ValueError, match="no 'flat' kernel"):
        ops.run_config(op, "flat", tune.KernelConfig(block_b=1),
                       ctx.device_tables, _x(ctx, 4))
    path = tmp_path / "other.json"
    path.write_text(json.dumps({"entries": {
        f"{op}|N256|L2|B4|cpu": {"backend": "flat",
                                 "config": {"block_b": 1}}}}))
    assert tune.load_cache(str(path), "cpu") == 0


def test_model_orders_and_pruning_never_drops_the_default(monkeypatch):
    n, l, b = 8192, 2, 11328
    cands = tune.candidates("ntt_fwd", n, l, b)
    est = {c: tune._model_time_s(n, l, b, c) for c in cands}
    # both kernels' three register passes, the 4-step's plus its corr
    # read, in memory times (tune's docstring); every split alike
    mem = 8 * b * l * n / tune.HBM_BYTES_PER_S
    ratio = [(est[c] - tune.LAUNCH_OVERHEAD_S) / mem for c in cands]
    assert ratio == pytest.approx([1.375, 1.875, 1.875, 1.875])
    # today's space is inside the ratio: the pruning is inert
    assert max(est.values()) < 1.4 * min(est.values()) < \
        tune.PRUNE_RATIO * min(est.values())
    ctx = _ctx()
    full = tune.sweep_op("ntt_fwd", ctx, 4, torch.Generator().manual_seed(0),
                         reps=1)
    assert full.n_pruned == 0 and len(full.times_ms) == full.n_candidates
    # with a ratio that keeps only the best modelled candidates, the
    # default is measured all the same
    monkeypatch.setattr(tune, "PRUNE_RATIO", 1.0)
    res = tune.sweep_op("ntt_fwd", ctx, 4, torch.Generator().manual_seed(0),
                        reps=1)
    assert res.n_pruned > 0
    assert tune.candidates("ntt_fwd", 256, 2, 4)[0] in res.times_ms
    assert res.tuned_ms <= res.default_ms


@pytest.mark.parametrize("op", tune.OPS)
def test_sweep_on_cpu_records_its_winner(op):
    ctx = _ctx()
    res = tune.sweep_op(op, ctx, 4, torch.Generator().manual_seed(1),
                        reps=1)
    assert (res.op, res.n, res.l, res.b, res.platform) == \
        (op, 256, 2, 4, "cpu")
    assert res.tuned_ms <= res.default_ms
    assert res.n_candidates == 4
    assert tune.resolve(op, 256, 2, 4, "cpu") == \
        (res.winner.backend, res.winner.config)
    row = res.to_row()
    assert row["candidates"] == res.n_candidates and row["pruned"] == 0


# ---------------------------------------------------------------------------
# the dispatch through the cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["ntt_fwd", "ntt_inv"])
def test_forced_entry_reaches_the_plain_4step_version(monkeypatch, op):
    ctx = _ctx()
    x = _x(ctx, 5)
    want = getattr(ops, op)(x, ctx)
    calls = []
    name = op.replace("ntt_", "ntt4_") + "_fused"
    real = getattr(ref, name)

    def spy(*args, **kw):
        calls.append(args[1].shape[-1])           # n1
        return real(*args, **kw)

    monkeypatch.setattr(ref, name, spy)
    tune.put(op, 256, 2, 5, "cpu", "ntt4", CFG4)
    assert torch.equal(getattr(ops, op)(x, ctx), want)
    assert calls == [32]
    # another batch size is another key: the flat path
    getattr(ops, op)(x[:4], ctx)
    assert calls == [32]


def test_run_config_takes_tables_at_the_configs_split():
    ctx = _ctx()
    x = _x(ctx, 3, seed=4)
    want = ops.run_config("ntt_fwd", "flat", tune.KernelConfig(1),
                          ctx.device_tables, x)
    for split in params.ntt4_split_candidates(256):
        cfg = tune.KernelConfig(block_b=1, ntt4_split=split, radix=4)
        assert torch.equal(ops.run_config("ntt_fwd", "ntt4", cfg,
                                          ctx.split_device_tables(split),
                                          x), want)
        if split != params.ntt4_split(256):
            with pytest.raises(ValueError, match="not at the split"):
                ops.run_config("ntt_fwd", "ntt4", cfg, ctx.device_tables, x)
    with pytest.raises(ValueError, match="no 'ntt4' kernel"):
        ops.run_config("mul_add", "ntt4", CFG4, ctx.device_tables, x)


def _record_ntt_keys(monkeypatch):
    """Spy on tune.resolve: the NTT dispatches' keys, in order."""
    keys = []
    real = tune.resolve

    def spy(op, n, l, b, platform):
        keys.append((op, n, l, b, platform))
        return real(op, n, l, b, platform)

    monkeypatch.setattr(tune, "resolve", spy)
    return keys


def _force_ntt4(keys):
    """An ntt4 entry for every key, cycling through every config a cache
    may name at N=256: 3 splits x radix {2, 4} x block_b {1, 2, 4} (the
    plain version groups its stages by radix)."""
    geos = [tune.KernelConfig(block_b=blk, ntt4_split=split, radix=radix)
            for split in params.ntt4_split_candidates(256)
            for radix in tune.RADICES for blk in (1, 2, 4)]
    for i, key in enumerate(sorted(set(keys))):
        tune.put(*key, "ntt4", geos[i % len(geos)])


def _count_flat(monkeypatch):
    counts = {"flat": 0}
    for name in ("ntt_fwd_fused", "ntt_inv_fused"):
        real = getattr(ntt, name)

        def spy(*args, real=real, **kw):
            counts["flat"] += 1
            return real(*args, **kw)

        monkeypatch.setattr(ntt, name, spy)
    return counts


def _round(ctx, eng=None):
    """The Algorithm 1 round at N=256: keygen, two public-key clients and a
    seeded one, server_aggregate, client_recover."""
    rng = np.random.RandomState(3)
    w = {"w": torch.from_numpy(rng.randn(700).astype(np.float32))}
    agg = SelectiveHEAggregator.build(
        ctx, w, torch.from_numpy(np.abs(rng.randn(700))),
        AggregatorConfig(p_ratio=0.9))
    sk, pk = cipher.keygen(ctx, torch.Generator().manual_seed(2))
    ups = []
    for i in range(3):
        p = {"w": w["w"] + 0.1 * i}
        g = torch.Generator().manual_seed(20 + i)
        ups.append(agg.client_protect_seeded(p, sk, g, 60 + i, sharded=eng)
                   if i == 2 else agg.client_protect(p, pk, g, sharded=eng))
    glob = agg.server_aggregate(ups, [0.2, 0.3, 0.5], sharded=eng)
    return {"sk": sk["s_mont"], "pk0": pk["pk0_mont"], "pk1": pk["pk1_mont"],
            "cts": [u.ct.data for u in ups], "aggregate": glob.ct.data,
            "recovered": agg.client_recover(glob, sk, sharded=eng)}


def _same(got, want):
    for k, v in want.items():
        if k == "cts":
            for a, b in zip(got[k], v):
                assert (a.equals(b) if hasattr(a, "equals")
                        else torch.equal(a, b)), k
        elif hasattr(got[k], "equals"):
            assert got[k].equals(v), k
        else:
            assert torch.equal(got[k], v), k


def test_round_with_every_ntt_forced_to_ntt4(monkeypatch):
    ctx = _ctx()
    keys = _record_ntt_keys(monkeypatch)
    want = _round(ctx)
    assert {k[0] for k in keys} == {"ntt_fwd", "ntt_inv"}
    _force_ntt4(keys)
    flat = _count_flat(monkeypatch)
    _same(_round(ctx), want)
    assert flat["flat"] == 0


def test_sharded_round_with_every_ntt_forced_to_ntt4(monkeypatch):
    """ShardedHe on a (data 2, model 2) mesh of the CPU, each block resolving
    its own shape, against the single-device flat round."""
    ctx = _ctx()
    eng = sharded.ShardedHe(ctx, mesh.HeMesh(((CPU, CPU), (CPU, CPU))))
    want = _round(ctx)
    keys = _record_ntt_keys(monkeypatch)
    _same(_round(ctx, eng), want)
    assert any(k[2] == 1 for k in keys)           # one limb a block
    _force_ntt4(keys)
    flat = _count_flat(monkeypatch)
    _same(_round(ctx, eng), want)
    assert flat["flat"] == 0
