"""The multi-card remainder of the port on the CPU: production meshes, model
placement by the sharding specs over DTensor, the MoE and attention
`local_map` paths, `steps.named`/`jit_*`, and `launch/dryrun`.

  * (a) with no ranks spawned: in a subprocess on the fake backend, every
    leaf's local shard shape on the (16, 16) and (2, 16, 16) production
    meshes equals the JAX package's spec arithmetic (`param_specs`,
    `opt_specs`, `batch_specs`, `cache_specs` with `AxisEnv(data=...,
    data_size=16|32, model_size=16)`) for all ten configs at full width and
    every shape `configs.shapes` runs;
  * (b) `make_production_mesh` raises at a world of 4 with the counts in
    its message, as JAX's does at 4 host devices, and has JAX's shape and
    axis names at 256 and 512 fake ranks;
  * (c) 4 gloo ranks on a (data 2, model 2) mesh (one spawn, a FileStore
    under tmp_path): for the dense (Qwen), MoE (granite-moe, the
    `local_map` path) and SSM (mamba2) smoke configs, two `jit_train_step`
    steps, `jit_prefill_step` and `jit_decode_step` against the port's
    unplaced steps and JAX's `jit_*` steps on its (2, 2) mesh of 4 host
    devices, from the same parameters and batches: loss and grad norm to
    rtol 1e-5, parameters and moments to rtol 1e-4 / atol 1e-3 x lr
    (tests/test_torch_launch.py), logits and caches to rtol 1e-5 / atol
    1e-6 (tests/test_torch_models.py).  Each rank's local shard shapes
    equal JAX's `NamedSharding(mesh, spec).shard_shape`, and each mesh axis
    shards at least one parameter;
  * (d) the dry-run CLI in a subprocess: one cell at a depth of one layer
    and `--he-agg`, their artifacts' keys, exact argument bytes and
    nonzero collective counts.
"""
import dataclasses
import functools
import json
import math
import os
import pathlib
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro import configs as jconfigs
from repro import models as jmodels
from repro import optim as joptim
from repro.configs import shapes as jshapes
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import sharding as jsharding

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch import models as tmodels
from repro_torch import optim as toptim
from repro_torch.core import packing as tpacking
from repro_torch.launch import steps as tsteps
from repro_torch.optim.schedule import cosine_lr
from repro_torch.models import sharding as tsharding

import _torch_multicard
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TESTS = pathlib.Path(__file__).resolve().parent

RTOL_LOSS = 1e-5
RTOL_PARAMS, ATOL_PARAMS_PER_LR = 1e-4, 1e-3
RTOL_LOGITS, ATOL_LOGITS = 1e-5, 1e-6
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
FAMILIES = {"dense": "qwen1.5-0.5b", "moe": "granite-moe-3b-a800m",
            "ssm": "mamba2-370m"}
B, S, CACHE_LEN, LR = 4, 16, 20, 1e-2
SPAWN_TIMEOUT_S = 400
AXIS_SIZES = {256: {"data": 16, "model": 16},
              512: {"pod": 2, "data": 16, "model": 16}}


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(TESTS)])
    return env


def _leaves(tree):
    """Leaves in JAX's order (sorted dict keys, list order); a tuple (a
    shape) is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _jax_specs(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _spec_shape(shape, spec, sizes):
    """A leaf's local shape under a spec: each dim over the product of
    the sizes of the axes its entry names."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        n = math.prod(sizes[a] for a in
                      (entry if isinstance(entry, tuple) else (entry,)))
        assert shape[i] % n == 0
        out[i] = shape[i] // n
    return tuple(out)


def _close(got, want, rtol, atol):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol)


# ---------------------------------------------------------------------------
# (a), (b): the production meshes on the fake backend
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fake_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("fake") / "report.pkl"
    code = ("import pickle, sys\n"
            "from _torch_multicard import fake_world_report\n"
            f"rep = fake_world_report({list(tconfigs.ARCHS)!r}, "
            f"{list(jshapes.SHAPES)!r})\n"
            f"pickle.dump(rep, open({str(out)!r}, 'wb'))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def test_production_mesh_raises_below_its_rank_count(fake_report):
    for multi, (shape, n) in ((False, ((16, 16), 256)),
                              (True, ((2, 16, 16), 512))):
        msg = fake_report[("error", multi)]
        assert f"mesh {shape} needs {n} ranks but only 4 exist" in msg
        assert "torchrun" in msg and "fake backend" in msg
    # the JAX package's own error at its 4 host devices
    with pytest.raises(RuntimeError, match=r"needs 256 devices but only 4"):
        jmesh.make_production_mesh()


def test_production_mesh_shape_and_axes(fake_report):
    assert fake_report[256]["mesh"] == ((16, 16), ("data", "model"))
    assert fake_report[512]["mesh"] == ((2, 16, 16),
                                        ("pod", "data", "model"))


@functools.lru_cache(maxsize=None)
def _abstract_params(arch):
    return jmodels.build_model(jconfigs.get_config(arch)).init_abstract()


@pytest.mark.parametrize("n_ranks", [256, 512])
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_full_width_local_shapes_match_jax_spec_arithmetic(
        fake_report, arch, n_ranks):
    sizes = AXIS_SIZES[n_ranks]
    data = ("pod", "data") if n_ranks == 512 else ("data",)
    ax = jsharding.AxisEnv(data=data, data_size=math.prod(
        sizes[a] for a in data), model_size=16)
    got = fake_report[n_ranks][arch]
    cfg = jconfigs.get_config(arch)
    jm = jmodels.build_model(cfg, ax)
    p_abs = _abstract_params(arch)
    pspecs = jsharding.param_specs(p_abs, ax)
    want = [_spec_shape(l.shape, s, sizes) for l, s in
            zip(jax.tree_util.tree_leaves(p_abs), _jax_specs(pspecs))]
    assert _leaves(got["params"]) == want
    ospecs = _jax_specs(jsteps.opt_specs(pspecs))
    o_abs = {"m": p_abs, "v": p_abs, "step": jax.ShapeDtypeStruct((),
                                                                  jnp.int32)}
    want = [_spec_shape(l.shape, s, sizes) for l, s in
            zip(jax.tree_util.tree_leaves(o_abs), ospecs)]
    assert _leaves(got["opt"]) == want
    sharded = {a for s in _jax_specs(pspecs) for e in s if e
               for a in (e if isinstance(e, tuple) else (e,))}
    assert sharded == set(sizes)           # every axis cuts some leaf
    for name, sp in jshapes.SHAPES.items():
        if not jshapes.runnable(cfg, name):
            assert name not in got
            continue
        if sp.kind == "decode":
            full = jshapes.input_specs(cfg, name, model=jm)
            batch, cache = {"tokens": full["tokens"]}, full["cache"]
            cspecs = _jax_specs(jsteps.cache_specs(cfg, cache, ax, sp.batch))
            want = [_spec_shape(l.shape, s, sizes) for l, s in
                    zip(jax.tree_util.tree_leaves(cache), cspecs)]
            assert _leaves(got[name]["cache"]) == want, name
        else:
            batch = jshapes.input_specs(cfg, name)
        bspecs = _jax_specs(jsteps.batch_specs(batch, ax))
        want = [_spec_shape(l.shape, s, sizes) for l, s in
                zip(jax.tree_util.tree_leaves(batch), bspecs)]
        assert _leaves(got[name]["batch"]) == want, name


# ---------------------------------------------------------------------------
# (c): 4 gloo ranks on a (data 2, model 2) mesh
# ---------------------------------------------------------------------------


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _inputs():
    """Per family: JAX's initial parameters, two batches, a prompt, a
    decode token and the prompt's cache (JAX's prefill, cache_len 20)."""
    out = {}
    rng = np.random.RandomState(0)
    for fam, arch in FAMILIES.items():
        cfg = jconfigs.get_config(arch, smoke=True)
        jm = jmodels.build_model(cfg)
        p = _np(_jit(jm.init, jax.random.PRNGKey(0)))
        toks = [rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
                for _ in range(2)]
        batches = [{"tokens": t, "labels": np.roll(t, -1, axis=1)}
                   for t in toks]
        prompt = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
        _, cache = _jit(lambda p, t: jm.prefill(p, {"tokens": t}, CACHE_LEN),
                        p, prompt)
        out[fam] = {"arch": arch, "params": p, "batches": batches,
                    "prompt": prompt, "cache": _np(cache),
                    "token": prompt[:, -1].copy(), "lr": LR}
    return out


def _jax_placed(mesh, inp):
    """JAX's jit_* steps on its (2, 2) host mesh, and the local shard
    shapes of their specs."""
    cfg = jconfigs.get_config(inp["arch"], smoke=True)
    res = {"train": []}
    with jax.sharding.set_mesh(mesh):
        ax = jsharding.axis_env_from_mesh(mesh)
        jm = jmodels.build_model(cfg, ax)
        p, o = inp["params"], _np(joptim.adamw_init(inp["params"]))
        step = jsteps.jit_train_step(jm, mesh, joptim.AdamWConfig(lr=LR),
                                     inp["batches"][0])
        compiled = step.lower(p, o, inp["batches"][0]).compile(FAST_COMPILE)
        for b in inp["batches"]:
            p, o, met = compiled(p, o, b)
            res["train"].append({k: float(v) for k, v in met.items()})
        res["params"], res["opt"] = _np(p), _np(o)
        prompt = {"tokens": inp["prompt"]}
        pre = jsteps.jit_prefill_step(jm, mesh, prompt)
        res["prefill"] = _np(pre.lower(inp["params"], prompt)
                             .compile(FAST_COMPILE)(inp["params"], prompt))
        tok = {"tokens": inp["token"]}
        dec = jsteps.jit_decode_step(jm, mesh, inp["cache"], tok, B)
        res["decode"] = _np(dec.lower(inp["params"], inp["cache"], tok)
                            .compile(FAST_COMPILE)(inp["params"],
                                                   inp["cache"], tok))
        pspecs = jm.param_specs()
        shape = lambda tree, specs: [
            NamedSharding(mesh, s).shard_shape(np.shape(l)) for l, s in
            zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec)))]
        res["shapes"] = {
            "params": shape(inp["params"], pspecs),
            "opt": shape(o, jsteps.opt_specs(pspecs)),
            "batch": shape(inp["batches"][0],
                           jsteps.batch_specs(inp["batches"][0], ax)),
            "cache": shape(inp["cache"], jsteps.cache_specs(
                cfg, inp["cache"], ax, B)),
        }
    return res


def _port_unplaced(fam, inp):
    """The port's unplaced steps.  The MoE routes each data shard's tokens
    on their own under a mesh (JAX's shard_map semantics: the capacity
    comes from the local token count, the aux loss is averaged over the
    shards), so its reference runs the unplaced loss and gradient on each
    half of the batch and averages them, then takes the same AdamW step,
    and its prefill and decode run each half and concatenate."""
    cfg = tconfigs.get_config(inp["arch"], smoke=True)
    model = tmodels.build_model(cfg, device="cpu")
    t = _torch_multicard._to_torch
    n_shards = 2 if fam == "moe" else 1
    halves = lambda tree: [_torch_multicard._map(
        lambda x: x if x.dim() == 0 else x.chunk(n_shards)[i], tree)
        for i in range(n_shards)]
    joined = lambda outs: _torch_multicard._map(
        lambda *xs: xs[0] if xs[0].dim() == 0 else torch.cat(xs), *outs)
    p = interop.params_from_np(inp["params"], "cpu")
    o = toptim.adamw_init(p)
    opt_cfg = toptim.AdamWConfig(lr=LR)
    loss_and_grad = tmodels.value_and_grad(model.loss_fn)
    res = {"train": []}
    for b in inp["batches"]:
        if n_shards == 1:
            p, o, met = tsteps.make_train_step(model, opt_cfg)(p, o, t(b))
        else:
            outs = [loss_and_grad(p, h) for h in halves(t(b))]
            loss = sum(l for l, _ in outs) / n_shards
            grads = tpacking.tree_map(lambda *g: sum(g) / n_shards,
                                      *[g for _, g in outs])
            lr = cosine_lr(o["step"], LR, 100, 10_000)
            p, o, gnorm = toptim.adamw_update(grads, o, p, opt_cfg, lr=lr)
            met = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        res["train"].append({k: float(v) for k, v in met.items()})
    res["params"], res["opt"] = p, o
    p0 = interop.params_from_np(inp["params"], "cpu")
    res["prefill"] = joined([model.prefill(p0, h) for h in halves(
        {"tokens": t(inp["prompt"])})])
    res["decode"] = joined([model.decode_step(p0, c, tok) for c, tok in zip(
        halves(t(inp["cache"])), halves({"tokens": t(inp["token"])}))])
    return res


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """One spawn of 4 gloo ranks; JAX's and the port's unplaced steps run
    in this process meanwhile."""
    work = tmp_path_factory.mktemp("gloo")
    inputs = _inputs()
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = torch.multiprocessing.start_processes(
        _torch_multicard.gloo_rank, args=(4, str(work)), nprocs=4,
        join=False, start_method="spawn")
    try:
        mesh = jmesh._make_mesh((2, 2), ("data", "model"), jax.devices()[:4])
        jax_res = {fam: _jax_placed(mesh, inp) for fam, inp in inputs.items()}
        port = {fam: _port_unplaced(fam, inp)
                for fam, inp in inputs.items()}
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "gloo ranks timed out"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    ranks = []
    for r in range(4):
        with open(work / f"out_{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return inputs, jax_res, port, ranks


@pytest.mark.parametrize("fam", FAMILIES)
def test_placed_train_steps_match_unplaced_and_jax(gloo_run, fam):
    _, jax_res, port, ranks = gloo_run
    got = ranks[0][fam]
    for ref in (port[fam], jax_res[fam]):
        for g, w in zip(got["train"], ref["train"]):
            assert set(g) == {"loss", "grad_norm", "lr"}
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL_LOSS)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=RTOL_LOSS)
            np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-7)
        _close(got["params"], ref["params"], RTOL_PARAMS,
               ATOL_PARAMS_PER_LR * LR)
        _close([got["opt"]["m"], got["opt"]["v"]],
               [ref["opt"]["m"], ref["opt"]["v"]], RTOL_PARAMS,
               ATOL_PARAMS_PER_LR * LR)
        assert int(got["opt"]["step"]) == int(ref["opt"]["step"]) == 2
    assert got["train"][1]["lr"] > 0      # the second step moved the weights


@pytest.mark.parametrize("fam", FAMILIES)
def test_placed_prefill_and_decode_match_unplaced_and_jax(gloo_run, fam):
    _, jax_res, port, ranks = gloo_run
    got = ranks[0][fam]
    for ref in (port[fam], jax_res[fam]):
        for kind in ("prefill", "decode"):
            logits, cache = got[kind]
            want_logits, want_cache = ref[kind]
            _close(logits, want_logits, RTOL_LOGITS, ATOL_LOGITS)
            _close(cache, want_cache, RTOL_LOGITS, ATOL_LOGITS)


@pytest.mark.parametrize("fam", FAMILIES)
def test_local_shard_shapes_match_jax_on_every_rank(gloo_run, fam):
    _, jax_res, _, ranks = gloo_run
    want = jax_res[fam]["shapes"]
    for rank in ranks:
        got = rank[fam]["shapes"]
        for key in ("params", "opt", "batch", "cache"):
            assert [tuple(s) for s in _leaves(got[key])] == \
                [tuple(s) for s in want[key]], key
    # each mesh axis cuts at least one parameter, on every rank
    for rank in ranks:
        assert rank[fam]["cut_dims"] == [0, 1]


# ---------------------------------------------------------------------------
# (d): the dry-run CLI
# ---------------------------------------------------------------------------


def _dryrun(out_dir, *args):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         str(out_dir), *args], cwd=str(ROOT), env=_env(),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


KEYS = {"arch", "shape", "mesh", "tag", "n_devices", "tokens", "kind",
        "memory", "collectives", "roofline"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
          "peak_hbm_bytes"}


DRYRUN_ARCH = "mamba2-370m"


def test_dryrun_cell_at_one_layer(tmp_path):
    out = _dryrun(tmp_path, "--arch", DRYRUN_ARCH, "--shape", "decode_32k",
                  "--mesh", "single", "--layers", "1")
    assert "done: 1 ok, 0 failed" in out
    art = json.loads((tmp_path / f"{DRYRUN_ARCH}_decode_32k_single__L1.json")
                     .read_text())
    assert KEYS <= set(art) and MEMORY <= set(art["memory"])
    assert art["n_devices"] == 256 and art["kind"] == "decode"
    # argument bytes by the spec arithmetic: parameters, cache and tokens
    cfg = dataclasses.replace(jconfigs.get_config(DRYRUN_ARCH), n_layers=1)
    sizes = AXIS_SIZES[256]
    ax = jsharding.AxisEnv(data_size=16, model_size=16)
    jm = jmodels.build_model(cfg, ax)
    full = jshapes.input_specs(cfg, "decode_32k", model=jm)
    sp = jshapes.SHAPES["decode_32k"]
    trees = [(jm.init_abstract(), jm.param_specs()),
             (full["cache"], jsteps.cache_specs(cfg, full["cache"], ax,
                                                sp.batch)),
             ({"tokens": full["tokens"]},
              jsteps.batch_specs({"tokens": full["tokens"]}, ax))]
    want = sum(math.prod(_spec_shape(l.shape, s, sizes)) * l.dtype.itemsize
               for tree, specs in trees
               for l, s in zip(jax.tree_util.tree_leaves(tree),
                               _jax_specs(specs)))
    assert art["memory"]["argument_bytes"] == want
    assert art["memory"]["peak_hbm_bytes"] >= want
    assert sum(art["collectives"]["counts"].values()) > 0
    assert art["roofline"]["flops"] > 0 and art["roofline"]["peaks"][
        "flops"] == 989e12


def test_dryrun_he_agg(tmp_path):
    _dryrun(tmp_path, "--he-agg", "--mesh", "single")
    art = json.loads((tmp_path / "qwen1.5-0.5b_he_agg_single.json")
                     .read_text())
    assert KEYS <= set(art) and MEMORY <= set(art["memory"])
    he = art["he"]
    assert he["n_chunks"] % 256 == 0 and he["n_plain"] % 256 == 0
    assert len(he["slot_in_bytes"]) == len(he["slot_out_bytes"]) == 256
    # the same layout arithmetic as the JAX package's HeAggSpec
    from repro.launch import fl_step as jfl
    jspec = jfl.HeAggSpec.for_model(
        jconfigs.get_config("qwen1.5-0.5b").param_count(), 0.1, 8, 256)
    assert (he["n_chunks"], he["n_plain"], he["wire_bytes_per_client"]) == (
        jspec.n_chunks, jspec.n_plain, jspec.wire_bytes_per_client())
