"""The port's drivers (launch.serve, launch.steps, launch.train) on the CPU.

  * launch.serve.main with --device cpu: a small fleet with wire faults
    prints the JAX driver's round and ledger lines (its keys differ, so
    the decrypted maxima are left out); a crash at after_seal exits 1
    and --resume finishes the rounds;
  * make_train_step on the smoke Qwen config (float32) against JAX's from
    the same parameters and batch, two steps: loss and grad norm to rtol
    1e-5 (tests/test_torch_models.py's loss tolerance), lr to rtol 1e-7,
    and the parameters and moments to rtol 1e-4 / atol 1e-3 x lr
    (tests/test_torch_fl.py's local-training tolerance: AdamW divides
    each gradient element by its running RMS, so an element whose float32
    sums differ by 1e-4 of its size moves its step by that share of lr);
    the specs of the batch, cache and AdamW state equal JAX's;
  * launch.train.main with --ckpt-dir: a run restarted from its
    --ckpt-every checkpoint reaches the uninterrupted run's parameters and
    losses bit for bit; with obs on, its steps, saves and resume open
    spans;
  * three reference faults the port does not copy: the reference's
    --smoke cannot be turned off (--no-smoke selects the full config
    here), its resumed run draws the stream from its first batch again,
    and it saves the last step twice when --steps is a multiple of
    --ckpt-every.
"""
import dataclasses
import os
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro import optim as joptim
from repro.data import synthetic as jsyn
from repro.launch import serve as jlaunch_serve
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import sharding as jsharding

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch import models as tmodels
from repro_torch import obs
from repro_torch import optim as toptim
from repro_torch.core import packing as tpacking
from repro_torch.launch import serve as tlaunch_serve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import sharding as tsharding

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL_LOSS, RTOL_LR = 1e-5, 1e-7
RTOL_PARAMS, ATOL_PARAMS_PER_LR = 1e-4, 1e-3
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}

# ---------------------------------------------------------------------------
# launch.serve
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--clients", "8", "--rounds", "2", "--fault", "3:garbage",
              "--fault", "5:drop"]


def _state_lines(out):
    """The driver's lines without the decrypted maxima and the wall time,
    which depend on its keys and its speed."""
    lines = []
    for line in out.strip().splitlines():
        line = line.split("  |decrypt|")[0]
        lines.append(re.sub(r"; [0-9.]+s wall$", "", line))
    return lines


def test_serve_driver_with_faults_prints_the_reference_lines(capsys,
                                                             monkeypatch):
    tlaunch_serve.main(SERVE_ARGS + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert "round 0: done (seal=explicit, accepted=8, folded=6, " \
           "fold-rejects=2, refolds=1)" in got
    monkeypatch.setattr(sys, "argv", ["serve"] + SERVE_ARGS)
    jlaunch_serve.main()
    want = capsys.readouterr().out
    assert _state_lines(got) == _state_lines(want)


def test_serve_driver_crash_exits_1_and_resume_finishes(tmp_path, capsys):
    args = ["--clients", "6", "--rounds", "1", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    with pytest.raises(SystemExit) as exc:
        tlaunch_serve.main(args + ["--crash-at", "after_seal"])
    assert exc.value.code == 1
    assert "simulated crash" in capsys.readouterr().out
    tlaunch_serve.main(args + ["--resume"])
    out = capsys.readouterr().out
    assert out.startswith(f"resumed from {tmp_path}: rounds [0]")
    assert "round 0: done (seal=explicit, accepted=6, folded=6, " \
           "fold-rejects=0, refolds=0)" in out
    assert "round 1: done" in out


# ---------------------------------------------------------------------------
# launch.steps
# ---------------------------------------------------------------------------


def _jit_call(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _qwen_smoke(pkg):
    return dataclasses.replace(pkg.get_config("qwen1.5-0.5b", smoke=True),
                               dtype="float32")


def _close(got, want, lr):
    for g, w in zip(tpacking.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=RTOL_PARAMS,
                                   atol=ATOL_PARAMS_PER_LR * lr)


def test_train_step_matches_jax():
    jm = jmodels.build_model(_qwen_smoke(jconfigs))
    jp = _jit_call(jm.init, jax.random.PRNGKey(0))
    p_np = jax.tree_util.tree_map(np.asarray, jp)
    jo = joptim.adamw_init(jp)
    opt = joptim.AdamWConfig(lr=1e-2)
    jstep = jax.jit(jsteps.make_train_step(jm, opt, warmup=1,
                                           total_steps=10))
    model = tmodels.build_model(_qwen_smoke(tconfigs), device="cpu")
    tp = interop.params_from_np(p_np, "cpu")
    to = toptim.adamw_init(tp)
    tstep = tsteps.make_train_step(model, toptim.AdamWConfig(lr=1e-2),
                                   warmup=1, total_steps=10)
    rng = np.random.RandomState(3)
    for _ in range(2):
        toks = rng.randint(0, 257, (2, 16)).astype(np.int32)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        jp, jo, jmet = jstep(jp, jo, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tp, to, tmet = tstep(tp, to, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        assert set(tmet) == {"loss", "grad_norm", "lr"}
        np.testing.assert_allclose(float(tmet["loss"]),
                                   float(jmet["loss"]), rtol=RTOL_LOSS)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=RTOL_LOSS)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                                   rtol=RTOL_LR)
        _close(tp, jp, 1e-2)
        _close(to["m"], jo["m"], 1e-2)
        assert int(to["step"]) == int(jo["step"])
    assert float(tmet["lr"]) > 0      # the second step moved the weights
    moved = sum(float((a - torch.tensor(b)).abs().sum()) for a, b in
                zip(tpacking.tree_leaves(tp),
                    jax.tree_util.tree_leaves(p_np)))
    assert moved > 0


def _spec_leaves(tree):
    """Spec tuples in JAX's leaf order (sorted keys, list order)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [s for t in tree for s in _spec_leaves(t)]
    return [tree]


def test_batch_cache_and_opt_specs_match_jax():
    batch = {"tokens": np.zeros((4, 8), np.int32),
             "labels": np.zeros((4, 8), np.int32),
             "scale": np.zeros((), np.float32)}
    cache = {"k": [np.zeros((4, 16, 2, 8))], "v": [np.zeros((4, 16, 2, 8))],
             "conv": np.zeros((4, 3, 12)), "ssm": np.zeros((4, 4, 8, 16)),
             "pos": np.zeros((4,), np.int32)}
    jcfg = jconfigs.get_config("mamba2-370m", smoke=True)
    tcfg = tconfigs.get_config("mamba2-370m", smoke=True)
    flat = lambda tree: [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    for kw in ({}, dict(data_size=2, model_size=2),
               dict(data_size=4, model_size=1)):
        jax_ax, t_ax = jsharding.AxisEnv(**kw), tsharding.AxisEnv(**kw)
        assert flat(jsteps.batch_specs(batch, jax_ax)) == \
            _spec_leaves(tsteps.batch_specs(batch, t_ax))
        for b in (1, 4):
            assert flat(jsteps.cache_specs(jcfg, cache, jax_ax, b)) == \
                _spec_leaves(tsteps.cache_specs(tcfg, cache, t_ax, b))
    pspecs = {"w": ("data", "model"), "b": ()}
    assert tsteps.opt_specs(pspecs) == {"m": pspecs, "v": pspecs,
                                        "step": ()}


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--device", "cpu", "--steps", "4", "--batch", "2", "--seq",
              "16", "--ckpt-every", "2", "--log-every", "1"]


def test_train_restart_reaches_the_uninterrupted_run(tmp_path, capsys):
    d1, d2 = str(tmp_path / "run1"), str(tmp_path / "run2")
    full = ttrain.main(TRAIN_ARGS + ["--ckpt-dir", d1])
    assert sorted(os.listdir(d1)) == ["step_00000001", "step_00000003"]
    capsys.readouterr()
    os.makedirs(d2)
    shutil.copytree(os.path.join(d1, "step_00000001"),
                    os.path.join(d2, "step_00000001"))
    resumed = ttrain.main(TRAIN_ARGS + ["--ckpt-dir", d2])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 1" and out[-1] == "done"
    assert [line.split()[1] for line in out[1:-1]] == ["2", "3"]
    assert resumed["start"] == 2 and sorted(resumed["losses"]) == [2, 3]
    for s in (2, 3):
        assert torch.equal(resumed["losses"][s], full["losses"][s])
    for a, b in zip(tpacking.tree_leaves(resumed["params"]) +
                    tpacking.tree_leaves(resumed["opt"]),
                    tpacking.tree_leaves(full["params"]) +
                    tpacking.tree_leaves(full["opt"])):
        assert torch.equal(a, b)
    # the restored state is the saved one, bit for bit
    like = {"p": full["params"], "o": full["opt"]}
    got_p, got_o, s = ttrain.restore(ttrain.CheckpointManager(d1),
                                     like["p"], like["o"], "cpu")
    assert s == 3
    for a, b in zip(tpacking.tree_leaves(got_p) + tpacking.tree_leaves(got_o),
                    tpacking.tree_leaves(full["params"]) +
                    tpacking.tree_leaves(full["opt"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("n_steps,saves", [(4, [1, 3]), (3, [1, 2])])
def test_train_saves_each_step_once_and_spans_when_obs_is_on(
        tmp_path, monkeypatch, n_steps, saves):
    """The reference saves the last step a second time when --steps is a
    multiple of --ckpt-every; the port saves it once.  With obs enabled
    every step, save and the resume opens its span."""
    saved = []
    save = ttrain.CheckpointManager.save

    def counted(self, step, tree, extra=None):
        saved.append(step)
        return save(self, step, tree, extra)
    monkeypatch.setattr(ttrain.CheckpointManager, "save", counted)
    argv = TRAIN_ARGS[:TRAIN_ARGS.index("--steps")] + [
        "--steps", str(n_steps)] + TRAIN_ARGS[TRAIN_ARGS.index("--batch"):]
    obs.configure(enabled=True, trace_path=None, reset=True)
    try:
        ttrain.main(argv + ["--ckpt-dir", str(tmp_path)])
        events = list(obs.get_tracer().events)
    finally:
        obs.configure(enabled=False, trace_path=None, reset=True)
    assert saved == saves
    spans = lambda name: [e["args"] for e in events if e["name"] == name]
    assert spans("train.step") == [{"step": i} for i in range(n_steps)]
    assert spans("train.checkpoint") == [{"step": i} for i in saves]
    assert spans("train.restore") == [{}]


def test_reference_resume_redraws_the_first_batches():
    """The reference's resumed run makes a fresh stream and trains step
    `start` on its first batch; the port skips the `start` batches the
    checkpoint has seen, so step `start` sees the uninterrupted run's
    batch."""
    prior = jsyn.dirichlet_partition(1, 257, alpha=100.0)[0]
    make = lambda: jsyn.SyntheticLM(vocab=257, seq_len=16, batch_size=2,
                                    client_prior=prior)
    uninterrupted = make()
    batches = [uninterrupted.next_batch()["tokens"] for _ in range(3)]
    assert not np.array_equal(make().next_batch()["tokens"], batches[2])
    skipped = make()
    for _ in range(2):
        skipped.next_batch()
    np.testing.assert_array_equal(skipped.next_batch()["tokens"], batches[2])


class _Picked(Exception):
    pass


def _smoke_choice(monkeypatch, module, main, argv):
    """The `smoke` flag `main` hands to configs.get_config."""
    def pick(arch, smoke=False):
        raise _Picked(smoke)
    monkeypatch.setattr(module.configs, "get_config", pick)
    with pytest.raises(_Picked) as exc:
        main(argv)
    return exc.value.args[0]


def test_no_smoke_selects_the_full_config(monkeypatch):
    """The reference's --smoke is store_true with default True: the full
    config cannot be chosen, and --no-smoke is refused.  The port's flag
    is a BooleanOptionalAction with the same default."""
    run_jax = lambda argv: (monkeypatch.setattr(sys, "argv",
                                                ["train"] + argv),
                            jtrain.main())
    assert _smoke_choice(monkeypatch, jtrain, run_jax, []) is True
    assert _smoke_choice(monkeypatch, jtrain, run_jax, ["--smoke"]) is True
    monkeypatch.setattr(sys, "argv", ["train", "--no-smoke"])
    with pytest.raises(SystemExit):
        jtrain.main()
    for argv, want in (([], True), (["--smoke"], True),
                       (["--no-smoke"], False)):
        assert _smoke_choice(monkeypatch, ttrain, ttrain.main,
                             argv + ["--device", "cpu"]) is want
    monkeypatch.undo()
    assert tconfigs.get_config("qwen1.5-0.5b", smoke=False).n_layers == 24
