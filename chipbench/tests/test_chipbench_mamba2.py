"""The plain Mamba-2 reference (`reference/mamba2.py`) against the port's
smoke model on seeded weights, on the CPU: the loss, every leaf's
gradient, and one AdamW step.  Both sides compute in float32, so they
differ by the order of their float sums alone: the reference's SSD is the
paper's chunked listing at its own chunk (a whole 64-token sequence here;
the port's chunk is 8), its conv a `conv1d`.  Hence rtol 1e-5 on the loss,
a mean of 256 positions' cross-entropies, and 1e-4 on each gradient,
which also sums over the positions and passes back through both
layers."""
import math
import pathlib
import sys

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent / "src"))
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import batches  # noqa: E402
import inputs  # noqa: E402
import smoke_cells  # noqa: E402
from kinds import fl_train  # noqa: E402
from reference import mamba2 as ref  # noqa: E402

from repro_torch import models  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402,E501

SEED = 2 ** 33 + 17
CELL = {"name": "mamba2-370m.fl_train", "config": "mamba2-370m",
        "traffic": "fl_k3"}
TRAFFIC = smoke_cells.traffic("fl_k3")


@pytest.fixture(scope="module")
def setting():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = smoke_cells.config(CELL)
    port = fl_train.port_config(cfg)
    model = models.build_model(port, device="cpu")
    base = inputs.base_vector(cfg, SEED, "cpu")
    params = inputs.tree(cfg, base)
    b = batches.batch(SEED, 0, 0, 0, TRAFFIC["rows"], TRAFFIC["seq"],
                      cfg["vocab_size"])
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    yield cfg, port, model, params, batch
    torch.set_num_threads(n)


def test_the_smoke_model_is_small_and_float32(setting):
    cfg, port, _, params, _ = setting
    assert port.dtype == port.param_dtype == "float32" and not port.remat
    assert port.ssm_chunk < ref.CHUNK
    assert 0 < inputs.n_params(cfg) < 200_000


def test_loss_and_gradients_match_the_port(setting):
    cfg, port, model, params, batch = setting
    loss, grads = models.value_and_grad(model.loss_fn)(params, batch)
    mine = {p: t.detach().clone().requires_grad_()
            for p, t in fl_train.by_path(cfg, params).items()}
    with ref.exact_float32():
        want = ref.loss_sum(cfg, mine, batch["tokens"], batch["labels"],
                            TRAFFIC["seq"]) / batch["tokens"].numel()
        want.backward()
    assert math.isclose(float(loss), float(want.detach()), rel_tol=1e-5)
    got = fl_train.by_path(cfg, grads)
    for path, t in mine.items():
        g_ref = t.grad
        scale = float(g_ref.abs().max())
        assert scale > 0, path
        torch.testing.assert_close(got[path], g_ref, rtol=1e-4,
                                   atol=1e-4 * scale, msg=path)


def test_one_adamw_step_matches_the_port(setting):
    cfg, port, model, params, batch = setting
    opt = fl_train.adamw(TRAFFIC)
    _, grads = models.value_and_grad(model.loss_fn)(params, batch)
    new, _, _ = adamw_update(grads, adamw_init(params), params,
                             AdamWConfig(**opt))
    out = ref.train(cfg, fl_train.by_path(cfg, params),
                    [(batch["tokens"], batch["labels"])], **opt)
    got = fl_train.by_path(cfg, new)
    start = fl_train.by_path(cfg, params)
    diff_sq = ref_sq = 0.0
    for path, want in out["params"].items():
        d_ref = want - start[path]
        d_got = got[path] - start[path]
        diff_sq += float((d_got - d_ref).double().pow(2).sum())
        ref_sq += float(d_ref.double().pow(2).sum())
    # Adam's first step is lr * g / (|g| + eps): a sign almost everywhere,
    # so the two agree but where a gradient entry is round-off small
    assert ref_sq > 0 and math.sqrt(diff_sq / ref_sq) < 1e-3
    for path, norm in out["grad_norms"].items():
        assert math.isclose(float(grads_norm(grads, cfg, path, opt)), norm,
                            rel_tol=1e-4), path


def grads_norm(grads, cfg, path, opt):
    """The port's gradient of `path` as its optimizer takes it: clipped to
    the global norm."""
    leaves = fl_train.by_path(cfg, grads)
    total = math.sqrt(sum(float(g.double().pow(2).sum())
                          for g in leaves.values()))
    return leaves[path].double().norm() * min(1.0, opt["clip_norm"] / total)


def test_batches_are_the_seeds_alone():
    a = batches.batch(SEED, 1, 2, 0, 4, 8, 257)
    b = batches.batch(SEED, 1, 2, 0, 4, 8, 257)
    c = batches.batch(SEED, 1, 2, 1, 4, 8, 257)
    assert all((a[k] == b[k]).all() for k in a)
    assert not (a["tokens"] == c["tokens"]).all()
    assert (a["labels"][:, :-1] == a["tokens"][:, 1:]).all()
    assert a["tokens"].dtype.name == "int32" and a["tokens"].max() < 257
    s = batches.Stream(SEED, 2, 4, 8, 257)
    s.begin(1)
    assert (s.next_batch()["tokens"] == a["tokens"]).all()
    assert (s.next_batch()["tokens"] == c["tokens"]).all()


@pytest.mark.parametrize("key,value", [("vocab_size", 200),
                                       ("norm_epsilon", 1e-2)])
def test_the_reference_takes_its_constants_from_the_configuration(
        setting, key, value):
    """The reference's softmax span and RMSNorm epsilon are the
    configuration's: another value there gives another loss."""
    cfg, port, _, params, batch = setting
    mine = fl_train.by_path(cfg, params)
    labels = batch["labels"].clamp(max=199)
    with ref.exact_float32():
        a = ref.loss_sum(cfg, mine, batch["tokens"], labels, TRAFFIC["seq"])
        b = ref.loss_sum(dict(cfg, **{key: value}), mine, batch["tokens"],
                         labels, TRAFFIC["seq"])
    assert cfg["norm_epsilon"] == 1e-6 and cfg["vocab_size"] == port.vocab
    assert not math.isclose(float(a), float(b), rel_tol=1e-6)

