"""The port stands alone: it imports neither JAX nor the JAX package (nor
the JAX package's `benchmarks`), and its entry points refuse to run on the
CPU unless asked to."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import selection as jselection

from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.core import selection as tselection
from repro_torch.core.ckks import params as tparams
from repro_torch.fl import KeyAuthority, ThresholdKeyAuthority

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent

_CHECK = """
import importlib, pkgutil, sys
{imports}
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro.")
             or m == "benchmarks" or m.startswith("benchmarks."))
sys.exit("imported: " + ", ".join(bad) if bad else 0)
"""

_ALL_SUBMODULES = """
import repro_torch
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
"""


def _run_clean(imports):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c",
                           _CHECK.format(imports=imports)],
                          cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_package_imports_no_jax_and_no_reference_package():
    _run_clean(_ALL_SUBMODULES)


def test_model_modules_import_no_jax_and_no_reference_package():
    _run_clean("import repro_torch.models, repro_torch.models.layers, "
               "repro_torch.models.moe, repro_torch.models.transformer, "
               "repro_torch.models.sharding, repro_torch.configs, "
               "repro_torch.optim, repro_torch.data, "
               "repro_torch.core.sensitivity, repro_torch.interop")


def test_serve_and_launch_modules_import_no_jax_and_no_reference_package():
    _run_clean("import repro_torch.serve, repro_torch.serve.faults, "
               "repro_torch.serve.sim, repro_torch.serve.service, "
               "repro_torch.launch.serve, repro_torch.launch.steps, "
               "repro_torch.launch.train")


def test_multicard_modules_import_no_jax_and_no_reference_package():
    _run_clean("import repro_torch.launch.dryrun, repro_torch.launch.mesh, "
               "repro_torch.launch.steps, repro_torch.models.sharding, "
               "repro_torch.models.moe, repro_torch.models.layers, "
               "repro_torch.models.transformer, repro_torch.models.mamba2, "
               "repro_torch.models.zamba2, tempfile\n"
               "from repro_torch.launch import dryrun\n"
               "with tempfile.TemporaryDirectory() as d:\n"
               "    dryrun.main(['--he-agg', '--mesh', 'single', '--out', d])")


def test_drivers_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the guard cannot trip")
    from repro_torch.launch import serve as tserve, train as ttrain
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--clients", "2", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--steps", "1"])


def test_chip_smoke_imports_no_jax_and_no_reference_package():
    _run_clean("sys.path.insert(0, '.')\nimport chip_smoke")


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the guard cannot trip")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparams.make_context(n_poly=256, delta_bits=20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparams.make_test_context()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparams.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KeyAuthority()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ThresholdKeyAuthority(2)
    assert tparams.make_test_context(device="cpu").device.type == "cpu"


def test_model_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the guard cannot trip")
    cfg = tconfigs.get_config("qwen1.5-0.5b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tselection.random_mask(0.3, 100, seed=1)
    model = tmodels.build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert all(t.device.type == "cpu" for t in
               tmodels.packing.tree_leaves(params))


@pytest.mark.parametrize("p,n,seed", [(0.3, 1000, 1), (0.0, 17, 0),
                                      (1.0, 17, 2), (0.05, 4099, 3)])
def test_random_mask_on_cpu_is_jax_mask(p, n, seed):
    got = tselection.random_mask(p, n, seed=seed, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.bool
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jselection.random_mask(p, n, seed=seed)))
