"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run on the CPU unless asked to."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.core.ckks import params as tparams
from repro_torch.fl import KeyAuthority, ThresholdKeyAuthority

ROOT = pathlib.Path(__file__).resolve().parent.parent

_CHECK = """
import importlib, pkgutil, sys
{imports}
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
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
