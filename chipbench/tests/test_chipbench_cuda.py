"""On a card: one short run of a cell through the command line, its result
line as the contract wants it.  Skips without a card (decided inside the
test, never at import)."""
import json
import pathlib
import subprocess
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.cuda
def test_a_short_run_prints_a_correct_result():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "mamba2-370m.sim", "--seed", str(2 ** 31 + 11), "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert {"round_s", "round_p95_s", "setup_s"} == set(line["metrics"])
    assert line["device"]["platform"] == "gpu"


def test_without_a_card_the_run_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "mamba2-370m.sim", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300,
        cwd=BENCH.parent)
    assert out.returncode != 0 and out.stdout.strip() == ""
