"""A run of each cell on the card, as the benchmark's command makes it:
a short window, then its result line. Marked `cuda`; skips without a
card (run on the GPU with `pytest -m cuda portbench/tests`)."""
import json
import subprocess
import sys

import pytest
import torch

from portbench import harness

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("the benchmark's cells need an NVIDIA GPU")


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_bench()["workloads"]])
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "4242424242", "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
