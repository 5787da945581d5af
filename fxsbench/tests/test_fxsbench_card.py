"""The benchmark's command on the card: one short run of each cell prints
the contract's result line. Skips without a CUDA device."""
import json
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]])
def test_a_cell_runs_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "fxsbench/run.py", "--workload",
                          cell, "--seed", "2718281828", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == {"restarts_per_hour", "peak_mem_gib",
                                 "setup_s"}
