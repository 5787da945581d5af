"""Fixtures of the benchmark's CPU tests: a copy of the benchmark under a
temporary root with a tiny configuration and cell added as data only."""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = "tiny.batch2"
# the tiny cell's limits, set from its CPU readings: sound runs on seeds
# 5, 42, 43 and 2024 read at most start 2.5e-5, hio 3.1e-4, er 1.6e-4,
# best 1.8e-4 and sw 0; the control at least 9.5e-3, 9.2e-2, 3.0, 4.8 and
# 7.6e-4; the faults of test_fxsbench_faults the numbers it names
LIMITS = {"start_gap": 1e-3, "hio_gap": 1.5e-3, "er_gap": 1e-3,
          "best_gap": 8e-4, "sw_gap": 2e-5}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped elsewhere")


def make_root(path, limits=None):
    """The benchmark under `path` with the configuration "tiny" (the
    tutorial's settings at N_q 16, L 8, one main cycle with a steeper β
    ramp) and its cell
    tiny.batch2 added."""
    shutil.copytree(REPO / "fxsbench", path / "fxsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "fxsbench/configs/tutorial.json").read_text())
    cfg["settings"]["overrides"] = {
        "grid": {"n_radial_points": 16, "max_order": 8},
        "main_loop": {"sub_loops": {"main": {"iterations": 1}}},
        # β ramps within the one cycle as far as the tutorial's does in
        # its later ones
        "projections": {"real": {"HIO": {"beta": [[0.5, 0.3, -0.004, 100],
                                                   [0.01, 0.002, -0.005,
                                                    200]]}},
                        "reciprocal": {"used_order_ids": "all"}}}
    cfg["data"]["q_max"] = 0.05
    cfg["check"] = {"limits": limits or LIMITS}
    (path / "fxsbench/configs/tiny.json").write_text(json.dumps(cfg))
    manifest["configs"].append({
        "name": "tiny", "source": "https://github.com/European-XFEL/xFrame",
        "file": "fxsbench/configs/tiny.json", "reduced": [],
        "why": "the tutorial's settings at a size the CPU holds"})
    manifest["workloads"].append({"name": TINY, "config": "tiny",
                                  "traffic": "batch2", "chips": 1,
                                  "why": "tests"})
    for m in manifest["per_layer"]:
        m["workloads"].append(TINY)
    (path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return path


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path / "home"))
    return make_root(tmp_path / "root")
