"""What the benchmark loads: neither JAX nor the JAX package anywhere, and
nothing of the program in the reference; no card, no program: no result."""
import json
import os
import shutil
import subprocess
import sys

from conftest import REPO, TINY

FORBIDDEN = {"jax", "jaxlib", "flax", "xframe_tpu"}


def tops(code, cwd):
    out = subprocess.run([sys.executable, "-I", "-c",
                          "import sys\nsys.path.insert(0, '.')\n" + code
                          + "\nimport json\nprint(json.dumps(sorted({m.split("
                          "'.')[0] for m in sys.modules})))"], cwd=cwd,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "XFRAME_TPU_HOME": str(cwd)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    found = tops("import fxsbench.check, fxsbench.inputs, fxsbench.work, "
                 "fxsbench.trace, fxsbench.reference.mtip", REPO)
    assert not found & (FORBIDDEN | {"xframe_tpu_torch"}), found


def test_a_run_loads_no_jax(tiny_root):
    os.symlink(REPO / "xframe_tpu_torch", tiny_root / "xframe_tpu_torch")
    found = tops("from fxsbench import bench\n"
                 f"r = bench.run({TINY!r}, 5, 0.1, False, device='cpu')\n"
                 "assert r['correct']", tiny_root)
    assert "xframe_tpu_torch" in found
    assert not found & FORBIDDEN, found


def run_py(cwd):
    return subprocess.run([sys.executable, "fxsbench/run.py", "--workload",
                           "tutorial.batch8", "--seed", "3000000001",
                           "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a CUDA device is present")
    out = run_py(REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a
    run fails before it prints anything."""
    shutil.copytree(REPO / "fxsbench", tmp_path / "fxsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-I", "-c", "import sys\nsys.path.insert(0, '.')\n"
         "from fxsbench import bench\nbench.run('tutorial.batch8', 1, 1.0, "
         "False, device='cpu')\nprint('result')"], cwd=tmp_path,
        capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout == ""
    assert "xframe_tpu_torch" in out.stderr
