"""The benchmark's command: one run of one cell.

    python3 fxsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints the result as one JSON line on standard output, and each number
compared for `correct` beside its limit on standard error. It needs as
many CUDA devices as the cell asks for and exits with 2 without a result
where they are missing.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# caches at fixed paths: the checkout's own, the program's home in the
# run's TMPDIR where one is set
_CACHE = ROOT / ".fxsbench"
os.environ["XFRAME_TPU_HOME"] = str(
    Path(os.environ["TMPDIR"]) / "fxsbench_home" if os.environ.get("TMPDIR")
    else _CACHE / "home")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
sys.path.insert(0, str(ROOT))

from fxsbench.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
