"""The benchmark of the PyTorch port's data-parallel training step.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once from the root of a checkout and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` and ``checks`` (each compared number
beside its limit, also the last lines of standard error).  It needs the
cell's number of CUDA devices and exits non-zero without a result
otherwise.  See ``bench/perfkit/harness.py``."""
import sys
import time

T_START = time.time()

from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

from perfkit import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
