"""Run one cell of the port's benchmark and print its result as one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with a CUDA device. See
``portbench/README.md``.
"""

import time

_T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
# the folder of this file would shadow top-level modules by its own files
if sys.path and Path(sys.path[0]).resolve() == _ROOT / "portbench":
    sys.path.pop(0)
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))
# libraries that would load JAX by themselves are kept from it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=_T_START, root=_ROOT))
