"""Run one cell of BENCHMARK.json once and print one JSON line:

    python3 avbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a host with the CUDA cards the cell asks
for (none: exit 2, no result). Set-up is timed from the first line here.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, its own folder would come first on the path and shadow
# the standard library (trace)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# the program's caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, "avbench", ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
# one host thread for torch's and numpy's CPU work: the decode is bound by
# one Python thread, and idle pool threads spinning beside it spread the
# runs
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

from avbench import guard  # noqa: E402

guard.install()

from avbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
