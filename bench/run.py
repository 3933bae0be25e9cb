"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; see ``bench/harness.py``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# every build and kernel cache of the program at fixed paths inside the
# checkout, and no library loading JAX on its own
CACHE = ROOT / "build" / "bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one process with few threads: the host only dispatches to the card
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "2"
# the script's own folder leaves the path: bench/trace.py would shadow
# the standard library's trace module
sys.path = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path[1:] if pathlib.Path(p or ".").resolve()
    != ROOT / "bench"]

from bench.harness import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:], T_START))
