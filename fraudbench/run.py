"""Run one benchmark cell once and print its result as the last line of
standard output:

    python3 fraudbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds the program under test. Every
cache the run builds (the program's kernel libraries, Triton's and
PyTorch's extension caches) stays inside the checkout.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "fraudbench" / "_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from fraudbench.harness import main

    sys.exit(main(sys.argv[1:], t0=T0))
