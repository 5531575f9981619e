"""The benchmark of simd_raytracer_tpu_torch on NVIDIA GPUs.

    python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Cells, configurations, traffic mixes and metrics are named in
BENCHMARK.json at the checkout's root and found by name under perfbench/
(see perfbench/pb/spec.py).  Run from the root of a checkout.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

from pb.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], STARTED))
