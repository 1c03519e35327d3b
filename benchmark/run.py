"""Run one cell of the benchmark of the PyTorch/CUDA port on the card:

    python3 benchmark/run.py --workload a-edit --seed 7 --seconds 45 \
        --trace 0

from the root of a checkout (see ``harness/core.py``)."""

import os
import sys
import time

T0 = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(root=ROOT, t0=T0))
