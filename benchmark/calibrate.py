"""Readings that the correctness limits are set from, on the card:

    python3 benchmark/calibrate.py --workload a-edit --seeds 1,2,3 \
        --control 1,2 [--out FILE]

For each seed, in one process: the cell's weights and inputs from the
seed, one unit of the timed path (the driver's ``calibrate``), and the
check's readings of the program; for the seeds in ``--control`` also the
control's readings (the reference one precision below the configuration's,
``reference/lowp.py``) at the same positions.  One JSON line a seed, on
standard output and appended to ``--out``.  The benchmark's own runs never
run the control.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.harness import core  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    import torch
    core.fix_environment(ROOT)
    seeds = [int(s) for s in a.seeds.split(",")]
    control = {int(s) for s in a.control.split(",") if s}
    dev = core.device_info(torch, 1)
    core.log(f"[calibrate] {core.power_limit()}; {dev['kind']}")
    for seed in seeds:
        args = argparse.Namespace(workload=a.workload, seed=seed, seconds=0,
                                  trace=0)
        run = core.Run(ROOT, args, "cuda")
        driver = core.load_module(
            os.path.join(core.BENCH_DIR, "drivers",
                         run.traffic["driver"] + ".py"),
            "bench_driver_" + run.traffic["driver"])
        t = time.time()
        readings = driver.calibrate(run, seed in control)
        line = {"workload": a.workload, "seed": seed,
                "control": seed in control, "seconds": time.time() - t,
                "readings": readings}
        print(json.dumps(line), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    found = core.forbidden_modules()
    if found:
        core.log(f"[calibrate] modules the port must not load: {found}")
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
