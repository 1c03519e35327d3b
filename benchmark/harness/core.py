"""One run of one cell: set-up, a measured window, the readings, the check.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name.  ``BENCHMARK.json`` names the cell's
configuration and traffic; the configuration is the file it lists, the
traffic ``benchmark/traffic/<traffic>.json``, which names its driver
(``benchmark/drivers/<driver>.py``); the cell's correctness limits are in
``benchmark/workloads/<cell>.json``; each per-layer metric is read by
``benchmark/metrics/<metric>.py``.  A new configuration, traffic, cell or
metric is new files and entries only.

A driver module has ``setup(run) -> Driver``; the driver object has
``plan(seconds) -> units``, ``window(units)`` (that many whole edits or
steps), ``end_to_end(wall_s, units) -> {metric: value}``,
``work(units) -> dict`` (what the per-layer readers count from),
``release()`` (frees the program's state) and ``check() -> [(name,
value, limit)]`` (the comparison with the reference, after the window).

The last line of standard output is the result; standard error ends with
the compared numbers beside their limits.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
PEAK_BF16_FLOPS = 989e12          # H100 SXM, dense (NVIDIA's data sheet)
PEAK_HBM_BYTES = 3.35e12
FORBIDDEN = ("jax", "jaxlib", "flax", "mmada_parallel_tpu")


class RunError(Exception):
    """A run that cannot produce a result; exits non-zero."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_module(path: str, name: str):
    """Import a file by path (metric files have dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Run:
    """What a driver gets: the arguments, the cell's files and the
    device."""

    def __init__(self, root: str, args, device: str):
        self.root, self.args, self.device = root, args, device
        self.seed = args.seed
        bench = read_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if args.workload not in cells:
            raise RunError(f"no workload {args.workload!r} in BENCHMARK.json")
        self.bench, self.cell = bench, cells[args.workload]
        conf = {c["name"]: c for c in bench["configs"]}[self.cell["config"]]
        self.config = read_json(os.path.join(root, conf["file"]))
        self.traffic = read_json(os.path.join(
            root, "benchmark", "traffic", self.cell["traffic"] + ".json"))
        self.limits = read_json(os.path.join(
            root, "benchmark", "workloads", self.cell["name"] + ".json"))[
                "limits"]

    def metrics_of(self, section: str) -> list:
        """The cell's entries of ``end_to_end`` or ``per_layer``."""
        return [m for m in self.bench[section]
                if "workloads" not in m
                or self.cell["name"] in m["workloads"]]


def parse_args(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fix_environment(root: str) -> None:
    """Caches at fixed paths inside the checkout; no library loads JAX."""
    cache = os.path.join(root, ".benchcache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    os.environ["USE_JAX"] = "0"


def device_info(torch, chips: int) -> dict:
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} cards, "
                       f"{torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None, root=None, t0=None, device="cuda") -> int:
    """One run; returns the exit code.  ``device="cpu"`` (tests only: the
    command line always asks for a card) skips the look for a card."""
    t0 = time.time() if t0 is None else t0
    root = os.path.abspath(root or os.getcwd())
    args = parse_args(argv)
    try:
        fix_environment(root)
        result, checks = _run(root, args, t0, device)
    except RunError as e:
        log(f"[bench] no result: {e}")
        return 3
    for name, value, limit in checks:
        log(f"[check] {name} {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
    return 0


def _run(root, args, t0, device):
    import torch
    run = Run(root, args, device)
    if device == "cuda":
        dev = device_info(torch, run.cell["chips"])
        log(f"[bench] {power_limit()}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1}
    driver = load_module(os.path.join(BENCH_DIR, "drivers",
                                      run.traffic["driver"] + ".py"),
                         "bench_driver_" + run.traffic["driver"])
    marks = [("imports", time.time())]
    if device == "cuda":            # the kernels: built once a checkout
        from mmada_parallel_torch.ops import _cuda
        _cuda.library()
        marks.append(("kernel library", time.time()))
    d = driver.setup(run)
    marks.append(("models and state", time.time()))
    units = d.plan(args.seconds)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    marks.append(("warm-up", time.time()))
    setup_s = marks[-1][1] - t0
    log(f"[bench] set-up {setup_s:.3f} s (" + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b)
        in zip([("", t0)] + marks, marks)) + f"); window of {units} units")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with (profile(activities=acts) if args.trace
          else contextlib.nullcontext()) as prof:
        start = time.time()
        d.window(units)
        sync()
        wall = time.time() - start
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    dev["memory_peak_bytes"] = peak
    log(f"[bench] window {wall:.3f} s, peak {peak / 2 ** 30:.3f} GiB")
    e2e = d.end_to_end(wall, units)
    e2e["setup_s"] = setup_s
    e2e["peak_mem_gib"] = peak / 2 ** 30
    result = {"attempted": units, "failed": 0}
    if args.trace:
        metrics, extra = _per_layer(run, prof, d.work(units), wall, device)
        dev.update(extra.pop("device"))
        result.update(extra)
        log("[bench] traced run: end-to-end readings of the traced window "
            + json.dumps(e2e))
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in run.metrics_of("end_to_end")}
    del prof
    d.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = d.check()
    found = forbidden_modules()
    if found:
        raise RunError(f"modules loaded that the port must not load: "
                       f"{found}")
    correct = all(v <= lim for _, v, lim in checks)
    out = {"correct": correct, **result, "metrics": metrics, "device": dev,
           "checks": {n: {"value": v, "limit": lim}
                      for n, v, lim in checks}}
    return out, checks


def _per_layer(run, prof, work, wall, device):
    from benchmark.harness import trace as T
    t_read = time.time()
    tr = T.summarize(prof, device=device)
    if tr is None:
        raise RunError("the traced window recorded no device operation")
    ctx = {"trace": tr, "window_s": wall, "work": work,
           "peak_flops": PEAK_BF16_FLOPS, "peak_bytes": PEAK_HBM_BYTES}
    metrics = {}
    for m in run.metrics_of("per_layer"):
        reader = load_module(os.path.join(BENCH_DIR, "metrics",
                                          m["name"] + ".py"),
                             "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"[bench] trace read in {time.time() - t_read:.1f} s: busy "
        f"{tr.busy_s:.3f} s of {wall:.3f}; by class " + json.dumps(
            {k: round(v, 6) for k, v in sorted(tr.by_class.items())}))
    return metrics, {"device": {"busy_s": tr.busy_s, "window_s": wall},
                     "breakdown": T.breakdown(tr)}
