"""What the benchmark loads: no module named ``jax``, ``jaxlib``, ``flax``
or ``mmada_parallel_tpu`` (compared by the part of the name before the
first dot), and a reference that imports nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "mmada_parallel_tpu"}

PROBE = r"""
import glob, json, os, sys, tempfile, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import tiny_cells, run_cell
from benchmark.harness import core
for path in glob.glob(os.path.join({root!r}, "benchmark", "**", "*.py"),
                      recursive=True):
    if "/tests/" not in path and not path.endswith("run.py"):
        core.load_module(path, "probe_" + str(abs(hash(path))))
root = tiny_cells(tempfile.mkdtemp())
for cell in ("tiny-edit", "tiny-sft"):
    rc, res = run_cell(root, cell)
    assert rc == 0, cell
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_in_a_run():
    tests = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT, tests=tests)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "mmada_parallel_torch" in loaded
    assert not loaded & FORBIDDEN


def test_top_level_names_compared_whole():
    """``jaxlike`` or ``mmada_parallel_tpux`` are other packages; a module
    inside ``jax`` is ``jax``."""
    from benchmark.harness import core
    fake = ("jaxlike_probe", "mmada_parallel_tpux.probe", "jax.probe")
    for name in fake:
        sys.modules[name] = sys
    try:
        assert core.forbidden_modules() == ["jax"]
    finally:
        for name in fake:
            del sys.modules[name]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    files = glob.glob(os.path.join(ROOT, "benchmark", "reference", "*.py"))
    assert len(files) >= 5
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & (FORBIDDEN | {"mmada_parallel_torch"}), path
