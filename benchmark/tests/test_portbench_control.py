"""The controls on the card: the reference one precision below the
configuration's, put in the program's place, must come out not correct
against the cells' limits, while the program at the same size passes.
At the cells' widths with fewer layers and steps, so that a test run holds
them (the benchmark's calibration reads them at the cells' own sizes):

    python3 -m pytest benchmark/tests -m cuda
"""

import argparse
import json
import os

import pytest

from conftest import ROOT


def _cell(tmp_path, cell, config_over, traffic_over):
    from benchmark.harness import core
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    w = next(w for w in bench["workloads"] if w["name"] == cell)
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    for sub in ("configs", "traffic", "workloads"):
        os.makedirs(tmp_path / "benchmark" / sub)
    files = {conf["file"]: config_over,
             f"benchmark/traffic/{w['traffic']}.json": traffic_over,
             f"benchmark/workloads/{cell}.json": {}}
    for rel, over in files.items():
        with open(os.path.join(ROOT, rel)) as f:
            obj = json.load(f)
        for k, v in over.items():
            obj[k] = ({**obj[k], **v} if isinstance(v, dict) else v)
        with open(tmp_path / rel, "w") as f:
            json.dump(obj, f)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    args = argparse.Namespace(workload=cell, seed=424242, seconds=0, trace=0)
    run = core.Run(str(tmp_path), args, "cuda")
    core.device_info(__import__("torch"), 1)
    driver = core.load_module(
        os.path.join(core.BENCH_DIR, "drivers",
                     run.traffic["driver"] + ".py"),
        "bench_driver_" + run.traffic["driver"])
    return run, driver


def _judge(run, readings):
    limits = run.limits
    assert all(readings[k] <= v for k, v in limits.items()), readings
    ctl = {k: readings[f"control.{k}"] for k in limits
           if f"control.{k}" in readings}
    assert any(ctl[k] > limits[k] for k in ctl), ctl


@pytest.mark.cuda
def test_edit_control_fails(card, tmp_path):
    run, driver = _cell(tmp_path, "a-edit", {"n_layers": 8},
                        {"options": {"text_steps": 32, "timesteps": 16},
                         "check": {"image_steps": 4, "text_steps": 2}})
    _judge(run, driver.calibrate(run, control=True))


@pytest.mark.cuda
def test_msft_control_fails(card, tmp_path):
    run, driver = _cell(tmp_path, "m-sft", {}, {})
    _judge(run, driver.calibrate(run, control=True))


@pytest.mark.cuda
def test_sft_control_fails(card, tmp_path):
    run, driver = _cell(tmp_path, "a-sft",
                        {"n_layers": 2, "batch_size": 2},
                        {"seq_len": 2560})
    _judge(run, driver.calibrate(run, control=True))
