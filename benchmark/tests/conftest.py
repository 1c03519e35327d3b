"""Fixtures of the benchmark's tests: a tiny copy of each cell, defined
only in a temporary folder (its BENCHMARK.json, configuration, traffic
and limits files), which the harness runs on the CPU."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _read(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def tiny_cells(root) -> dict:
    """Write tiny versions of the a-edit, a-sft and m-sft cells under ``root``
    (the real cells' limits, small widths): ``{cell: root}``."""
    bench = _read("BENCHMARK.json")
    os.makedirs(os.path.join(root, "benchmark", "configs"))
    os.makedirs(os.path.join(root, "benchmark", "traffic"))
    os.makedirs(os.path.join(root, "benchmark", "workloads"))
    small = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                 mlp_hidden_size=128, rope_theta=10000.0, init_std=0.2)
    edit = _read("benchmark/configs/mmada-a-8b.json")
    edit.update(small, name="tiny-a", dtype="float32")
    edit["vq"] = {"block_out_channels": [8, 16], "layers_per_block": 1,
                  "in_channels": 3, "out_channels": 3,
                  "latent_channels": 8, "num_vq_embeddings": 32,
                  "norm_num_groups": 4, "mid_attention": True, "eps": 1e-6}
    sft = _read("benchmark/configs/mmada-a-8b-sft.json")
    sft.update(small, name="tiny-a-sft", compute_dtype="float32")
    sft.update(batch_size=2, accum_iter=2)
    tr_edit = _read("benchmark/traffic/edit-512-reference.json")
    tr_edit.update(image_size=16, text_gen_length=8,
                   check={"image_steps": 3, "text_steps": 2})
    tr_edit["options"].update(text_steps=8, timesteps=4)
    tr_sft = _read("benchmark/traffic/sft-a-5120.json")
    tr_sft.update(seq_len=96, grid=4, answer_text=8)
    msft = _read("benchmark/configs/mmada-m-8b-sft.json")
    msft.update(small, name="tiny-m-sft", compute_dtype="float32",
                max_seq_length=8, num_vq_tokens=16, resolution=8,
                codebook_size=16)
    msft["tokens"].update(body=4)
    msft["vq"] = {"ch": 16, "enc_ch_mult": [1, 2], "enc_blocks": [1, 1],
                  "dec_ch_mult": [1, 2], "dec_blocks": [1, 1],
                  "z_channels": 4, "in_ch": 3, "out_ch": 3, "groups": 4,
                  "eps": 1e-6}
    files = {"benchmark/configs/tiny-a.json": edit,
             "benchmark/configs/tiny-a-sft.json": sft,
             "benchmark/traffic/tiny-edit.json": tr_edit,
             "benchmark/traffic/tiny-sft.json": tr_sft,
             "benchmark/configs/tiny-m-sft.json": msft,
             "benchmark/traffic/tiny-msft.json":
                 _read("benchmark/traffic/sft-m-interleave.json"),
             "benchmark/workloads/tiny-msft.json":
                 _read("benchmark/workloads/m-sft.json"),
             "benchmark/workloads/tiny-edit.json":
                 _read("benchmark/workloads/a-edit.json"),
             "benchmark/workloads/tiny-sft.json":
                 _read("benchmark/workloads/a-sft.json")}
    bench["configs"] = [
        {"name": n, "source": "https://example.org/tiny", "file": f,
         "reduced": [], "why": "a CPU test's tiny model"}
        for n, f in (("tiny-a", "benchmark/configs/tiny-a.json"),
                     ("tiny-a-sft", "benchmark/configs/tiny-a-sft.json"),
                     ("tiny-m-sft", "benchmark/configs/tiny-m-sft.json"))]
    bench["workloads"] = [
        {"name": "tiny-edit", "config": "tiny-a", "traffic": "tiny-edit",
         "chips": 1, "why": "the edit's path at a tiny size"},
        {"name": "tiny-sft", "config": "tiny-a-sft", "traffic": "tiny-sft",
         "chips": 1, "why": "the A step's path at a tiny size"},
        {"name": "tiny-msft", "config": "tiny-m-sft", "traffic": "tiny-msft",
         "chips": 1, "why": "the M loop's path at a tiny size"}]
    real = {"a-edit": "tiny-edit", "a-sft": "tiny-sft", "m-sft": "tiny-msft"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [real[w] for w in m["workloads"] if w in real]
    files["BENCHMARK.json"] = bench
    for rel, obj in files.items():
        with open(os.path.join(root, rel), "w") as f:
            json.dump(obj, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_cells(str(tmp_path))


def run_cell(root, cell, seed=3000000019, seconds=1.0, trace=0):
    """One run of ``cell`` on the CPU; returns (exit code, result line)."""
    import contextlib
    import io
    import time

    from benchmark.harness import core
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = core.main(["--workload", cell, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       root=root, t0=time.time(), device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
