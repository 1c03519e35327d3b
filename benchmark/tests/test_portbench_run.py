"""Each driver end to end on the CPU at tiny sizes, through the harness,
from cells defined only in a temporary folder: the result line's shape,
and ``correct`` false under each fault the cells can have."""

import json
import os

import pytest
import torch

from conftest import ROOT, run_cell

CELLS = ("tiny-edit", "tiny-sft", "tiny-msft")


def test_tiny_cells_are_not_in_the_repository():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        names = {w["name"] for w in json.load(f)["workloads"]}
    assert not names & set(CELLS)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(tiny_root, cell, trace):
    rc, res = run_cell(tiny_root, cell, trace=trace)
    assert rc == 0
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 2
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[section]
            if cell in m.get("workloads", [cell])}
    got = set(res["metrics"])
    if trace:
        assert got and got <= want
        assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(res["breakdown"]["device_ops"]) <= 10
    else:
        assert got == want and "setup_s" in got
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or \
            m["unit"] in ("%", "GiB")
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
        assert c["value"] <= c["limit"]


def test_same_seed_same_inputs(tiny_root):
    """A seed fixes the inputs: two runs of the same (two-edit) window
    check the same edit and read the same numbers."""
    rc1, a = run_cell(tiny_root, "tiny-edit", seed=2 ** 31 + 5, seconds=0.01)
    rc2, b = run_cell(tiny_root, "tiny-edit", seed=2 ** 31 + 5, seconds=0.01)
    assert rc1 == rc2 == 0 and a["attempted"] == b["attempted"] == 2
    assert a["checks"] == b["checks"]


def _unchanged_edit(mp):
    from mmada_parallel_torch.samplers import parallel_ti2ti as P
    mp.setattr(P, "_text_update", lambda ids, *a, **k: (
        (ids, torch.zeros_like(ids[:, :1], dtype=torch.bool))
        if k.get("return_transfer") else ids))
    mp.setattr(P, "_image_update", lambda ids, *a, **k: ids)


def _altered_token(mp):
    from mmada_parallel_torch.ops import sampling as S
    real_g, real_c = S.gumbel_argmax, S.categorical_sample
    mp.setattr(S, "gumbel_argmax", lambda logits, *a: (
        real_g(logits, *a) + 1) % logits.shape[-1])
    mp.setattr(S, "categorical_sample", lambda logits, *a: (
        real_c(logits, *a) + 1) % logits.shape[-1])


def _unchanged_state(mp):
    from mmada_parallel_torch.training import trainer
    mp.setattr(trainer.Optimizer, "update", lambda self, *a, **k: None)


def _half_batch(mp):
    """The step sees the first half of its microbatches, the mean taken
    over them."""
    from mmada_parallel_torch.training import trainer
    real = trainer._accumulate

    def half(loss_fn, params, batch, generator, accum_steps):
        keep = batch[0].shape[0] // 2
        return real(loss_fn, params, tuple(t[:keep] for t in batch),
                    generator, max(1, accum_steps // 2))

    mp.setattr(trainer, "_accumulate", half)


@pytest.mark.parametrize("cell, fault", [
    ("tiny-edit", _unchanged_edit),
    ("tiny-edit", _altered_token),
    ("tiny-sft", _unchanged_state),
    ("tiny-sft", _half_batch),
    ("tiny-msft", _unchanged_state),
    ("tiny-msft", _half_batch),
])
def test_fault_makes_correct_false(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, res = run_cell(tiny_root, cell)
    assert rc == 0 and res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
