"""The ``sdar-blockgen`` and ``a-edit-cached`` drivers end to end on the CPU
at tiny sizes, through the harness, from cells defined only in a temporary
folder; ``correct`` false under faults; and ``harness/moe_counts.py``'s
arithmetic at SDAR's published size."""

import json
import os

import pytest
import torch

from conftest import ROOT, _read, run_cell, tiny_cells

REAL = {"sdar-blockgen": "tiny-sdar", "a-edit-cached": "tiny-edit-cached"}


@pytest.fixture
def tiny_new(tmp_path):
    """The conftest's tiny cells plus tiny copies of the two new ones (the
    real cells' limits; the cached edit at 16 steps and 2 image steps, so
    that it has partial steps between its refreshes)."""
    root = tiny_cells(str(tmp_path))
    sdar = _read("benchmark/configs/sdar-30b-a3b.json")
    sdar.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=1,
                head_dim=32, num_hidden_layers=2, num_experts=8,
                num_experts_per_tok=2, moe_intermediate_size=32,
                intermediate_size=96, vocab_size=96, init_std=0.2,
                max_position_embeddings=64, dtype="float32",
                tokens={"mask": 95, "lo": 0, "hi": 90})
    tr_sdar = _read("benchmark/traffic/blockgen-4096-256.json")
    tr_sdar.update(batch=2, prompt_len=6, new_tokens=8)
    tr_cached = _read("benchmark/traffic/edit-512-cached.json")
    tr_cached.update(image_size=16, text_gen_length=8,
                     check={"image_steps": 2, "text_steps": 2})
    tr_cached["options"].update(text_steps=16, timesteps=2)
    files = {"benchmark/configs/tiny-sdar.json": sdar,
             "benchmark/traffic/tiny-sdar.json": tr_sdar,
             "benchmark/traffic/tiny-edit-cached.json": tr_cached,
             "benchmark/workloads/tiny-sdar.json":
                 _read("benchmark/workloads/sdar-blockgen.json"),
             "benchmark/workloads/tiny-edit-cached.json":
                 _read("benchmark/workloads/a-edit-cached.json")}
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    real = _read("BENCHMARK.json")
    bench["configs"].append({"name": "tiny-sdar", "source":
                             "https://example.org/tiny",
                             "file": "benchmark/configs/tiny-sdar.json",
                             "reduced": [], "why": "a CPU test's tiny SDAR"})
    bench["workloads"] += [
        {"name": "tiny-sdar", "config": "tiny-sdar", "traffic": "tiny-sdar",
         "chips": 1, "why": "the block sampler's path at a tiny size"},
        {"name": "tiny-edit-cached", "config": "tiny-a",
         "traffic": "tiny-edit-cached", "chips": 1,
         "why": "the cached edit's path at a tiny size"}]
    by_name = {m["name"]: m for m in real["end_to_end"] + real["per_layer"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" not in m:
            continue
        m["workloads"] += [
            REAL[w] for w in by_name[m["name"]].get("workloads", ())
            if w in REAL]
    files["BENCHMARK.json"] = bench
    for rel, obj in files.items():
        with open(os.path.join(root, rel), "w") as f:
            json.dump(obj, f)
    return root


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["tiny-sdar", "tiny-edit-cached"])
def test_result_line(tiny_new, cell, trace):
    rc, res = run_cell(tiny_new, cell, trace=trace)
    assert rc == 0 and res["correct"] is True, res
    assert res["attempted"] >= 2
    with open(os.path.join(tiny_new, "BENCHMARK.json")) as f:
        bench = json.load(f)
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[section]
            if cell in m.get("workloads", [cell])}
    got = set(res["metrics"])
    if trace:
        assert got and got <= want
        assert "mfu.sdar" in got or cell != "tiny-sdar"
        assert "mfu.edit" in got or cell != "tiny-edit-cached"
    else:
        assert got == want == {"edit_s", "peak_mem_gib", "setup_s"}
    assert set(res["checks"]) == set(_read(
        "benchmark/workloads/" + {v: k for k, v in REAL.items()}[cell]
        + ".json")["limits"])


def test_cached_edit_checks_partial_steps(tiny_new, monkeypatch):
    """The tiny cached edit has partial steps, and the check replays them:
    a partial step's hidden states negated and scaled in the program (its
    slots then commit at once, each the reference's worst token) move the
    served tokens off the reference's replay."""
    from mmada_parallel_torch.samplers import parallel_ti2ti as P
    sched = P.cached_refresh_schedule(16, 2, 4, 0.25)
    assert not sched.all()
    rc, res = run_cell(tiny_new, "tiny-edit-cached")
    assert rc == 0 and res["correct"] is True
    real = P.llada_hidden_partial

    def flipped(params, cfg, sel_ids, sel_pos, cache, *a, **kw):
        h, cache = real(params, cfg, sel_ids, sel_pos, cache, *a, **kw)
        return -50 * h, cache

    monkeypatch.setattr(P, "llada_hidden_partial", flipped)
    rc, res = run_cell(tiny_new, "tiny-edit-cached")
    assert rc == 0 and res["correct"] is False


def _altered_token(mp):
    from mmada_parallel_torch.ops import sampling as S
    real = S.gumbel_argmax
    mp.setattr(S, "gumbel_argmax", lambda logits, *a: (
        real(logits, *a) + 1) % logits.shape[-1])


def _other_experts(mp):
    """The router's k least likely experts in place of its top k."""
    from mmada_parallel_torch.ops import moe as MO
    real = MO.route

    def route(h, router, top_k, norm):
        w, _ = real(h, router, top_k, norm)
        low = torch.topk(-(h.float() @ router.float()), top_k, -1).indices
        return w, low

    mp.setattr(MO, "route", route)


def _two_commits(mp):
    from mmada_parallel_torch.samplers import mmu as TM
    real = TM._commit
    mp.setattr(TM, "_commit", lambda cur, logits, budget, *a: real(
        real(cur, logits, budget, *a), logits, budget, *a))


@pytest.mark.parametrize("cell, fault, check", [
    ("tiny-sdar", _altered_token, "text_token_gap"),
    ("tiny-sdar", _other_experts, "route_miscount"),
    ("tiny-sdar", _two_commits, "commit_miscount"),
    ("tiny-edit-cached", _altered_token, "text_token_gap"),
])
def test_fault_makes_correct_false(tiny_new, monkeypatch, cell, fault,
                                   check):
    fault(monkeypatch)
    rc, res = run_cell(tiny_new, cell)
    assert rc == 0 and res["correct"] is False
    assert res["checks"][check]["value"] > res["checks"][check]["limit"]


def test_moe_counts_at_published_size():
    from benchmark.harness import moe_counts as MC
    m = _read("benchmark/configs/sdar-30b-a3b.json")
    d, V, L = m["hidden_size"], m["vocab_size"], m["num_hidden_layers"]
    params = (L * (MC.attention_weights(m) + m["num_experts"]
                   * MC.expert_weights(m)) + 2 * V * d + d)
    assert params == 30_532_122_624
    # a decode forward (16 rows x a block of 4, at the first block's end)
    step = {"tokens": 64, "attended": 64 * 4100, "cache_rows": 16 * 4100,
            "head_rows": 64, "prefill": False}
    per_token = 2 * (2 * d * 4096 + 2 * d * 512 + d * 128 + 8 * 3 * d * 768)
    assert MC.forward_flops(m, step) == (L * (64 * per_token
                                              + 4 * 32 * 128 * 64 * 4100)
                                         + 2 * d * V * 64)
    # all experts touched: the weights are 58 GB of the forward's bytes
    nbytes = MC.forward_bytes(m, step, L * 128)
    assert 57e9 < 2 * L * 128 * MC.expert_weights(m) < nbytes < 70e9
    bound = MC.window_bound_s(m, [dict(step, count=10)], 10 * L * 128,
                              989e12, 3.35e12)
    assert bound == pytest.approx(10 * nbytes / 3.35e12)
    # a prefill is bound by its operations
    pre = {"tokens": 16 * 4096, "attended": 16 * 4096 * 2050,
           "cache_rows": 0, "head_rows": 0, "prefill": True, "count": 1}
    assert MC.window_bound_s(m, [pre], L * 128, 989e12, 3.35e12) == \
        pytest.approx(MC.forward_flops(m, pre) / 989e12)
