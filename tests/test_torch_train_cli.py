"""The port's variant-A train CLI on the CPU, end to end.

``cli/train_a.py --tiny_model --device cpu`` trains on a data config built
in ``tmp_path``; a run stopped at step 2 and resumed to step 3 must end with
the parameters, optimizer state and metadata of a straight 3-step run
(bit-equal: the same ops on the same CPU), and ``--ckpt_max_keep`` must be
honoured.  The annotation items are built so that the item processor's
random draws cannot change their tokens (a one-code answer image is masked
whole, and the user prompt is the unconditional one), so a resumed process
sees the batches a straight run sees."""

import json
import os
import pickle

import pytest
import torch

from mmada_parallel_tpu.training.trainer import OptimizerConfig as JOptCfg
from mmada_parallel_torch.cli import train_a
from mmada_parallel_torch.training.trainer import OptimizerConfig

torch.set_num_threads(1)


def _data_config(tmp_path, n_items=8):
    img = tmp_path / "img.pkl"
    with open(img, "wb") as f:
        pickle.dump({"input_ids": [137], "height": 16, "width": 16}, f)
    items = [{"system_prompt": f"system prompt number {i:02d} of the set",
              "user_prompt": "<uncondition>", "answer_image": str(img),
              "answer_text": "", "len": 40 + i} for i in range(n_items)]
    ann = tmp_path / "items.json"
    ann.write_text(json.dumps(items))
    cfg = tmp_path / "data.yaml"
    cfg.write_text(f"META:\n  - path: {ann}\n    type: t2i\n")
    return str(cfg)


def _train(data, out, max_steps):
    train_a.main(["--data_config", data, "--output_dir", str(out),
                  "--tiny_model", "--device", "cpu", "--precision", "fp32",
                  "--batch_size", "1", "--accum_iter", "2",
                  "--lr", "1e-3", "--warmup_epochs", "0.5",
                  "--save_iteration_interval", "1", "--ckpt_max_keep", "2",
                  "--max_steps", str(max_steps)])


def _load(out, step):
    d = os.path.join(out, "ckpt", str(step))
    state = torch.load(os.path.join(d, "state.pt"), weights_only=True)
    with open(os.path.join(d, "metadata.json")) as f:
        return state, json.load(f)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix: tree}


def test_resume_equals_straight_run_and_keeps_max(tmp_path, capsys):
    data = _data_config(tmp_path)
    resumed, straight = tmp_path / "resumed", tmp_path / "straight"
    _train(data, resumed, 2)
    assert sorted(os.listdir(resumed / "ckpt")) == ["1", "2"]
    _train(data, resumed, 3)
    assert "[resume] step 2" in capsys.readouterr().out
    _train(data, straight, 3)

    for out in (resumed, straight):            # --ckpt_max_keep 2
        assert sorted(os.listdir(out / "ckpt")) == ["2", "3"]
    (s_res, m_res), (s_str, m_str) = _load(resumed, 3), _load(straight, 3)
    assert s_res["step"] == s_str["step"] == 3
    assert s_res["opt_state"]["count"] == s_str["opt_state"]["count"] == 3
    a, b = _flat(s_res), _flat(s_str)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
    assert m_res["epoch"] == m_str["epoch"] and m_res["iter"] == 3
    for name in ("loss", "grad_norm", "lr", "nonfinite"):  # not the timing
        assert m_res["metrics"][name] == m_str["metrics"][name], name
    # the parameters moved, and stayed finite
    first, _ = _load(straight, 2)
    assert not torch.equal(first["params"]["wte"], s_str["params"]["wte"])
    assert all(torch.isfinite(t).all() for t in _flat(s_str).values()
               if isinstance(t, torch.Tensor))


def test_cli_keeps_the_jax_flags_and_defaults():
    from mmada_parallel_tpu.cli import train_a as jcli

    def flags(parser):
        return {a.dest: (a.default, a.required) for a in parser._actions}

    port = flags(train_a.build_parser())
    assert port.pop("device") == ("cuda", False)
    assert port == flags(jcli.build_parser())
    keep = ("name", "lr", "weight_decay", "b1", "b2", "eps", "grad_clip",
            "schedule")
    assert {k: getattr(OptimizerConfig(), k) for k in keep} == \
        {k: getattr(JOptCfg(), k) for k in keep}


@pytest.mark.parametrize("extra", [["--mesh_tensor", "2"], ["--tp_ring"],
                                   ["--shard_strategy", "zero2",
                                    "--mesh_fsdp", "2"],
                                   ["--mesh_fsdp", "2"]])
def test_multi_device_flags_raise(tmp_path, extra):
    """The ring needs a tensor axis of 2 or more; a mesh (``fsdp`` or
    Megatron ``tensor``) needs the ranks of a torchrun world."""
    match = {"--tp_ring": "--tp_ring needs --mesh_tensor >= 2"}.get(
        extra[0], "torchrun world")
    with pytest.raises(SystemExit, match=match):
        train_a.main(["--data_config", _data_config(tmp_path, 2),
                      "--output_dir", str(tmp_path / "o"), "--tiny_model",
                      "--device", "cpu", *extra])


def _torchrun(args, timeout=300):
    """``python -m torch.distributed.run --standalone --nproc_per_node 2``
    of ``args``, on the CPU; returns its stdout."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", *args], cwd=repo, env=env,
        capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.mark.parametrize("flags", [
    ["--mesh_fsdp", "2", "--shard_strategy", "full"],
    ["--mesh_tensor", "2", "--tp_ring"],
    ["--mesh_tensor", "2", "--shard_strategy", "full"],
    ["--mesh_tensor", "2", "--shard_strategy", "zero2"],
    ["--mesh_tensor", "2", "--shard_strategy", "ddp"]],
    ids=["fsdp", "ring", "tensor-full", "tensor-zero2", "tensor-ddp"])
def test_mesh_flags_train_under_torchrun(tmp_path, flags):
    """Two torchrun ranks train the tiny model 2 steps over ``fsdp=2``, on
    a 2-rank ring, or with Megatron tensor parallelism over ``tensor=2``
    (no ring) under each strategy: one ``[done]`` line (rank 0 logs), and
    a sharded checkpoint that restores whole in one process."""
    from mmada_parallel_torch.models.llada import (LLaDAConfig,
                                                   init_llada_params)
    from mmada_parallel_torch.training.checkpoint import CheckpointManager
    from mmada_parallel_torch.training.trainer import (TrainState,
                                                       make_optimizer)
    out = tmp_path / "o"
    printed = _torchrun(["-m", "mmada_parallel_torch.cli.train_a",
                         "--data_config", _data_config(tmp_path, 8),
                         "--output_dir", str(out), "--tiny_model",
                         "--device", "cpu", "--precision", "fp32",
                         "--batch_size", "1", "--accum_iter", "2",
                         "--max_steps", "2", "--save_iteration_interval",
                         "2", *flags])
    assert printed.count("[done] 2 steps") == 1
    shards = json.loads((out / "ckpt" / "2" / "shards.json").read_text())
    assert shards["mesh"] == ({"data": 1, "fsdp": 2, "tensor": 1}
                              if "--mesh_fsdp" in flags else
                              {"data": 1, "fsdp": 1, "tensor": 2})
    if "--tp_ring" not in flags and "--mesh_tensor" in flags:
        assert "tensor" in shards["specs"]["params/blocks/q_proj"]
    kw = dict(n_heads=4, n_kv_heads=2) if "--tp_ring" in flags else {}
    cfg = LLaDAConfig.tiny(vocab_size=512, **kw)
    params = init_llada_params(cfg, torch.Generator().manual_seed(0))
    state, meta, step = CheckpointManager(str(out / "ckpt")).restore(
        TrainState.create(params, make_optimizer(OptimizerConfig(), params)))
    assert step == 2 and state.step == 2 and state.opt_state["count"] == 2
