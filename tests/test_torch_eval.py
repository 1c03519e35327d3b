"""The port's evaluation harness (``evaluation.py``) and its CLI
(``cli/eval_sweep.py``) against the JAX package on the CPU, weights carried
across by ``llada_params_from_jax``, at temperature 0.

* ``run_parabench_sweep``: two prompt-length buckets and a short last chunk;
  every request's text equals JAX's and its unpadded solo run's, and every
  image code the sampler decided equals both.  The re-mask keeps at least
  one image token masked to the end and each package fills those from its
  own generator (both sweeps always pass one), so those cells are only held
  to the codebook's range.
* ``run_interleave_sweep`` (exact and ``use_cache=True``), ``run_t2i_sweep``
  and ``run_mmu_sweep`` drive the servers: request for request JAX's
  outputs.
* ``cli/eval_sweep.py --tiny_model --device cpu`` for each task writes the
  JAX CLI's metrics keys; its parser has the JAX flags plus ``--device``.
"""

import json

import numpy as np
import jax
import pytest
import torch

from mmada_parallel_tpu import evaluation as JE
from mmada_parallel_tpu import tokens as tk
from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_tpu.samplers import interleave as JI
from mmada_parallel_tpu.samplers import mmu as JM
from mmada_parallel_tpu.samplers import parallel_ti2ti as JT
from mmada_parallel_tpu.samplers import t2i as JT2I
from mmada_parallel_torch import evaluation as TE
from mmada_parallel_torch import tokens as ptk
from mmada_parallel_torch.eval_scorers import default_edit_scorer
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models.from_jax import llada_params_from_jax
from mmada_parallel_torch.samplers import interleave as TI
from mmada_parallel_torch.samplers import mmu as TM
from mmada_parallel_torch.samplers import parallel_ti2ti as TT
from mmada_parallel_torch.samplers import t2i as TT2I

torch.set_num_threads(1)
TVS, CB, MASK = 256, 32, 250
TOK = tk.VariantATokens(mask=MASK, newline=251, answer_start=252,
                        answer_end=253, boi=254, eoi=255, uncondition=249,
                        pad=248, text_vocab_size=TVS, codebook_size=CB)
TOK_M = tk.VariantMTokens(mask=250, soi=251, eoi=252, bos=249, eos=248,
                          interleave=247, text_vocab_size=TVS,
                          codebook_size=CB)
A_OPTS = dict(text_steps=8, timesteps=4, temperature=0.0,
              text_temperature=0.0, cfg_scale=0.0, cfg_img=2.0,
              text_vocab_size=TVS, codebook_size=CB, mask_token=MASK)
M_OPTS = dict(text_steps=8, image_steps=4, text_cfg=1.5, image_cfg=2.0,
              text_temperature=0.0, image_temperature=0.0,
              text_vocab_size=TVS, codebook_size=CB, mask_token=MASK)
UI = np.asarray([10, 11, 12], np.int32)
N_VQ, MSL = 6, 8


@pytest.fixture(scope="module")
def model():
    kw = dict(d_model=32, n_heads=2, n_kv_heads=2, n_layers=1,
              mlp_hidden_size=64, vocab_size=TVS + CB, mask_token_id=MASK)
    jcfg, tcfg = JL.LLaDAConfig.tiny(**kw), TL.LLaDAConfig.tiny(**kw)
    jp = JL.init_llada_params(jax.random.key(7), jcfg)
    return jcfg, tcfg, jp, llada_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp))


def _a_solo(tcfg, tp, prompt):
    ids, lay = tk.assemble_ti2ti_sequence(list(prompt), 8, 2, 3, [9],
                                          tokens=TOK)
    fin, codes = TT.generate_ti2ti(tp, tcfg, torch.tensor(ids[None]), lay,
                                   TT.TI2TIOptions(**A_OPTS),
                                   uncond_image_prefix=UI)
    fin = fin[0].numpy()
    return (TT.decode_text(fin, lay, TT.TI2TIOptions(**A_OPTS)),
            codes[0].numpy(), fin[lay.image_positions()] == MASK)


def test_parabench_sweep_matches_jax_and_solo(model):
    """Prompts of 5, 12 and 60 ids share bucket 64 (chunks of 2 and 1 at
    batch_size 2) and one of 70 ids sits alone in bucket 128."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 200, n).tolist() for n in (5, 70, 12, 60)]
    kw = dict(grid_hw=(2, 3), text_gen_length=8, end_token_ids=[9],
              batch_size=2, uncond_image_prefix=UI, seed=3)
    want = JE.run_parabench_sweep(
        jp, jcfg, [JE.EvalRequest(p) for p in prompts],
        opts=JT.TI2TIOptions(**A_OPTS), tokens=TOK, **kw)
    got = TE.run_parabench_sweep(
        tp, tcfg, [TE.EvalRequest(p, meta={"i": i})
                   for i, p in enumerate(prompts)],
        opts=TT.TI2TIOptions(**A_OPTS), tokens=ptk.VariantATokens(
            **TOK.__dict__), scorer=default_edit_scorer(), **kw)
    assert got["num_requests"] == 4 and got["total_time_s"] > 0
    assert got["edits_per_min"] == got["edits_per_min_per_chip"] > 0
    for i, p in enumerate(prompts):
        g, w = got["results"][i], want["results"][i]
        text, codes, still = _a_solo(tcfg, tp, p)
        assert g["index"] == i and g["meta"] == {"i": i}
        assert g["text"] == list(w["text"]) == text and text
        assert np.array_equal(g["codes"][~still], np.asarray(w["codes"])[
            ~still])
        assert np.array_equal(g["codes"][~still], codes[~still])
        assert still.any() and (0 <= g["codes"]).all() and \
            (g["codes"] < CB).all()
        assert 0.0 < g["scores"]["code_diversity"] <= 1.0


def test_parabench_sweep_refuses_a_mesh(model):
    _, tcfg, _, tp = model
    with pytest.raises(NotImplementedError, match="item 16"):
        TE.run_parabench_sweep(tp, tcfg, [TE.EvalRequest([5, 6])], (2, 3), 8,
                               [9], mesh=object())


def _m_requests(rng):
    reqs = []
    for instr in (list(range(10, 14)), list(range(30, 37)),
                  list(range(60, 62))):
        codes = rng.integers(TVS, TVS + CB, N_VQ)
        reqs.append((instr, codes,
                     {"input_codes": (codes - TOK_M.vq_offset).tolist()}))
    return reqs


@pytest.mark.parametrize("use_cache", [False, True])
def test_interleave_sweep_matches_jax(model, use_cache):
    """Three ragged requests through each package's ``InterleaveServer``;
    cached with every step refreshing (the exact trajectory) groups them by
    exact length."""
    jcfg, tcfg, jp, tp = model
    reqs = _m_requests(np.random.default_rng(11))
    kw = dict(num_vq_tokens=N_VQ, max_seq_length=MSL, batch_size=3,
              use_cache=use_cache,
              cache_kw={"refresh_interval": 1, "warmup_ratio": 1.0}
              if use_cache else None)
    want = JE.run_interleave_sweep(
        jp, jcfg, [JE.InterleaveEvalRequest(i, codes=c, meta=m)
                   for i, c, m in reqs],
        opts=JI.InterleaveOptions(**M_OPTS), tokens=TOK_M, **kw)
    got = TE.run_interleave_sweep(
        tp, tcfg, [TE.InterleaveEvalRequest(i, codes=c, meta=m)
                   for i, c, m in reqs],
        opts=TI.InterleaveOptions(**M_OPTS), tokens=TOK_M,
        scorer=default_edit_scorer(), **kw)
    assert got["num_requests"] == 3 and got["gens_per_min"] > 0
    assert got["server_stats"]["requests"] == 3
    for i in range(3):
        g, w = got["results"][i], want["results"][i]
        np.testing.assert_array_equal(g["text_ids"], np.asarray(
            w["text_ids"]), err_msg=f"row {i} text")
        np.testing.assert_array_equal(g["codes"], np.asarray(w["codes"]),
                                      err_msg=f"row {i} codes")
        assert 0.0 <= g["scores"]["consistency"] <= 1.0


def test_t2i_and_mmu_sweeps_match_jax(model):
    jcfg, tcfg, jp, tp = model
    t2i = dict(timesteps=4, temperature=0.0, guidance_scale=1.5,
               text_vocab_size=TVS, codebook_size=CB, mask_token=MASK)
    texts = [list(range(10, 13)), list(range(30, 36))]
    kw = dict(num_vq_tokens=N_VQ, batch_size=2, bucket_quantum=8,
              tokens=TOK_M)
    want = JE.run_t2i_sweep(jp, jcfg, [JE.T2IEvalRequest(t) for t in texts],
                            opts=JT2I.T2IOptions(**t2i), **kw)
    got = TE.run_t2i_sweep(tp, tcfg, [TE.T2IEvalRequest(t) for t in texts],
                           opts=TT2I.T2IOptions(**t2i),
                           scorer=default_edit_scorer(), **kw)
    assert got["images_per_min"] > 0
    for g, w in zip(got["results"], want["results"]):
        np.testing.assert_array_equal(g["codes"], np.asarray(w["codes"]))
        assert 0.0 < g["scores"]["code_diversity"] <= 1.0

    mmu = dict(max_new_tokens=8, steps=8, block_length=4, temperature=0.0,
               cfg_scale=0.0, mask_token=MASK)
    prompts = [[TOK_M.mmu, TOK_M.soi] + list(range(TVS, TVS + 4))
               + [TOK_M.eoi, TOK_M.bos, 11, 12, TOK_M.eos],
               [TOK_M.mmu, TOK_M.soi] + list(range(TVS + 8, TVS + 12))
               + [TOK_M.eoi, TOK_M.bos, 21, TOK_M.eos]]
    kw = dict(batch_size=2, bucket_quantum=8, tokens=TOK_M)
    want = JE.run_mmu_sweep(jp, jcfg, [JE.MMUEvalRequest(p) for p in prompts],
                            opts=JM.MMUOptions(**mmu), **kw)
    got = TE.run_mmu_sweep(tp, tcfg, [TE.MMUEvalRequest(p) for p in prompts],
                           opts=TM.MMUOptions(**mmu),
                           scorer=default_edit_scorer(), **kw)
    assert got["answers_per_min"] > 0
    for g, w in zip(got["results"], want["results"]):
        np.testing.assert_array_equal(g["text_ids"], np.asarray(
            w["text_ids"]))
        assert "code_diversity" not in g["scores"]


def test_eval_sweep_cli_keeps_the_jax_flags():
    from mmada_parallel_tpu.cli import eval_sweep as jcli
    from mmada_parallel_torch.cli import eval_sweep as tcli

    def flags(parser):
        return {a.dest: a.default for a in parser._actions}

    port = flags(tcli.build_parser())
    assert port.pop("device") == "cuda"
    assert port == flags(jcli.build_parser())


CLI_CASES = {
    "edit": ([{"prompt_ids": [5, 6, 7], "meta": {"input_codes": [1] * 4}},
              {"prompt_ids": [8, 9]}],
             ["--grid", "2,2", "--text_gen_length", "4", "--text_steps", "4",
              "--timesteps", "2", "--end_token_ids", "253"]),
    "interleave": ([{"instr_ids": [10, 11], "codes": list(range(N_VQ)),
                     "meta": {"input_codes": list(range(N_VQ))}},
                    {"instr_ids": [12, 13, 14], "codes": [1] * N_VQ}],
                   ["--num_vq_tokens", str(N_VQ), "--max_seq_length",
                    str(MSL), "--m_text_steps", "4", "--image_steps", "2"]),
    "t2i": ([{"text_ids": [10, 11, 12]}, {"text_ids": [13]}],
            ["--num_vq_tokens", str(N_VQ), "--t2i_timesteps", "2"]),
    "mmu": ([{"prompt_ids": [TOK_M.mmu, TOK_M.soi, 260, 261, TOK_M.eoi, 11]}],
            ["--mmu_max_new_tokens", "4", "--mmu_block_length", "4"]),
}


def _key_shape(metrics):
    return (sorted(metrics), sorted(metrics["aggregate"]),
            [sorted(r) for r in metrics["per_request"]],
            [sorted(r["scores"]) for r in metrics["per_request"]])


@pytest.mark.parametrize("task", sorted(CLI_CASES))
def test_eval_sweep_cli_writes_the_jax_metrics(task, monkeypatch, tmp_path):
    """Both CLIs on the same JSONL (tiny random models, the tiny tokens):
    the port's metrics file has the JAX one's keys, per request too."""
    from mmada_parallel_tpu.cli import eval_sweep as jcli
    from mmada_parallel_torch.cli import eval_sweep as tcli
    for mod in (tk, ptk):
        monkeypatch.setattr(mod, "TOKENS_A", mod.VariantATokens(
            **TOK.__dict__))
        monkeypatch.setattr(mod, "TOKENS_M", mod.VariantMTokens(
            **TOK_M.__dict__))
    lines, extra = CLI_CASES[task]
    req = tmp_path / "reqs.jsonl"
    req.write_text("\n".join(json.dumps(line) for line in lines))
    argv = ["--task", task, "--tiny_model", "--requests", str(req),
            "--batch_size", "2"] + extra
    want = jcli.main(argv + ["--out", str(tmp_path / "jax.json")])
    got = tcli.main(argv + ["--out", str(tmp_path / "port.json"),
                            "--device", "cpu"])
    written = json.loads((tmp_path / "port.json").read_text())
    assert written["num_requests"] == len(lines) and written["task"] == task
    assert _key_shape(written) == _key_shape(want) == _key_shape(got)
    assert written["quant"] is None


def test_eval_sweep_cli_quant(monkeypatch, tmp_path):
    """``--quant int8_bf16head`` runs the sweep on W8A8 params (the block
    GEMMs int8, the head dense) and says so in the metrics."""
    from mmada_parallel_torch.cli import eval_sweep as tcli
    from mmada_parallel_torch.ops import quant as TQ
    monkeypatch.setattr(ptk, "TOKENS_M", ptk.VariantMTokens(
        **TOK_M.__dict__))
    seen = []
    real = TQ.int8_matmul

    def counting(*a, **kw):
        seen.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr("mmada_parallel_torch.models.llada.int8_matmul",
                        counting)
    lines, extra = CLI_CASES["t2i"]
    req = tmp_path / "reqs.jsonl"
    req.write_text("\n".join(json.dumps(line) for line in lines))
    m = tcli.main(["--task", "t2i", "--tiny_model", "--requests", str(req),
                   "--device", "cpu", "--quant", "int8_bf16head"] + extra)
    assert m["quant"] == "int8_bf16head" and m["images_per_min"] > 0
    assert seen and all(s[1] != TOK_M.full_vocab_size for s in seen)
