"""The port's variant-M interleave SFT trainer (``cli/train_m.py``) and the
remaining utils against the JAX package.

* the loss function on one assembled batch, params bridged from JAX: loss,
  ``text_loss``, ``image_loss`` and every gradient agree with
  ``jax.value_and_grad`` of the JAX trainer's loss (f32, remat
  ``whole_layer``; atol = rtol = 1e-4 as the forward itself, gradients to
  rtol 1e-4 with atol 1e-5 of each leaf's largest);
* the batch builder's prompt half and key-padding mask equal the JAX
  builder's (the full-size one-row batch is 2565 tokens long);
* ``main`` end to end from a tar shard on ``device=cpu``, and its resume;
  the MMU and chat validators write the JAX validators' jsonl, the
  interleave validator its PNG and text; the multi-device settings and a
  missing card raise;
* ``lfq_losses`` and its gradients (rtol 1e-5, f32; gradient elements
  near 0 to 1e-5 of the largest), the masking-bucket
  metrics, ``param_store`` files across packages, determinism and
  profiling helpers."""

import io
import json
import os
import tarfile
from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mmada_parallel_torch import tokens as PTK
from mmada_parallel_torch.cli import train_m as PTM
from mmada_parallel_torch.config import load_config
from mmada_parallel_torch.data.prompting import UniversalPrompting
from mmada_parallel_torch.models import llada as PL
from mmada_parallel_torch.models import magvit2 as PMV
from mmada_parallel_torch.models.from_jax import (llada_params_from_jax,
                                                  magvit_params_from_jax)
from mmada_parallel_torch.utils import param_store as PPS
from mmada_parallel_tpu.cli import train_m as JTM
from mmada_parallel_tpu.data.prompting import \
    UniversalPrompting as JUniversalPrompting
from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_tpu.models import magvit2 as JMV
from mmada_parallel_tpu.training.losses import m_interleave_loss
from mmada_parallel_tpu.utils import param_store as JPS

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
T = PTK.TOKENS_M


class FakeTokenizer:
    """Batch calls (``UniversalPrompting``) and single calls (the output
    texts, the chat prompts) both work; ``decode`` joins ids."""
    bos_token_id = T.bos
    eos_token_id = T.eos

    def __call__(self, text, **kw):
        if isinstance(text, list):
            return {"input_ids": [self(t)["input_ids"] for t in text]}
        return {"input_ids": [10 + ord(c) % 50 for c in text[:12]]}

    def decode(self, ids, **kw):
        return " ".join(str(i) for i in ids)


def _cfg(**over):
    args = [f"{k}={v}" for k, v in dict(
        {"dataset.preprocessing.max_seq_length": 8,
         "dataset.preprocessing.resolution": 8,
         "model.mmada.num_vq_tokens": 16,
         "training.batch_size": 2,
         "training.gradient_accumulation_steps": 1,
         "training.cond_dropout_prob": 0.3}, **over).items()]
    return load_config(None, args, PTM.DEFAULTS)


def _codes(px):
    """A stand-in for MagViT-v2: codes from the pixels' red channel."""
    px = np.asarray(px)
    return torch.as_tensor(np.round((px[..., 0] + 1) * 4000).astype(
        np.int64).reshape(px.shape[0], -1))


def _samples(n, res=8, seed=0):
    rng = np.random.default_rng(seed)
    return [{"pixels_in": rng.uniform(-1, 1, (1, res // 2, res // 2, 3)),
             "pixels_out": rng.uniform(-1, 1, (1, res // 2, res // 2, 3)),
             "instruction": f"edit number {i}" if i % 3 else "",
             "output_text": "an answer " * (i % 4),
             "is_text_only": i == 1} for i in range(n)]


@pytest.fixture(scope="module")
def bridged():
    """The tiny debug backbone (full M vocab, f32, remat whole_layer) in
    both packages with the same weights."""
    jcfg = JL.LLaDAConfig.tiny(vocab_size=T.full_vocab_size,
                               mask_token_id=T.mask, remat="whole_layer")
    jp = JL.init_llada_params(jax.random.key(0), jcfg)
    tcfg = PL.LLaDAConfig.tiny(vocab_size=T.full_vocab_size,
                               mask_token_id=T.mask, remat="whole_layer")
    tp = llada_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, tcfg, tp


def test_loss_and_gradients_equal_jax(bridged):
    """One assembled batch (two rows, one text-only, dropout on): the
    port's ``make_loss_fn`` against the JAX trainer's loss function."""
    jcfg, jp, tcfg, tp = bridged
    cfg = _cfg()
    up = UniversalPrompting(FakeTokenizer(), max_text_len=8)
    batch = PTM.assemble_batch(_samples(2), _codes, FakeTokenizer(), up,
                               torch.Generator().manual_seed(0), cfg,
                               torch.device("cpu"))
    ids, labels, mask, t = batch
    assert ids.shape == (2, 2 + 16 + 1 + 8 + 1 + 16 + 1 + 8)
    assert (mask == 0).any()                   # padded text tails

    def jax_loss(p):                           # the JAX trainer's loss_fn
        logits = JL.llada_forward(p, jcfg, jnp.asarray(ids.numpy()),
                                  jnp.asarray(mask.numpy()).astype(bool))
        out = m_interleave_loss(logits, jnp.asarray(labels.numpy()),
                                jnp.asarray(t.numpy()), 8, 16, 1.0, 1.0)
        return out["loss"], out
    (jl, jout), jg = jax.value_and_grad(jax_loss, has_aux=True)(jp)

    leaves = PPS._flatten(tp)
    for v in leaves.values():
        v.requires_grad_(True)
    loss, out = PTM.make_loss_fn(tcfg, cfg)(tp, batch, None)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    for k in ("text_loss", "image_loss"):
        np.testing.assert_allclose(float(out[k].detach()), float(jout[k]),
                                   **TOL)
    jgrads = PPS._flatten(jax.tree_util.tree_map(np.asarray, jg))
    assert sorted(jgrads) == sorted(leaves)
    for k, v in leaves.items():
        want = jgrads[k]
        np.testing.assert_allclose(
            v.grad.numpy(), want, rtol=1e-4,
            atol=1e-5 * max(float(np.abs(want).max()), 1e-12), err_msg=k)
        v.grad = None
        v.requires_grad_(False)


def test_batch_prompt_half_and_mask_equal_jax():
    """At the recipe's sizes (1024 image tokens, 256 text slots, one row)
    the sequence is 2 + 1024 + 1 + 256 + 1 + 1024 + 1 + 256 = 2565 long;
    its prompt half and its key-padding mask equal the JAX builder's on the
    same codes, texts and numpy dropout stream."""
    cfg = _cfg(**{"dataset.preprocessing.max_seq_length": 256,
                  "model.mmada.num_vq_tokens": 1024,
                  "training.batch_size": 1})
    group = _samples(1, res=64)
    tok = FakeTokenizer()
    ids, labels, mask, t = PTM.assemble_batch(
        group, _codes, tok, UniversalPrompting(tok, max_text_len=256),
        torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
    assert ids.shape == labels.shape == mask.shape == (1, 2565)
    codes_in = _codes(group[0]["pixels_in"]).numpy() + T.vq_offset
    out_text = np.full((1, 256), T.eos)
    jseq, jlab, jmask = JUniversalPrompting(tok, max_text_len=256).interleave(
        codes_in, [group[0]["instruction"]], np.zeros((1, 1024), np.int64),
        out_text, out_text, cond_dropout_prob=0.3,
        output_text_lengths=[2], is_text_only=[False])
    half = 2 + 1024 + 1 + 256
    np.testing.assert_array_equal(ids[:, :half].numpy(), jseq[:, :half])
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert (labels[:, :half] == -100).all()
    assert 0 < float(t) <= 1


def _pair_shard(path, n=8, size=16):
    def png(color):
        b = io.BytesIO()
        Image.new("RGB", (size, size), color).save(b, format="PNG")
        return b.getvalue()
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            for name, payload in [
                    (f"p{i:02d}.input.jpg", png((10 * i, 0, 0))),
                    (f"p{i:02d}.output.jpg", png((0, 10 * i, 0))),
                    (f"p{i:02d}.input_text.txt", f"edit {i}".encode()),
                    (f"p{i:02d}.output_text.txt", f"done {i}".encode())]:
                ti = tarfile.TarInfo(name)
                ti.size = len(payload)
                tf.addfile(ti, io.BytesIO(payload))


def test_main_runs_from_a_shard_and_resumes(tmp_path, capsys):
    """``tests/test_training.py::test_train_m_main_loop_edit_pairs`` on the
    port, with ``device=cpu``: two steps on a tiny paired shard land a
    checkpoint; a second run to step 3 resumes from it."""
    path = tmp_path / "pairs-000.tar"
    _pair_shard(path)
    out = tmp_path / "out"
    args = ["tiny_debug=true", f"shards={path}", f"output_dir={out}",
            "device=cpu", "dataset.preprocessing.max_seq_length=8",
            "dataset.preprocessing.resolution=8",
            "model.mmada.num_vq_tokens=16", "training.batch_size=2",
            "training.gradient_accumulation_steps=1",
            "training.save_every=2", "training.log_every=1",
            "training.warmup_steps=1"]
    PTM.main(args + ["training.max_train_steps=2"])
    assert sorted(os.listdir(out / "ckpt")) == ["2"]
    printed = capsys.readouterr().out
    assert "step 2:" in printed and "[done] 2 steps" in printed
    PTM.main(args + ["training.max_train_steps=3"])
    printed = capsys.readouterr().out
    assert "[resume] step 2" in printed and "[done] 3 steps" in printed
    assert sorted(os.listdir(out / "ckpt")) == ["2", "3"]


def test_train_loop_accumulates_and_counts_epochs():
    """``train_loop`` over a list of decoded samples: groups of batch x
    accumulation samples, a new epoch when the list runs out, one history
    entry per step with the JAX loop's scalars, the state's step advanced;
    a stream too short for one group raises."""
    cfg = _cfg(**{"training.max_train_steps": 3,
                  "training.gradient_accumulation_steps": 2,
                  "training.batch_size": 1, "training.log_every": 1})
    mcfg = PL.LLaDAConfig.tiny(vocab_size=T.full_vocab_size,
                               mask_token_id=T.mask, remat="whole_layer")
    params = PL.init_llada_params(mcfg, torch.Generator().manual_seed(0))
    models = PTM.Models(mcfg, params, FakeTokenizer(), None, None)
    models.get_code = _codes
    state, step, sched = PTM.build_train_step(mcfg, params, cfg)
    seen = []

    def counted(state, batch):
        seen.append(batch[0].shape)
        return step(state, batch)
    state, hist = PTM.train_loop(cfg, state, counted, _samples(5), models,
                                 sched, torch.Generator().manual_seed(0))
    assert state.step == 3 and len(hist) == 3
    assert seen == [(2, 53)] * 3          # 5 samples: 2 groups an epoch
    assert set(hist[0]) == {"loss", "text_loss", "image_loss", "grad_norm",
                            "nonfinite", "lr", "batch_time"}
    assert all(np.isfinite(h["loss"]) for h in hist)
    with pytest.raises(RuntimeError, match="no batches"):
        PTM.train_loop(_cfg(**{"training.max_train_steps": 5}), state,
                       step, _samples(1), models, sched,
                       torch.Generator().manual_seed(0))


class ValTok:
    """The JAX validator test's tokenizer."""
    bos_token_id = 1

    def __call__(self, t, **kw):
        return {"input_ids": [10 + ord(c) % 50 for c in t[:12]]}

    def decode(self, ids, **kw):
        return " ".join(str(i) for i in ids)


def test_mmu_and_chat_validators_equal_jax(tmp_path):
    """``tests/test_training.py::test_train_m_validators``' inputs through
    both packages with the same weights: the same jsonl rows."""
    jcfg = JL.LLaDAConfig.tiny(d_model=32, n_heads=2, n_kv_heads=2,
                               n_layers=1, mlp_hidden_size=64,
                               vocab_size=512)
    jp = JL.init_llada_params(jax.random.key(0), jcfg)
    tcfg = PL.LLaDAConfig.tiny(d_model=32, n_heads=2, n_kv_heads=2,
                               n_layers=1, mlp_hidden_size=64,
                               vocab_size=512)
    tp = llada_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    jvq = JMV.MagvitConfig.tiny()
    jvp = JMV.init_magvit_params(jax.random.key(1), jvq)
    models = PTM.Models(tcfg, tp, ValTok(), PMV.MagvitConfig.tiny(),
                        magvit_params_from_jax(
                            jax.tree_util.tree_map(np.asarray, jvp)))
    img_root = tmp_path / "imgs"
    img_root.mkdir()
    Image.new("RGB", (16, 16), (90, 10, 10)).save(img_root / "a.png")
    pf = tmp_path / "mmu.json"
    pf.write_text(json.dumps([
        {"file_name": "a.png",
         "messages": [{"role": "user", "content": "what is shown"}]},
        {"file_name": "missing.png", "messages": []}]))
    jl = tmp_path / "chat.jsonl"
    jl.write_text('{"question": "hello there"}\n{"question": "and you"}\n')
    rows = {}
    for name in ("port", "jax"):
        cfg = NS(output_dir=str(tmp_path / name),
                 dataset=NS(params=NS(mmu_validation_prompts_file=str(pf),
                                      mmu_image_root=str(img_root),
                                      lm_chat_validation_jsonl=str(jl)),
                            preprocessing=NS(max_seq_length=16,
                                             resolution=16)))
        if name == "port":
            PTM._validate_mmu(tp, tcfg, models.get_code, ValTok(), cfg, 7)
            PTM._validate_chat(tp, tcfg, ValTok(), cfg, 7)
        else:
            get_code = jax.jit(lambda px: JMV.magvit_get_code(jvp, jvq, px))
            JTM._validate_mmu(jp, jcfg, get_code, ValTok(), cfg, 7)
            JTM._validate_chat(jp, jcfg, ValTok(), cfg, 7)
        out = tmp_path / name / "validation"
        rows[name] = [[json.loads(line) for line in open(out / f)]
                      for f in ("mmu_step0000007.jsonl",
                                "chat_step0000007.jsonl")]
    assert rows["port"] == rows["jax"]
    mmu, chat = rows["port"]
    assert len(mmu) == 1 and mmu[0]["file_name"] == "a.png"
    assert [r["question"] for r in chat] == ["hello there", "and you"]


def test_interleave_validator_writes_its_sample(tmp_path):
    """``_validate`` on the tiny backbone (full M vocab) and a narrow
    13-bit MagViT-v2: the PNG of the generated image and its text, with
    one pipeline kept across calls."""
    mcfg = PL.LLaDAConfig.tiny(vocab_size=T.full_vocab_size,
                               mask_token_id=T.mask)
    params = PL.init_llada_params(mcfg, torch.Generator().manual_seed(0))
    vq_cfg = PMV.MagvitConfig(ch=16, enc_ch_mult=(1, 2), enc_blocks=(1, 1),
                              dec_ch_mult=(1, 2), dec_blocks=(1, 1),
                              z_channels=13, groups=4)
    vq = PMV.init_magvit_params(vq_cfg, torch.Generator().manual_seed(1))
    cfg = _cfg(output_dir=str(tmp_path))
    img = (np.random.default_rng(0).random((8, 8, 3)) * 255).astype(np.uint8)
    sample = {"instruction": "add a hat", "input_image": img}
    for step in (5, 6):
        PTM._validate(params, mcfg, vq, vq_cfg, FakeTokenizer(), sample, cfg,
                      step)
    pipe = PTM._validate._pipe[1]
    for step in (5, 6):
        png = Image.open(tmp_path / "validation" / f"step{step:07d}.png")
        assert png.size == (8, 8)
        text = (tmp_path / "validation" / f"step{step:07d}.txt").read_text()
        assert text and all(w.isdigit() for w in text.split())
    PTM._validate(params, mcfg, vq, vq_cfg, FakeTokenizer(), sample,
                  _cfg(output_dir=str(tmp_path),
                       **{"dataset.preprocessing.max_seq_length": 4}), 7)
    assert PTM._validate._pipe[1] is not pipe        # new shapes: rebuilt
    assert PTM._validate._pipe[1].max_seq_length == 4


@pytest.mark.parametrize("override", ["mesh.fsdp=2", "mesh.tensor=2",
                                      "training.shard_strategy=zero2"])
def test_multi_device_settings_raise(tmp_path, override):
    with pytest.raises(SystemExit, match="item 16"):
        PTM.main(["tiny_debug=true", f"output_dir={tmp_path}", "device=cpu",
                  override])


def test_missing_card_raises(tmp_path, monkeypatch):
    """The default device is the card; without one the CLI raises rather
    than training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert PTM.DEFAULTS["device"] == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PTM.main(["tiny_debug=true", f"output_dir={tmp_path}"])


@pytest.mark.parametrize("shape,beta", [((2, 4, 4, 13), 0.25),
                                        ((3, 5, 7), 0.5), ((64, 4), 0.25)])
def test_lfq_losses_and_gradients_equal_jax(shape, beta):
    """Values to rtol 1e-5; gradient elements to rtol 1e-5 with atol 1e-5
    of the largest element (an element that is the difference of two
    entropy terms of the largest's size keeps their f32 rounding)."""
    z = np.random.default_rng(sum(shape)).normal(0, 1.2, shape).astype(
        np.float32)
    want = JMV.lfq_losses(jnp.asarray(z), beta)
    zt = torch.tensor(z, requires_grad=True)
    got = PMV.lfq_losses(zt, beta)
    for k in ("entropy_loss", "commit_loss"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5, atol=1e-7)
        g = torch.autograd.grad(got[k], zt, retain_graph=True)[0]
        jg = jax.grad(lambda zz: JMV.lfq_losses(zz, beta)[k])(jnp.asarray(z))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jg).max()))


def test_masking_bucket_metrics_equal_jax():
    from mmada_parallel_torch.utils.diagnostics import \
        masking_bucket_metrics as port
    from mmada_parallel_tpu.utils.diagnostics import \
        masking_bucket_metrics as ref
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (6, 10, 33)).astype(np.float32)
    labels = np.where(rng.random((6, 10)) < 0.5,
                      rng.integers(0, 33, (6, 10)), -100)
    labels[3] = -100                            # a row with no labels
    frac = np.asarray([0.05, 0.15, 0.15, 0.55, 0.95, 1.0], np.float32)
    got = port(torch.tensor(logits), torch.tensor(labels), torch.tensor(frac))
    want = ref(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(frac))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def _jax_tree():
    return {"wte": jnp.arange(12, dtype=jnp.float32).reshape(3, 4) / 7,
            "blocks": {"w": jnp.ones((2, 3), jnp.bfloat16) * 1.5,
                       "n": jnp.arange(3, dtype=jnp.int32)},
            "list": [jnp.full((2,), 0.25), {"x": jnp.zeros((1,))}]}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_param_store_across_packages(tmp_path, writer):
    """A store written by either package loads in both, bit for bit, each
    leaf in its template's dtype (bf16 through the exact f32 upcast)."""
    jtree = _jax_tree()
    ttree = {"wte": torch.tensor(np.asarray(jtree["wte"])),
             "blocks": {"w": torch.full((2, 3), 1.5, dtype=torch.bfloat16),
                        "n": torch.arange(3, dtype=torch.int32)},
             "list": [torch.full((2,), 0.25), {"x": torch.zeros(1)}]}
    path = str(tmp_path / "sub" / "p.npz")
    if writer == "port":
        PPS.save_params(path, ttree)
    else:
        JPS.save_params(path, jtree)
    got = PPS.load_params(path, ttree)
    assert got["blocks"]["w"].dtype == torch.bfloat16
    for k, v in PPS._flatten(got).items():
        want = PPS._flatten(ttree)[k]
        assert v.dtype == want.dtype and torch.equal(v, want), k
    back = JPS.load_params(path, jtree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(jtree)[0])
    with pytest.raises(KeyError, match="shape drift"):
        PPS.load_params(path, dict(ttree, wte=torch.zeros(4, 3)))


def test_determinism_helpers(monkeypatch):
    from mmada_parallel_torch.utils import determinism as D
    D.set_seed(3)
    a = (np.random.rand(), torch.rand(2))
    D.set_seed(3)
    b = (np.random.rand(), torch.rand(2))
    assert a[0] == b[0] and torch.equal(a[1], b[1])
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    cudnn = torch.backends.cudnn
    before = (torch.are_deterministic_algorithms_enabled(),
              cudnn.deterministic, cudnn.benchmark)
    try:
        D.enable_full_determinism(4)
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        assert cudnn.deterministic and not cudnn.benchmark
    finally:
        torch.use_deterministic_algorithms(before[0])
        cudnn.deterministic, cudnn.benchmark = before[1:]


def test_profiling_helpers(tmp_path):
    from mmada_parallel_torch.utils import profiling as P
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": [x * 2]}
    out = P.time_fn(fn, torch.ones(3), iters=3, warmup=2)
    assert set(out) == {"compile_s", "mean_s", "min_s"} and len(calls) == 5
    assert 0 <= out["min_s"] <= out["mean_s"]
    with P.trace(str(tmp_path)):
        torch.ones(8).sum()
    assert any(f.endswith(".json") for _, _, fs in os.walk(tmp_path)
               for f in fs)
    timer = P.StepTimer()
    timer.data_done()
    assert set(timer.step_done()) == {"data_time", "step_time"}
