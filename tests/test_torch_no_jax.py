"""The port's paths import neither JAX, nor the JAX package, nor PIL.

``tests/conftest.py`` imports jax into every test process, so each check runs
in a subprocess in which importing ``jax``, ``jaxlib`` or
``mmada_parallel_tpu`` raises: it imports the port, runs
tiny generations on the CPU with an array image (PIL is installed here, so
its absence from ``sys.modules`` shows the path never imported it), and
reports what got imported.  The paths: the exact and the cached
``TI2TIPipeline`` edit, and the exact and the cached ``InterleavePipeline``
with an array already at the resolution; and a tiny variant-A train step
(with remat, masking, the M forward and the task bounds); and the imports
of ``chip_smoke.py`` and of the A trainer's CLI, data pipeline and
logging; and the evaluation slice (a jsonl ParaBench export with
``datasets`` blocked too, the edit sweep dense and W8A8, the cached
interleave sweep, a ParaRL rollout and update, the eval and ParaRL CLIs);
and the M trainer's slice (the CLI, the data layer with its native tar
reader and token store, ``lfq_losses``, the utils, and two steps of
``train_m.train_loop``)."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib.abc, json, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mmada_parallel_tpu"):
            raise ImportError(f"{name} is blocked here")
        return None

sys.meta_path.insert(0, Block())

import numpy as np
import torch
torch.set_num_threads(1)
from mmada_parallel_torch import tokens as tk
from mmada_parallel_torch.models import amused_vq as AVQ
from mmada_parallel_torch.models.llada import LLaDAConfig, init_llada_params
from mmada_parallel_torch.pipeline import TI2TIPipeline
from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
from mmada_parallel_torch.cli import infer_a  # imports PIL only in main()

class Tok:
    def __call__(self, t, **kw):
        return {"input_ids": [1] + [10 + ord(c) % 80 for c in t[:8]] + [2]}
    def decode(self, ids, **kw):
        return " ".join(map(str, ids))

g = torch.Generator().manual_seed(0)
cfg = LLaDAConfig.tiny(vocab_size=tk.TOKENS_A.full_vocab_size)
vcfg = AVQ.AmusedVQConfig.tiny()
pipe = TI2TIPipeline(cfg, init_llada_params(cfg, g), vcfg,
                     AVQ.init_amused_vq_params(vcfg, g), Tok())
img = (np.random.default_rng(0).random((16, 16, 3)) * 255).astype(np.uint8)
opts = TI2TIOptions(text_steps=4, timesteps=2, temperature=1.0,
                    text_temperature=0.7, cfg_scale=2.5, cfg_img=4.0,
                    codebook_size=32)
out, text, info = pipe("add a hat", img, 16, 16, opts, text_gen_length=6,
                       seed=3)
_, text_c, info_c = pipe("add a hat", img, 16, 16, opts, text_gen_length=6,
                         seed=3, use_cache=True)

from mmada_parallel_torch.models import magvit2 as MVQ
from mmada_parallel_torch.pipeline import InterleavePipeline
from mmada_parallel_torch.samplers.interleave import InterleaveOptions
from mmada_parallel_torch.cli import infer_m  # imports yaml/PIL in main()
T = tk.VariantMTokens(mask=250, soi=251, eoi=252, bos=249, eos=248,
                      interleave=247, text_vocab_size=256, codebook_size=16)
mcfg = LLaDAConfig.tiny(vocab_size=272, mask_token_id=250)
mvcfg = MVQ.MagvitConfig.tiny()
mpipe = InterleavePipeline(mcfg, init_llada_params(mcfg, g), mvcfg,
                           MVQ.init_magvit_params(mvcfg, g), Tok(), tokens=T,
                           num_vq_tokens=64, max_seq_length=6, resolution=16)
mopts = InterleaveOptions(text_steps=4, image_steps=2, text_temperature=0.7,
                          text_vocab_size=256, codebook_size=16,
                          mask_token=250)
m_runs = [mpipe("add a hat", img, mopts, seed=3, use_cache=c)
          for c in (False, True)]
print(json.dumps({
    "jax": sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "mmada_parallel_tpu")),
    "pil": sorted(m for m in sys.modules if m.split(".")[0] == "PIL"),
    "yaml": "yaml" in sys.modules,
    "image": out is None, "pixels": list(info["pixels"].shape),
    "finite": bool(np.isfinite(info["pixels"]).all()),
    "codes": info["codes"].tolist(), "text": text,
    "cached_codes": info_c["codes"].tolist(), "cached_text": text_c,
    "m": [{"image": o is None, "pixels": list(i["pixels"].shape),
           "finite": bool(np.isfinite(i["pixels"]).all()),
           "codes": i["codes"].tolist(), "text": t} for o, t, i in m_runs]}))
"""


def test_port_main_path_imports_no_jax_and_no_pil():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["jax"] == [] and res["pil"] == [] and not res["yaml"]
    assert res["image"] is True                 # array in -> no PIL image
    assert res["pixels"] == [16, 16, 3] and res["finite"]
    assert all(0 <= c < 32 for c in res["codes"][0])
    assert all(0 <= c < 32 for c in res["cached_codes"][0])
    for t in (res["text"], res["cached_text"]):
        assert isinstance(t, str) and t
    for m in res["m"]:                          # exact, then cached
        assert m["image"] is True
        assert m["pixels"] == [16, 16, 3] and m["finite"]
        assert len(m["codes"][0]) == 64
        assert all(0 <= c < 16 for c in m["codes"][0])
        assert isinstance(m["text"], str) and m["text"]


TRAIN_SCRIPT = r"""
import importlib.abc, json, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mmada_parallel_tpu"):
            raise ImportError(f"{name} is blocked here")
        return None

sys.meta_path.insert(0, Block())

import dataclasses
import torch
torch.set_num_threads(1)
from mmada_parallel_torch.cli.train_a import build_train_step
from mmada_parallel_torch.models.llada import LLaDAConfig, init_llada_params
from mmada_parallel_torch.ops.masks import mixed_prefix_bounds
from mmada_parallel_torch.training import checkpoint, ema, m_tasks, masking

g = torch.Generator().manual_seed(0)
cfg = LLaDAConfig.tiny(vocab_size=512, remat="whole_layer")
state, step, _ = build_train_step(
    cfg, init_llada_params(cfg, g), lr=1e-3, min_lr=0.0, wd=0.1,
    clip_grad=4.0, warmup_steps=1, total_steps=4, accum_steps=2)
codes = torch.randint(0, 512, (4, 24), generator=g)
ids, labels = masking.mask_codes(g, codes, mask_token=cfg.mask_token_id)
losses = []
for _ in range(2):
    state, metrics = step(state, (ids, labels, torch.full((4,), 24)))
    losses.append(float(metrics["loss"]))
m = m_tasks.forward_process(state.params, cfg, ids, labels, 1, 2, 1, 8)
print(json.dumps({
    "jax": sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "mmada_parallel_tpu")),
    "losses": losses, "step": state.step,
    "m_losses": sorted(m), "bounds": list(mixed_prefix_bounds(
        6, 1, 1, 1, ((1, 3),), 2).shape)}))
"""


def test_train_step_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", TRAIN_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["jax"] == [] and res["step"] == 2
    assert all(0 < x < 20 for x in res["losses"])
    assert res["m_losses"] == ["loss_lm", "loss_mmu", "loss_t2i"]
    assert res["bounds"] == [3, 6]


IMPORT_SCRIPT = r"""
import importlib.abc, json, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mmada_parallel_tpu"):
            raise ImportError(f"{name} is blocked here")
        return None

sys.meta_path.insert(0, Block())

import chip_smoke
from mmada_parallel_torch.cli import train_a
# what train_a.main() imports before it reads its data
from mmada_parallel_torch.data import AItemProcessor, MetaDataset
from mmada_parallel_torch.utils.logging import MetricLogger, ScalarWriter
from mmada_parallel_torch.config import load_config
counters = sorted(chip_smoke._launch_counters())
print(json.dumps({
    "jax": sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "mmada_parallel_tpu")),
    "counters": counters, "m_len": chip_smoke._m_sequence_length()}))
"""


def test_chip_smoke_and_train_cli_import_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", IMPORT_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["jax"] == []
    assert res["counters"] == sorted(
        ["flash_attention", "flash_attention_rope",
         "flash_attention_rope_prefix", "flash_attention_rope_qonly"])
    assert res["m_len"] == 2360         # the interleave length chip_smoke uses


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """``chip_smoke.py`` exits non-zero with no result line on a machine
    without CUDA, and in a directory that holds nothing else of the repo."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, str(lone))):
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


SLICE_SCRIPT = r"""
import importlib.abc, json, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mmada_parallel_tpu"):
            raise ImportError(f"{name} is blocked here")
        return None

sys.meta_path.insert(0, Block())

import numpy as np
import torch
torch.set_num_threads(1)
from mmada_parallel_torch import tokens as tk
from mmada_parallel_torch.cli import demo, serve   # PIL/gradio lazily
from mmada_parallel_torch.models.llada import LLaDAConfig, init_llada_params
from mmada_parallel_torch.samplers import (ImageGenOptions, MMUOptions,
                                           T2IOptions, generate_image,
                                           generate_image_cached,
                                           mmu_generate, t2i_generate)
from mmada_parallel_torch.serving import MMUServer

A = tk.VariantATokens(mask=250, newline=251, answer_start=252,
                      answer_end=253, boi=254, eoi=255, uncondition=249,
                      pad=248, text_vocab_size=256, codebook_size=16)
g = torch.Generator().manual_seed(0)
cfg = LLaDAConfig.tiny(vocab_size=272, mask_token_id=250)
params = init_llada_params(cfg, g)
ids, lay = tk.assemble_ti2ti_sequence([5, 6, 7], 0, 2, 2, [], tokens=A)
opts = ImageGenOptions(timesteps=3, temperature=1.0, cfg_scale=2.0,
                       text_vocab_size=256, codebook_size=16, mask_token=250)
un = np.array([60, 61], np.int64)
x = torch.tensor(ids[None])
img = generate_image(params, cfg, x, lay, opts, uncond_ids=un, generator=g)
img_c = generate_image_cached(params, cfg, x, lay, opts, uncond_ids=un,
                              generator=g)
t2i = t2i_generate(params, cfg, torch.tensor([[5, 6, 251, 250, 250, 252]]),
                   torch.tensor([[9, 9, 251, 250, 250, 252]]), 2, 2,
                   T2IOptions(timesteps=3, guidance_scale=1.5,
                              text_vocab_size=256, codebook_size=16,
                              mask_token=250), generator=g)
mopts = MMUOptions(max_new_tokens=4, steps=4, block_length=2,
                   mask_token=250)
mmu = mmu_generate(params, cfg, torch.tensor([[5, 6, 7]]), mopts)
server = MMUServer(params, cfg, mopts, batch_size=2, bucket_quantum=4,
                   tokens=tk.VariantMTokens(mask=250, soi=251, eoi=252,
                                            bos=249, eos=248, interleave=247,
                                            text_vocab_size=256,
                                            codebook_size=16))
answer = server.submit([5, 6, 7], timeout=120)["text_ids"]
server.close()
print(json.dumps({
    "jax": sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "mmada_parallel_tpu")),
    "pil": sorted(m for m in sys.modules if m.split(".")[0] == "PIL"),
    "gradio": "gradio" in sys.modules,
    "codes": [img[1].tolist(), img_c[1].tolist(), t2i.tolist()],
    "mmu": mmu[0, 3:].tolist(), "answer": answer.tolist()}))
"""


def test_new_samplers_server_and_clis_import_no_jax():
    """Text-to-image (exact and cached), variant-M T2I, MMU, one server
    round trip, and the imports of the demo and serving CLIs, with the JAX
    imports blocked; neither PIL nor gradio is imported on these paths."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SLICE_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["jax"] == [] and res["pil"] == [] and not res["gradio"]
    for codes in res["codes"]:
        assert all(0 <= c < 16 for row in codes for c in row)
    assert len(res["codes"][0][0]) == 4 and len(res["codes"][2][0]) == 2
    assert 250 not in res["mmu"] and res["answer"] == res["mmu"]


EVAL_SCRIPT = r"""
import importlib.abc, json, sys, tempfile, os

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mmada_parallel_tpu",
                                  "datasets"):
            raise ImportError(f"{name} is blocked here")
        return None

sys.meta_path.insert(0, Block())

import numpy as np
import torch
torch.set_num_threads(1)
from mmada_parallel_torch import tokens as tk
from mmada_parallel_torch.cli import eval_sweep, train_pararl
from mmada_parallel_torch.data.parabench import (load_parabench,
                                                 parabench_requests)
from mmada_parallel_torch.eval_scorers import default_edit_scorer
from mmada_parallel_torch.evaluation import (EvalRequest,
                                             InterleaveEvalRequest,
                                             run_interleave_sweep,
                                             run_parabench_sweep)
from mmada_parallel_torch.models.llada import LLaDAConfig, init_llada_params
from mmada_parallel_torch.ops.quant import quantize_llada_params
from mmada_parallel_torch.samplers.interleave import InterleaveOptions
from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
from mmada_parallel_torch.training.pararl import RewardSpec, \
    code_diversity_reward

A = tk.VariantATokens(mask=250, newline=251, answer_start=252,
                      answer_end=253, boi=254, eoi=255, uncondition=249,
                      pad=248, text_vocab_size=256, codebook_size=32)
M = tk.VariantMTokens(mask=250, soi=251, eoi=252, bos=249, eos=248,
                      interleave=247, text_vocab_size=256, codebook_size=32)
path = os.path.join(tempfile.mkdtemp(), "pb.jsonl")
with open(path, "w") as f:
    f.write(json.dumps({"instruction": "add a hat", "id": 0}) + "\n")
    f.write(json.dumps({"instruction": "paint it red",
                        "output_text": "a red barn"}) + "\n")
raw = parabench_requests(load_parabench(path), "edit",
                         lambda s: [10 + ord(c) % 90 for c in s[:6]])
g = torch.Generator().manual_seed(0)
cfg = LLaDAConfig.tiny(vocab_size=288, mask_token_id=250)
params = init_llada_params(cfg, g)
opts = TI2TIOptions(text_steps=4, timesteps=2, temperature=0.0,
                    text_temperature=0.0, cfg_img=0.0, text_vocab_size=256,
                    codebook_size=32, mask_token=250)
reqs = [EvalRequest(r["prompt_ids"], r["meta"]) for r in raw]
sweeps = [run_parabench_sweep(p, cfg, reqs, (2, 2), 4, [253], opts,
                              batch_size=2, tokens=A,
                              scorer=default_edit_scorer())
          for p in (params, quantize_llada_params(params))]
m_opts = InterleaveOptions(text_steps=4, image_steps=2, text_vocab_size=256,
                           codebook_size=32, mask_token=250)
inter = run_interleave_sweep(
    params, cfg, [InterleaveEvalRequest([10, 11], codes=np.arange(4) + 256)],
    num_vq_tokens=4, opts=m_opts, max_seq_length=4, batch_size=1, tokens=M,
    use_cache=True)
seqs, lay = train_pararl.rollout_sequences([[5, 6, 7]], A, 2, 4)
rl_opts = TI2TIOptions(text_steps=4, timesteps=2, text_temperature=0.7,
                       cfg_img=0.0, text_vocab_size=256, codebook_size=32,
                       mask_token=250)
state, step = train_pararl.build_update(
    cfg, params, rl_opts, 1e-4, train_pararl.subsample_steps(4, 2))
batch = train_pararl.rollout_and_score(
    state.params, cfg, torch.as_tensor(seqs.repeat(2, 0)), lay, rl_opts,
    RewardSpec([code_diversity_reward], [1.0]), g)
state, metrics = step(state, batch, g)
print(json.dumps({
    "blocked": sorted(m for m in sys.modules if m.split(".")[0] in
                      ("jax", "jaxlib", "mmada_parallel_tpu", "datasets",
                       "PIL")),
    "texts": [[r["text"] for r in s["results"]] for s in sweeps],
    "codes": [[r["codes"].tolist() for r in s["results"]] for s in sweeps],
    "keywords": raw[1]["meta"]["keywords"],
    "inter": inter["results"][0]["codes"].tolist(),
    "loss": float(metrics["loss"]), "step": state.step}))
"""


def test_eval_quant_and_pararl_import_no_jax():
    """The evaluation slice with ``jax``, the JAX package and ``datasets``
    blocked: a jsonl ParaBench export adapted into requests, the edit sweep
    on dense and on W8A8 params, the cached interleave sweep, one ParaRL
    rollout and update, and the imports of the eval and ParaRL CLIs; PIL
    is never imported on these paths."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", EVAL_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["blocked"] == []
    for texts, codes in zip(res["texts"], res["codes"]):
        assert len(texts) == 2 and all(len(t) == 4 for t in texts)
        assert all(0 <= c < 32 for row in codes for c in row)
    assert res["keywords"] == ["barn"]
    assert len(res["inter"]) == 4 and all(0 <= c < 32 for c in res["inter"])
    assert res["step"] == 1 and abs(res["loss"]) < 1e6       # finite


TRAIN_M_SCRIPT = r"""
import importlib.abc, json, os, sys, tarfile, tempfile, io

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mmada_parallel_tpu"):
            raise ImportError(f"{name} is blocked here")
        return None

sys.meta_path.insert(0, Block())

import numpy as np
import torch
torch.set_num_threads(1)
from mmada_parallel_torch import tokens as tk
from mmada_parallel_torch.cli import train_m
from mmada_parallel_torch.config import load_config
from mmada_parallel_torch.data import (imagenet, pretokenize, prompting,
                                       shards, tarstream, tokenizer,
                                       tokenstore)
from mmada_parallel_torch.models import magvit2 as MVQ
from mmada_parallel_torch.models.llada import LLaDAConfig, init_llada_params
from mmada_parallel_torch.utils import (determinism, diagnostics,
                                        param_store, profiling)

tmp = tempfile.mkdtemp()
shard = os.path.join(tmp, "s-000.tar")
with tarfile.open(shard, "w") as tf:
    for name, payload in [("a.txt", b"hi"), ("a.bin", b"\x00\x01"),
                          ("b.txt", b"there")]:
        ti = tarfile.TarInfo(name); ti.size = len(payload)
        tf.addfile(ti, io.BytesIO(payload))
native = [{k: (v.decode() if isinstance(v, bytes) else v)
           for k, v in s.items() if k != "__url__"}
          for s in shards.ShardReader([shard])]
store = os.path.join(tmp, "t.tokstore")
tokenstore.write_token_store(store, [[1, 2, 3], [4]])
rows, lens = tokenstore.TokenStore(store).gather([1, 0], 4, pad=-1)

class Tok:
    bos_token_id, eos_token_id = tk.TOKENS_M.bos, tk.TOKENS_M.eos
    def __call__(self, t, **kw):
        if isinstance(t, list):
            return {"input_ids": [self(x)["input_ids"] for x in t]}
        return {"input_ids": [10 + ord(c) % 50 for c in t[:8]]}

T = tk.TOKENS_M
cfg = load_config(None, ["dataset.preprocessing.max_seq_length=8",
                         "dataset.preprocessing.resolution=8",
                         "model.mmada.num_vq_tokens=16",
                         "training.batch_size=1",
                         "training.gradient_accumulation_steps=2",
                         "training.max_train_steps=2"], train_m.DEFAULTS)
g = torch.Generator().manual_seed(0)
mcfg = LLaDAConfig.tiny(vocab_size=T.full_vocab_size, mask_token_id=T.mask,
                        remat="whole_layer")
vcfg = MVQ.MagvitConfig.tiny()
models = train_m.Models(mcfg, init_llada_params(mcfg, g), Tok(), vcfg,
                        MVQ.init_magvit_params(vcfg, g))
state, step, sched = train_m.build_train_step(mcfg, models.params, cfg)
rng = np.random.default_rng(0)
samples = [{"pixels_in": rng.uniform(-1, 1, (1, 8, 8, 3)),
            "pixels_out": rng.uniform(-1, 1, (1, 8, 8, 3)),
            "instruction": "add a hat", "output_text": "a hat",
            "is_text_only": False} for _ in range(2)]
state, hist = train_m.train_loop(cfg, state, step, samples, models, sched,
                                 torch.Generator().manual_seed(1))
lfq = MVQ.lfq_losses(torch.randn(4, 13))
print(json.dumps({
    "jax": sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "mmada_parallel_tpu")),
    "pil": sorted(m for m in sys.modules if m.split(".")[0] == "PIL"),
    "native": tarstream.native_available(), "samples": native,
    "rows": rows.tolist(), "lens": lens.tolist(), "step": state.step,
    "losses": [h["loss"] for h in hist], "lfq": sorted(lfq)}))
"""


def test_m_trainer_and_data_layer_import_no_jax():
    """The M trainer's modules (CLI, data layer, native readers, utils)
    with the JAX imports blocked: the native tar reader and token store
    read back what was written, and ``train_m.train_loop`` takes two steps
    of two accumulated microbatches on decoded samples; PIL is never
    imported on these paths."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", TRAIN_M_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["jax"] == [] and res["pil"] == [] and res["native"]
    assert res["samples"] == [{"__key__": "a", "txt": "hi", "bin": "\x00\x01"},
                              {"__key__": "b", "txt": "there"}]
    assert res["rows"] == [[4, -1, -1, -1], [1, 2, 3, -1]]
    assert res["lens"] == [1, 3] and res["step"] == 2
    assert all(0 < x < 100 for x in res["losses"])
    assert res["lfq"] == ["commit_loss", "entropy_loss"]
