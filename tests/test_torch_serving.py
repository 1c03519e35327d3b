"""The port's continuous-batching servers (``serving.py``) and HTTP CLI
(``cli/serve.py``) on the CPU.  Each of the four servers takes ragged
requests from several threads into one batch; every row must equal its solo
run through the port's sampler and the JAX server's result with bridged
weights (temperature 0).  Also: bucketing and request guards, ``warmup``
recording its buckets, batched image encodes on the worker, the HTTP
endpoints of ``python -m mmada_parallel_torch.cli.serve --tiny_model
--device cpu`` on an ephemeral port (``--quant`` among them), and the flags
that refuse."""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import jax
import pytest
import torch

from mmada_parallel_tpu import serving as JS
from mmada_parallel_tpu import tokens as tk
from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_tpu.samplers import interleave as JI
from mmada_parallel_tpu.samplers import mmu as JM
from mmada_parallel_tpu.samplers import parallel_ti2ti as JT
from mmada_parallel_tpu.samplers import t2i as JT2I
from mmada_parallel_torch import serving as TS
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models.from_jax import llada_params_from_jax
from mmada_parallel_torch.samplers import interleave as TI
from mmada_parallel_torch.samplers import mmu as TM
from mmada_parallel_torch.samplers import parallel_ti2ti as TT
from mmada_parallel_torch.samplers import t2i as TT2I

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TVS, CB, MASK, NEWLINE = 256, 32, 250, 251
TOK = tk.VariantATokens(mask=MASK, newline=NEWLINE, answer_start=252,
                        answer_end=253, boi=254, eoi=255, uncondition=249,
                        pad=248, text_vocab_size=TVS, codebook_size=CB)
TOK_M = tk.VariantMTokens(mask=250, soi=251, eoi=252, bos=249, eos=248,
                          interleave=247, text_vocab_size=TVS,
                          codebook_size=CB)
A_OPTS = dict(text_steps=8, timesteps=4, temperature=0.0,
              text_temperature=0.0, cfg_scale=0.0, cfg_img=2.0,
              text_vocab_size=TVS, codebook_size=CB, mask_token=MASK)
SERVE = dict(grid_hw=(2, 3), text_gen_length=8, end_token_ids=(9,),
             batch_size=3, max_wait_ms=300.0, bucket_quantum=8,
             max_prompt_len=64)
M_OPTS = dict(text_steps=8, image_steps=4, text_cfg=1.5, image_cfg=2.0,
              text_temperature=0.0, image_temperature=0.0,
              text_vocab_size=TVS, codebook_size=CB, mask_token=250)
T2I_OPTS = dict(timesteps=4, temperature=0.0, guidance_scale=1.5,
                text_vocab_size=TVS, codebook_size=CB, mask_token=MASK)
MMU_OPTS = dict(max_new_tokens=8, steps=8, block_length=4, temperature=0.0,
                cfg_scale=0.0, mask_token=MASK)
N_VQ, MSL = 6, 8
T2I_NVQ = N_VQ
UI = np.asarray([10, 11, 12], np.int32)       # A image-uncond prefix


@pytest.fixture(scope="module")
def model():
    kw = dict(d_model=32, n_heads=2, n_kv_heads=2, n_layers=1,
              mlp_hidden_size=64, vocab_size=TVS + CB, mask_token_id=MASK)
    jcfg, tcfg = JL.LLaDAConfig.tiny(**kw), TL.LLaDAConfig.tiny(**kw)
    jp = JL.init_llada_params(jax.random.key(7), jcfg)
    return jcfg, tcfg, jp, llada_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp))


def _concurrently(server, requests):
    """Submit every ``(args, kwargs)`` request from its own thread."""
    out = [None] * len(requests)

    def call(i):
        a, kw = requests[i]
        out[i] = server.submit(*a, timeout=300, **kw)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _both(jserver, tserver, requests, keys):
    """The requests through the JAX server and the port's; the port's rows
    must equal JAX's on ``keys``.  Returns the port's results."""
    try:
        want = _concurrently(jserver, requests)
        got = _concurrently(tserver, requests)
    finally:
        jserver.close()
        tserver.close()
    for i, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]),
                                          err_msg=f"row {i} {k}")
    return got


# ---------------------------------------------------------------------------
# TI2TIServer
# ---------------------------------------------------------------------------


def _a_solo(tcfg, tp, prompt):
    ids, lay = tk.assemble_ti2ti_sequence(list(prompt), 8, 2, 3, [9],
                                          tokens=TOK)
    fin, codes = TT.generate_ti2ti(tp, tcfg, torch.tensor(ids[None]), lay,
                                   TT.TI2TIOptions(**A_OPTS),
                                   uncond_image_prefix=UI)
    return fin[0, lay.text_start:lay.text_end].numpy(), codes[0].numpy()


def _a_servers(model):
    jcfg, tcfg, jp, tp = model
    return (JS.TI2TIServer(jp, jcfg, JT.TI2TIOptions(**A_OPTS),
                           JS.ServeConfig(**SERVE), uncond_image_prefix=UI,
                           tokens=TOK),
            TS.TI2TIServer(tp, tcfg, TT.TI2TIOptions(**A_OPTS),
                           TS.ServeConfig(**SERVE), uncond_image_prefix=UI,
                           tokens=TOK))


def test_ti2ti_server_batch_matches_solo_and_jax(model):
    _, tcfg, _, tp = model
    prompts = [list(range(10, 15)), list(range(30, 38)), list(range(60, 66))]
    js, ts = _a_servers(model)
    got = _both(js, ts, [((p,), {}) for p in prompts], ["text_ids", "codes"])
    for i, p in enumerate(prompts):
        text, codes = _a_solo(tcfg, tp, p)
        np.testing.assert_array_equal(got[i]["text_ids"], text)
        np.testing.assert_array_equal(got[i]["codes"], codes)
        assert got[i]["text"] == [int(t) for t in text]   # no tokenizer
    st = ts.stats()
    assert st["requests"] == 3 and st["batches"] <= 2


def test_ti2ti_server_bucketing_guards_and_warmup(model):
    _, tcfg, _, tp = model
    server = TS.TI2TIServer(tp, tcfg, TT.TI2TIOptions(**A_OPTS),
                            TS.ServeConfig(**SERVE), uncond_image_prefix=UI,
                            tokens=TOK)
    try:
        with pytest.raises(ValueError, match="max_prompt_len"):
            server.submit(list(range(100)))
        server.warmup([5, 7])           # one bucket: 8
        assert server.warm_buckets == {8}
        # buckets 8 and 16 each serve their solo results
        for prompt in (list(range(10, 13)), list(range(10, 22))):
            r = server.submit(prompt, timeout=300)
            text, codes = _a_solo(tcfg, tp, prompt)
            np.testing.assert_array_equal(r["text_ids"], text)
            np.testing.assert_array_equal(r["codes"], codes)
        assert server.stats()["batches"] == 2
        assert TS._round_bucket(3, 8, 64) == 8
        assert TS._round_bucket(100, 8, 64) == 64
    finally:
        server.close()


# ---------------------------------------------------------------------------
# InterleaveServer
# ---------------------------------------------------------------------------


def _m_solo(tcfg, tp, instr, codes):
    """Single-row oracle of the reference template: the uncond instruction
    ``[bos, eos]`` eos-padded (attended) to the cond length."""
    instr = [TOK_M.bos] + list(instr) + [TOK_M.eos]
    head = [TOK_M.interleave, TOK_M.soi] + [int(c) for c in codes] \
        + [TOK_M.eoi]
    un_head = [TOK_M.interleave, TOK_M.soi] + [0] * N_VQ + [TOK_M.eoi]
    un_tail = [TOK_M.bos, TOK_M.eos] + [TOK_M.eos] * (len(instr) - 2)
    ids, lay = tk.assemble_interleave_sequence(head + instr, N_VQ, MSL,
                                               tokens=TOK_M)
    un, _ = tk.assemble_interleave_sequence(un_head + un_tail, N_VQ, MSL,
                                            tokens=TOK_M)
    fin, out = TI.interleave_generate(tp, tcfg, torch.tensor(ids[None]),
                                      torch.tensor(un[None]), lay,
                                      TI.InterleaveOptions(**M_OPTS))
    return fin[0, lay.text_start:lay.text_end].numpy(), out[0].numpy()


M_SERVER = dict(num_vq_tokens=N_VQ, max_seq_length=MSL, batch_size=3,
                max_wait_ms=300.0, bucket_quantum=8, tokens=TOK_M)


@pytest.mark.parametrize("use_cache", [False, True])
def test_interleave_server_batch_matches_solo_and_jax(model, use_cache):
    """Exact: three ragged instructions in one bucket.  Cached with every
    step refreshing (the exact trajectory): exact-length groups."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(3)
    reqs = [(list(range(10, 14)), rng.integers(TVS, TVS + CB, N_VQ)),
            (list(range(30, 37)), rng.integers(TVS, TVS + CB, N_VQ)),
            (list(range(60, 62)), rng.integers(TVS, TVS + CB, N_VQ))]
    kw = dict(M_SERVER, use_cache=use_cache,
              cache_kw={"refresh_interval": 1, "warmup_ratio": 1.0}
              if use_cache else None)
    js = JS.InterleaveServer(jp, jcfg, JI.InterleaveOptions(**M_OPTS), **kw)
    ts = TS.InterleaveServer(tp, tcfg, TI.InterleaveOptions(**M_OPTS), **kw)
    got = _both(js, ts, [((i,), {"codes": c}) for i, c in reqs],
                ["text_ids", "codes"])
    for i, (instr, codes) in enumerate(reqs):
        text, out = _m_solo(tcfg, tp, instr, codes)
        np.testing.assert_array_equal(got[i]["text_ids"], text)
        np.testing.assert_array_equal(got[i]["codes"], out)
    assert ts.stats()["requests"] == 3


def test_interleave_server_image_encode_guards_and_warmup(model):
    _, tcfg, _, tp = model

    def fake_get_code(px):
        # a deterministic stand-in encoder: mean-pooled pixels mod CB
        return (px.reshape(px.shape[0], -1, N_VQ).mean(dim=1).long() % CB)

    server = TS.InterleaveServer(tp, tcfg, TI.InterleaveOptions(**M_OPTS),
                                 **dict(M_SERVER, batch_size=2),
                                 get_code=fake_get_code)
    try:
        img = np.full((4, N_VQ), 300.0, np.float32)
        r = server.submit(list(range(10, 13)), image=img, timeout=300)
        codes = fake_get_code(torch.tensor(img)[None])[0].numpy() \
            + TOK_M.vq_offset
        text, out = _m_solo(tcfg, tp, list(range(10, 13)), codes)
        np.testing.assert_array_equal(r["text_ids"], text)
        np.testing.assert_array_equal(r["codes"], out)
        with pytest.raises(ValueError, match="exactly one"):
            server.submit([1, 2], codes=codes, image=img)
        with pytest.raises(ValueError, match="server expects"):
            server.submit([1, 2], codes=codes[:3])
        server.warmup([3, 30])          # normalised 5 -> 8, 32 -> 32
        assert server.warm_buckets == {8, 32}
    finally:
        server.close()
    nocode = TS.InterleaveServer(tp, tcfg, TI.InterleaveOptions(**M_OPTS),
                                 **M_SERVER)
    try:
        with pytest.raises(ValueError, match="get_code"):
            nocode.submit([1, 2], image=np.zeros((4, N_VQ), np.float32),
                          timeout=300)
    finally:
        nocode.close()


# ---------------------------------------------------------------------------
# T2IServer and MMUServer
# ---------------------------------------------------------------------------


def _t2i_solo(tcfg, tp, text):
    temp = [TOK_M.t2i, TOK_M.bos] + list(text) + [TOK_M.eos]
    tail = [TOK_M.soi] + [MASK] * N_VQ + [TOK_M.eoi]
    ids = np.asarray(temp + tail, np.int64)
    un = np.asarray([TOK_M.ipad] * (len(temp) - 3)
                    + [TOK_M.t2i, TOK_M.bos, TOK_M.eos] + tail, np.int64)
    um = np.ones(len(ids), bool)
    um[:len(temp) - 3] = False
    return TT2I.t2i_generate(
        tp, tcfg, torch.tensor(ids[None]), torch.tensor(un[None]),
        len(temp), N_VQ, TT2I.T2IOptions(**T2I_OPTS),
        attn_mask=torch.ones((1, len(ids)), dtype=torch.bool),
        uncond_attn_mask=torch.tensor(um[None]))[0].numpy()


def test_t2i_server_batch_matches_solo_and_jax(model):
    jcfg, tcfg, jp, tp = model
    kw = dict(num_vq_tokens=T2I_NVQ, batch_size=2, max_wait_ms=300.0,
              bucket_quantum=8, tokens=TOK_M)
    js = JS.T2IServer(jp, jcfg, JT2I.T2IOptions(**T2I_OPTS), **kw)
    ts = TS.T2IServer(tp, tcfg, TT2I.T2IOptions(**T2I_OPTS), **kw)
    texts = [list(range(10, 13)), list(range(30, 36))]
    got = _both(js, ts, [((t,), {}) for t in texts], ["codes"])
    for i, text in enumerate(texts):
        np.testing.assert_array_equal(got[i]["codes"],
                                      _t2i_solo(tcfg, tp, text))
    guard = TS.T2IServer(tp, tcfg, TT2I.T2IOptions(**T2I_OPTS),
                         **dict(kw, max_text_len=8))
    try:
        with pytest.raises(ValueError, match="max_text_len"):
            guard.submit(list(range(10, 20)))
        guard.warmup([2])               # templated 5 -> bucket 8
        assert guard.warm_buckets == {8}
    finally:
        guard.close()


MMU_PROMPTS = [
    [TOK_M.mmu, TOK_M.soi] + list(range(TVS, TVS + 4))
    + [TOK_M.eoi, TOK_M.bos, 11, 12, TOK_M.eos],
    [TOK_M.mmu, TOK_M.soi] + list(range(TVS + 8, TVS + 12))
    + [TOK_M.eoi, TOK_M.bos, 21, TOK_M.eos],
]


def test_mmu_server_batch_matches_solo_and_jax(model):
    jcfg, tcfg, jp, tp = model
    kw = dict(batch_size=2, max_wait_ms=300.0, bucket_quantum=8,
              tokens=TOK_M)
    js = JS.MMUServer(jp, jcfg, JM.MMUOptions(**MMU_OPTS), **kw)
    ts = TS.MMUServer(tp, tcfg, TM.MMUOptions(**MMU_OPTS), **kw)
    got = _both(js, ts, [((p,), {}) for p in MMU_PROMPTS], ["text_ids"])
    for i, p in enumerate(MMU_PROMPTS):
        want = TM.mmu_generate(tp, tcfg, torch.tensor([p]),
                               TM.MMUOptions(**MMU_OPTS))[0, len(p):]
        np.testing.assert_array_equal(got[i]["text_ids"], want.numpy())
    cfg_server = TS.MMUServer(tp, tcfg, TM.MMUOptions(
        **dict(MMU_OPTS, cfg_scale=1.5)), **dict(kw, max_prompt_len=12))
    try:
        # the CFG forward takes no mask: exact-length groups
        assert cfg_server._bucket_of({"prompt": MMU_PROMPTS[1]}) == 10
        assert ts._bucket_of({"prompt": MMU_PROMPTS[1]}) == 16
        with pytest.raises(ValueError, match="max_prompt_len"):
            cfg_server.submit(list(range(13)))
        cfg_server.warmup([10])
        assert cfg_server.warm_buckets == {10}
    finally:
        cfg_server.close()


# ---------------------------------------------------------------------------
# cli/serve.py
# ---------------------------------------------------------------------------


class _Served:
    """``python -m mmada_parallel_torch.cli.serve`` in a subprocess; the
    port is read from its ``listening on`` line."""

    def __init__(self, argv):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "mmada_parallel_torch.cli.serve",
             "--tiny_model", "--device", "cpu", "--port", "0",
             "--batch_size", "2", "--max_wait_ms", "20"] + argv,
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait_ready(self):
        lines = []
        for line in self.proc.stdout:
            lines.append(line)
            if "listening on" in line:
                self.port = int(line.split(":")[1].split()[0])
                return self
        raise AssertionError("server did not start:\n" + "".join(lines))

    def post(self, path, obj):
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}",
            data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    def get(self, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}",
                                    timeout=60) as r:
            return json.loads(r.read())

    def stop(self):
        self.proc.kill()
        self.proc.wait(timeout=30)


def test_http_serve_cli_both_variants():
    """Variant a answers /edit (and warms a bucket first), variant m
    /interleave, /t2i and /mmu; both /stats.  Real token ids, tiny
    widths."""
    A = tk.TOKENS_A
    M = tk.TOKENS_M
    a = _Served(["--height", "32", "--width", "32", "--text_gen_length", "8",
                 "--timesteps", "2", "--text_steps", "4", "--cfg_img", "0",
                 "--warmup", "5"])
    m = _Served(["--variant", "m", "--num_vq_tokens", "4",
                 "--max_seq_length", "8", "--text_steps", "4",
                 "--image_steps", "2", "--t2i_guidance", "1.5",
                 "--mmu_max_new_tokens", "8", "--mmu_block_length", "4"])
    try:
        a.wait_ready()
        m.wait_ready()
        out = a.post("/edit", {"prompt_ids": list(range(1000, 1005)),
                               "image_tokens": [A.vq_offset + 1] * 3})
        assert len(out["codes"]) == 2 * 2
        assert all(0 <= c < A.codebook_size for c in out["codes"])
        assert isinstance(out["text"], list) and len(out["text"]) == 8
        assert a.get("/stats")["requests"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            a.post("/interleave", {"instr_ids": [1]})
        assert e.value.code == 404

        out = m.post("/interleave", {"instr_ids": list(range(1000, 1004)),
                                     "image_tokens": [1, 5, 9, 2]})
        assert len(out["codes"]) == 4 and len(out["text"]) == 8
        out = m.post("/t2i", {"text_ids": list(range(1000, 1004))})
        assert len(out["codes"]) == 4
        assert all(0 <= c < M.codebook_size for c in out["codes"])
        out = m.post("/mmu", {"prompt_ids": [M.mmu, M.soi]
                              + [M.vq_offset + 1] * 4
                              + [M.eoi, M.bos, 1012, M.eos]})
        assert len(out["text"]) == 8
        assert m.get("/stats")["requests"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            m.post("/mmu", {"question": "what?", "image_tokens": [1]})
        assert e.value.code == 400              # no tokenizer loaded
    finally:
        a.stop()
        m.stop()


@pytest.mark.parametrize("flags,item", [(["--tp_ring", "2"], "item 16"),
                                        (["--tp_ring_int8"], "item 16")])
def test_serve_cli_refuses_unported_flags(flags, item):
    from mmada_parallel_torch.cli import serve
    with pytest.raises(SystemExit, match=item):
        serve.main(["--tiny_model", "--device", "cpu"] + flags)


@pytest.mark.parametrize("quant", ["int8", "int8_bf16head"])
def test_http_serve_cli_quant(quant):
    """``--quant`` serves W8A8 params: an /edit request on the tiny model
    answers with in-range codes and the whole answer span."""
    A = tk.TOKENS_A
    a = _Served(["--quant", quant, "--height", "32", "--width", "32",
                 "--text_gen_length", "8", "--timesteps", "2",
                 "--text_steps", "4", "--cfg_img", "0"])
    try:
        a.wait_ready()
        out = a.post("/edit", {"prompt_ids": list(range(1000, 1005))})
        assert len(out["codes"]) == 2 * 2 and len(out["text"]) == 8
        assert all(0 <= c < A.codebook_size for c in out["codes"])
        assert a.get("/stats")["requests"] == 1
    finally:
        a.stop()


def test_serve_cli_keeps_the_jax_flags():
    from mmada_parallel_tpu.cli import serve as jcli
    from mmada_parallel_torch.cli import serve as tcli

    def flags(parser):
        return {a.dest: a.default for a in parser._actions}

    port = flags(tcli.build_parser())
    assert port.pop("device") == "cuda"
    assert port == flags(jcli.build_parser())


def test_http_serve_cli_image_b64():
    """``--vq_checkpoint tiny``: a base64 image goes through the pipelines'
    encoders (TF32 off) into the Amused-VQ span of an /edit prompt and into
    the MagViT codes of an /interleave request; a bad image is an error
    status and the next request still serves."""
    import base64
    import io
    from PIL import Image
    A = tk.TOKENS_A

    def b64(size, color):
        buf = io.BytesIO()
        Image.new("RGB", (size, size), color).save(buf, "PNG")
        return base64.b64encode(buf.getvalue()).decode()

    a = _Served(["--vq_checkpoint", "tiny", "--height", "32", "--width", "32",
                 "--text_gen_length", "8", "--timesteps", "2",
                 "--text_steps", "4", "--cfg_img", "0"])
    m = _Served(["--variant", "m", "--vq_checkpoint", "tiny",
                 "--resolution", "16", "--num_vq_tokens", "64",
                 "--max_seq_length", "8", "--text_steps", "4",
                 "--image_steps", "2"])
    try:
        a.wait_ready()
        m.wait_ready()
        with pytest.raises(urllib.error.HTTPError) as e:
            a.post("/edit", {"prompt_ids": [1000, 1001],
                             "image_b64": "!!!notb64"})
        assert e.value.code == 500
        out = a.post("/edit", {"prompt_ids": [1000, 1001],
                               "image_b64": b64(40, (40, 120, 220))})
        assert len(out["codes"]) == 2 * 2 and len(out["text"]) == 8
        assert all(0 <= c < A.codebook_size for c in out["codes"])
        out = m.post("/interleave", {"instr_ids": [1000, 1001, 1002],
                                     "image_b64": b64(20, (200, 40, 40))})
        assert len(out["codes"]) == 64 and len(out["text"]) == 8
        assert m.get("/stats")["requests"] == 1
    finally:
        a.stop()
        m.stop()
