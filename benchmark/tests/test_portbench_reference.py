"""The plain reference against the port at tiny sizes on the CPU, in f32:
the same weights (made by the benchmark) give the same hidden states,
logits, codes and pixels, and the same training step.  Tolerances: both
sides compute in f32 and differ in summation order only (matmul blocking,
one-pass against online softmax, GroupNorm's two forms), a few f32 ulps
on values of order 1, grown by the layers they pass."""

import math

import numpy as np
import torch

from benchmark.harness import inputs, weights
from benchmark.reference import amused_vq as RV
from benchmark.reference import llada as R
from benchmark.reference import train as RT

TINY = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            mlp_hidden_size=128, vocab_size=200, embedding_size=256,
            rope_theta=10000.0, rms_norm_eps=1e-5, max_sequence_length=64,
            init_std=0.02)
VQ = {"block_out_channels": [8, 16], "layers_per_block": 1,
      "in_channels": 3, "out_channels": 3, "latent_channels": 8,
      "num_vq_embeddings": 32, "norm_num_groups": 4, "mid_attention": True,
      "eps": 1e-6}


def _program_cfg(**kw):
    from mmada_parallel_torch.models.llada import LLaDAConfig
    return LLaDAConfig(**TINY, param_dtype=torch.float32,
                       compute_dtype=torch.float32, **kw)


def test_llada_forward_and_head():
    from mmada_parallel_torch.models.llada import llada_head, llada_hidden
    p = weights.llada_params(TINY, torch.Generator().manual_seed(1),
                             torch.float32)
    ids = torch.randint(0, 256, (2, 40), generator=torch.Generator()
                        .manual_seed(2))
    with torch.no_grad():
        want = llada_hidden(p, _program_cfg(), ids)
        got = R.hidden(p, TINY, ids)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
        assert torch.allclose(R.head(p, got, 3, 50),
                              llada_head(p, _program_cfg(), want,
                                         vocab_slice=(3, 47)),
                              rtol=1e-5, atol=1e-5)


def test_amused_vq_encode_and_decode():
    from mmada_parallel_torch.models import amused_vq as AVQ
    vcfg = AVQ.AmusedVQConfig(**{**VQ, "block_out_channels": (8, 16)})
    p = weights.amused_vq_params(VQ, torch.Generator().manual_seed(3))
    px = torch.as_tensor(inputs.image(np.random.default_rng(4), 16)
                         ).float()[None] / 255.0
    with torch.no_grad():
        lat = AVQ.amused_encode(p, vcfg, px)
        _, codes = AVQ.amused_quantize(p, vcfg, lat)
        ref_lat = RV.encode_latents(p, VQ, px)
        assert torch.allclose(ref_lat, lat.reshape(-1, 8), atol=1e-5)
        dist = RV.code_distances(p, ref_lat)
        assert torch.equal(dist.argmin(-1), codes[0])
        pix = AVQ.amused_decode_code(p, vcfg, codes, (8, 8))
        assert torch.allclose(RV.decode(p, VQ, codes, (8, 8)), pix,
                              atol=1e-5)


def test_train_step_matches_the_program():
    from mmada_parallel_torch.cli.train_a import build_train_step
    cfg = _program_cfg()
    gen = torch.Generator().manual_seed(5)
    ids = torch.randint(0, 200, (4, 24), generator=gen)
    labels = torch.where(torch.rand(4, 24, generator=gen) < 0.3, ids,
                         torch.full_like(ids, -100))
    labels[:, 0] = ids[:, 0]

    def params():
        return weights.llada_params(TINY, torch.Generator().manual_seed(6),
                                    torch.float32)

    state, step, _ = build_train_step(
        cfg, params(), lr=1e-3, min_lr=0.0, wd=0.1, clip_grad=0.5,
        warmup_steps=1, total_steps=10, accum_steps=2)
    ref = params()
    opt = RT.AdamW(ref, RT.half_cosine(1e-3, 1, 10), 0.9, 0.95, 1e-8, 0.1,
                   0.5)
    for _ in range(2):
        state, m = step(state, (ids, labels, torch.full((4,), 24)))
        loss = RT.a_loss_and_grads(ref, TINY, (ids, labels), 2)
        opt.step(ref)
        assert math.isclose(float(m["loss"]), loss, rel_tol=1e-5)
    # AdamW's update is g / (|g| + eps): an element whose gradient is near
    # zero moves by up to lr on summation order alone, so the parameters
    # agree to a hundredth of lr (1e-5), not to f32's ulp
    for (n, a), (_, b) in zip(RT.leaves(ref), RT.leaves(state.params)):
        assert torch.allclose(a.detach(), b.detach(), atol=1e-5), n
