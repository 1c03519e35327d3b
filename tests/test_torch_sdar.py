"""SDAR-30B-A3B's block on the port, on the CPU at a tiny size, held to the
plain f32 reference (``benchmark/reference/sdar.py``): the forward, the
mixture of experts against its per-expert loop, the prefill and the cached
block decode against the full block-causal forward, the block sampler, and
the presets.

The tiny config keeps every feature: GQA 4:1, a head size (32) apart from
``d_model / n_heads`` (16), the q/k norms, top-2 of 8 experts, block-causal
attention with a prompt that is not a multiple of the block.  Everything is
f32, so the port and the reference differ only in the order of their sums:
1e-5 holds them (the hidden states are O(1)).
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference import sdar as RS
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.ops import moe as M
from mmada_parallel_torch.ops import rope_attention as RA
from mmada_parallel_torch.samplers import mmu as TM

TOL = 1e-5
MASK = 95
CONF = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 1, "head_dim": 32, "num_hidden_layers": 2,
        "num_experts": 8, "num_experts_per_tok": 2,
        "moe_intermediate_size": 32, "norm_topk_prob": True,
        "rms_norm_eps": 1e-6, "rope_theta": 1000000.0, "vocab_size": 96}


def _cfg(**over):
    c = CONF
    return TL.LLaDAConfig.sdar_30b_a3b(
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        n_layers=c["num_hidden_layers"], mlp_hidden_size=96,
        vocab_size=c["vocab_size"], max_sequence_length=64,
        n_experts=c["num_experts"], experts_per_token=c["num_experts_per_tok"],
        moe_hidden_size=c["moe_intermediate_size"], mask_token_id=MASK,
        init_std=0.2, param_dtype=torch.float32,
        compute_dtype=torch.float32, **over)


@pytest.fixture(scope="module")
def model():
    cfg = _cfg()
    params = TL.init_llada_params(cfg, torch.Generator().manual_seed(0))
    # unit norms would hide a swapped q/k norm; draw them apart from 1
    g = torch.Generator().manual_seed(1)
    for name in ("attn_norm", "ff_norm", "q_norm", "k_norm"):
        w = params["blocks"][name]
        w.copy_(1 + 0.3 * torch.randn(w.shape, generator=g))
    return cfg, params


def _ids(n, seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, MASK, (n,), generator=g)


def test_forward_matches_reference(model):
    cfg, params = model
    ids = _ids(14)
    for start in (0, 6):
        hi = TL.block_causal_bounds(14, start, 4)
        got = TL.llada_hidden(params, cfg, ids[None], kv_hi=hi)[0]
        want, _ = RS.hidden(params, CONF, ids, start, 4)
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
        torch.testing.assert_close(TL.llada_head(params, cfg, got),
                                   RS.head(params, want), rtol=TOL,
                                   atol=TOL)
    # a block_causal config without bounds aligns its blocks at 0
    torch.testing.assert_close(TL.llada_hidden(params, cfg, ids[None])[0],
                               RS.hidden(params, CONF, ids, 0, 4)[0],
                               rtol=TOL, atol=TOL)


def test_block_causal_bounds_feed_k4():
    hi = TL.block_causal_bounds(14, 6, 4)
    assert hi.tolist() == [2, 2, 6, 6, 6, 6, 10, 10, 10, 10, 14, 14, 14, 14]
    assert torch.equal(hi.long(), RS.block_bounds(14, 6, 4))
    # the bounds through K4's entry point equal the dense block mask
    from mmada_parallel_torch.ops.attention import rope_attention_prefix
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 14, w, generator=g) for w in (128, 32, 32))
    sin, cos = TL._rope_sin_cos(14, 32, 1e6)
    got = rope_attention_prefix(q, k, v, sin, cos, hi.expand(2, 14),
                                n_heads=4, n_kv_heads=1)
    bias = RS.mask_bias(hi.long(), 14)
    want = TL.rope_attention(q, k, v, sin, cos, bias.expand(2, 1, 14, 14),
                             n_heads=4, n_kv_heads=1)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def _moe_weights(E=8, d=64, m=32, seed=4):
    g = torch.Generator().manual_seed(seed)
    return (0.3 * torch.randn(E, d, m, generator=g),
            0.3 * torch.randn(E, d, m, generator=g),
            0.3 * torch.randn(E, m, d, generator=g))


def _grouped(h, weights, ids, gate, up, down, tile_rows):
    """The card's pipeline with the kernel's plain version: plan, the glu
    launch, the down launch, the combine."""
    k = ids.shape[1]
    p = M.plan(ids, gate.shape[0], tile_rows)
    mid = M.grouped_gemm(h, p, gate, up, top_k=k, glu=True)
    y = M.grouped_gemm(mid, p, down, scale=weights.reshape(-1), top_k=k,
                       glu=False)
    return y.view(h.shape[0], k, -1).sum(1), p


@pytest.mark.parametrize("case", ["uneven", "empty", "one_expert"])
@pytest.mark.parametrize("tile_rows", [M.SMALL_TILE, M.LARGE_TILE])
def test_grouped_experts_match_the_loop(case, tile_rows):
    gate, up, down = _moe_weights()
    T, k = 40, 2
    g = torch.Generator().manual_seed(5)
    h = torch.randn(T, 64, generator=g)
    if case == "uneven":        # expert 0 takes 30 rows, 7 a few, 1-6 some
        first = torch.where(torch.arange(T) < 30, 0, 7)
        ids = torch.stack([first, 1 + torch.arange(T) % 6], 1)
    elif case == "empty":       # experts 2, 5, 6 get nothing
        ids = torch.tensor([[0, 1], [3, 4], [7, 0], [1, 3]]).repeat(10, 1)
    else:
        ids = torch.stack([torch.zeros(T, dtype=torch.long),
                           torch.ones(T, dtype=torch.long)], 1)
    weights = torch.softmax(torch.randn(T, k, generator=g), -1)
    got, p = _grouped(h, weights, ids, gate, up, down, tile_rows)
    want = M.experts_reference(h, weights, ids, gate, up, down)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    counts = torch.bincount(ids.reshape(-1), minlength=8)
    assert p.offsets.tolist() == [0] + torch.cumsum(counts, 0).tolist()
    tiles = (counts + tile_rows - 1) // tile_rows
    assert p.tiles.tolist() == [0] + torch.cumsum(tiles, 0).tolist()
    assert p.tile_bound >= p.tiles[-1]
    # each expert's slots hold its own assignments, in token order
    flat = ids.reshape(-1)
    for e in range(8):
        r = p.rows[p.offsets[e]:p.offsets[e + 1]].long()
        assert bool((flat[r] == e).all()) and bool((r.diff() > 0).all())


def test_router_tie_and_renormalised_weights():
    """Two identical router columns tie exactly: top-k takes one, the
    weights still sum to 1, and the grouped path and the loop agree on
    the choice."""
    gate, up, down = _moe_weights()
    g = torch.Generator().manual_seed(6)
    router = torch.randn(64, 8, generator=g)
    router[:, 5] = router[:, 2]
    h = torch.randn(16, 64, generator=g)
    w, ids = M.route(h, router, 2, True)
    torch.testing.assert_close(w.sum(-1), torch.ones(16))
    assert not bool((ids[:, 0] == ids[:, 1]).any())
    got = M.moe_mlp(h, router, gate, up, down, 2, True)
    grouped, _ = _grouped(h, w, ids, gate, up, down, M.SMALL_TILE)
    torch.testing.assert_close(got, grouped, rtol=TOL, atol=TOL)
    probs = torch.softmax(h @ router, -1)
    rw, rids, _, _ = RS.route(probs, 2, True)
    assert torch.equal(rids, ids)
    torch.testing.assert_close(rw, w)


def test_reference_follows_a_programs_near_tie():
    probs = torch.tensor([[0.5, 0.3, 0.1999, 0.0001],
                          [0.5, 0.3, 0.15, 0.05]])
    forced = torch.tensor([[0, 2], [0, 2]])
    _, ids, flips, gaps = RS.route(probs, 2, True, forced, tie=0.2)
    assert ids.tolist() == [[0, 2], [0, 2]] and flips == 0
    _, ids, flips, gaps = RS.route(probs, 2, True, forced, tie=0.12)
    assert ids.tolist() == [[0, 2], [0, 1]] and flips == 1
    assert gaps.tolist() == pytest.approx([0.1001, 0.15])


def test_prefill_then_cached_block_decode(model):
    """The prompt prefilled (P = 6, so the first block is short), then each
    block's steps on its 4 positions against the cache: every step's
    hidden states equal the reference's full block-causal forward over the
    ids that entered it, and after the block's write the cache equals a
    full forward's over the final ids."""
    cfg, params = model
    P, N, bl = 6, 8, 4
    L = P + N
    final = _ids(L, seed=7)
    x = final.clone()
    x[P:] = MASK
    bounds = TL.block_causal_bounds(L, P, bl)
    _, cache = TL.llada_hidden_with_cache(params, cfg, x[None, :P],
                                          kv_hi=bounds[:P], cache_len=L)
    assert cache["k"].shape == (2, 1, L, 32)
    assert float(cache["k"][:, :, P:].abs().max()) == 0.0
    for b in range(N // bl):
        bs = P + b * bl
        pos = torch.arange(bs, bs + bl)[None]
        hi = torch.full((1, bl), bs + bl)
        for step in range(bl):
            x[bs + step] = final[bs + step]     # one commit a step
            h, cache = TL.llada_hidden_partial(params, cfg,
                                               x[None, bs:bs + bl], pos,
                                               cache, kv_hi=hi)
            want, _ = RS.hidden(params, CONF, x[:bs + bl], P, bl)
            torch.testing.assert_close(h[0], want[bs:], rtol=TOL, atol=TOL)
        TL.llada_hidden_partial(params, cfg, x[None, bs:bs + bl], pos, cache,
                                kv_hi=hi)
        _, full = TL.llada_hidden_with_cache(params, cfg, x[None, :bs + bl],
                                             kv_hi=bounds[:bs + bl])
        for key in ("k", "v"):
            torch.testing.assert_close(cache[key][:, :, :bs + bl], full[key],
                                       rtol=TOL, atol=TOL)


def test_cache_attention_fold_is_the_same_function(model):
    cfg, _ = model
    g = torch.Generator().manual_seed(8)
    q = torch.randn(2, 4, 128, generator=g)
    k, v = torch.randn(2, 14, 32, generator=g), torch.randn(2, 14, 32,
                                                            generator=g)
    sin, cos = TL._rope_sin_cos(14, 32, 1e6)
    pos = torch.tensor([[6, 7, 8, 9], [10, 11, 12, 13]])
    bias = TL.to_bias(TL._prefix_dense_bias(pos + 1, 14))
    args = (q, k, v, sin[pos], cos[pos], bias, 4, 1, cfg)
    torch.testing.assert_close(TL._cache_attention(*args, fold=True),
                               TL._cache_attention(*args, fold=False),
                               rtol=TOL, atol=TOL)


def _greedy_reference(params, x, P, N, bl):
    """The block sampler's greedy trajectory from the reference's full
    forwards: each step commits the most confident masked slot of the
    block."""
    x = x.clone()
    for bs in range(P, P + N, bl):
        for _ in range(bl):
            h, _ = RS.hidden(params, CONF, x[:bs + bl], P, bl)
            probs = torch.softmax(RS.head(params, h[bs:]), -1)
            conf, tok = probs.max(-1)
            conf = torch.where(x[bs:bs + bl] == MASK, conf, -1.0)
            j = int(conf.argmax())
            x[bs + j] = tok[j]
    return x


def test_block_sampler_commits_one_token_a_step(model, monkeypatch):
    cfg, params = model
    P, N, bl = 6, 8, 4
    prompts = torch.stack([_ids(P, seed=9), _ids(P, seed=10)])
    opts = TM.MMUOptions(max_new_tokens=N, steps=N, block_length=bl,
                         mask_token=MASK)
    seen = []
    real = TM._block_step

    def step(dec, graphs, block, *a):
        cur = block.clone()
        new, logits = real(dec, graphs, block, *a)
        seen.append(((cur == MASK) & (new != MASK)).sum(1).tolist())
        return new, logits

    monkeypatch.setattr(TM, "_block_step", step)
    out = TM.mmu_generate_fast(params, cfg, prompts, opts, eot_token=-1)
    assert seen == [[1, 1]] * N
    assert not bool((out[:, P:] == MASK).any())
    for r in range(2):
        want = _greedy_reference(params, torch.cat(
            [prompts[r], torch.full((N,), MASK)]), P, N, bl)
        assert torch.equal(out[r], want)
    assert torch.equal(TM.mmu_generate(params, cfg, prompts, opts), out)


def test_block_sampler_takes_no_graphs_on_the_cpu(model):
    """A kept ``DecodeGraphs`` is a card's: on the CPU the route runs its
    forwards eagerly, captures nothing and gives the same tokens."""
    cfg, params = model
    prompts = torch.stack([_ids(6, seed=9), _ids(6, seed=10)])
    opts = TM.MMUOptions(max_new_tokens=8, steps=8, block_length=4,
                         mask_token=MASK)
    graphs = TM.DecodeGraphs()
    got = TM.mmu_generate_fast(params, cfg, prompts, opts, eot_token=-1,
                               graphs=graphs)
    assert torch.equal(got, TM.mmu_generate(params, cfg, prompts, opts))
    assert graphs.replays == 0 and graphs.params is None


def test_block_sampler_stops_after_an_eot_block(model, monkeypatch):
    """``mmu_generate_fast`` on the block route stops after the block whose
    last token is ``eot_token`` in every row: the block after it, already
    queued (the check lags a block), goes back to the mask, and none
    after it runs."""
    cfg, params = model
    P, N, bl, EOT = 6, 12, 4, 7
    prompts = torch.stack([_ids(P, seed=12), _ids(P, seed=13)])
    opts = TM.MMUOptions(max_new_tokens=N, steps=N, block_length=bl,
                         mask_token=MASK)
    full = TM.mmu_generate(params, cfg, prompts, opts)
    real, calls = TM._block_step, []

    def step(dec, graphs, block, pos, hi, cache, i):
        new, logits = real(dec, graphs, block, pos, hi, cache, i)
        calls.append(int(pos[0, 0]))
        if int(pos[0, 0]) == P and i == bl - 1:     # block 0 ends in eot
            new = new.clone()
            new[:, -1] = EOT
        return new, logits

    monkeypatch.setattr(TM, "_block_step", step)
    out = TM.mmu_generate_fast(params, cfg, prompts, opts, eot_token=EOT)
    assert calls == [P] * bl + [P + bl] * bl       # block 2 never ran
    assert torch.equal(out[:, :P + bl - 1], full[:, :P + bl - 1])
    assert bool((out[:, P + bl - 1] == EOT).all())
    assert bool((out[:, P + bl:] == MASK).all())


def test_mmu_server_serves_the_block_sampler(model):
    from mmada_parallel_torch.serving import MMUServer
    cfg, params = model
    opts = TM.MMUOptions(max_new_tokens=8, steps=8, block_length=4,
                         mask_token=MASK)
    prompt = _ids(6, seed=11).tolist()
    server = MMUServer(params, cfg, opts, batch_size=1, bucket_quantum=1)
    try:
        got = server.submit(prompt)["text_ids"]
    finally:
        server.close()
    want = TM.mmu_generate(params, cfg, torch.tensor([prompt]), opts)
    np.testing.assert_array_equal(got, want[0, 6:].numpy())


def test_block_route_refuses_what_it_cannot_run(model):
    cfg, params = model
    ids = _ids(6)[None]
    opts = TM.MMUOptions(max_new_tokens=8, steps=8, block_length=4,
                         mask_token=MASK)
    with pytest.raises(ValueError, match="blocks are 4"):
        TM.mmu_generate(params, cfg, ids, dataclasses.replace(
            opts, block_length=8, steps=8))
    with pytest.raises(NotImplementedError, match="CFG"):
        TM.mmu_generate(params, cfg, ids, dataclasses.replace(
            opts, cfg_scale=1.0))
    pad = torch.tensor([[True] * 5 + [False]])
    with pytest.raises(NotImplementedError, match="padded"):
        TM.mmu_generate(params, cfg, ids, opts, attn_mask=pad)


def _shapes(cfg):
    p = TL.init_llada_params(dataclasses.replace(cfg, n_layers=1),
                             torch.Generator(), device="meta")
    return {k: tuple(v.shape) for k, v in p["blocks"].items()}


def test_presets_keep_head_dim_and_shapes():
    tiny, big = TL.LLaDAConfig.tiny(), TL.LLaDAConfig.llada_8b()
    assert (tiny.head_dim, big.head_dim) == (16, 128)
    assert _shapes(tiny) == {
        "attn_norm": (1, 64), "ff_norm": (1, 64), "q_proj": (1, 64, 64),
        "k_proj": (1, 64, 32), "v_proj": (1, 64, 32), "attn_out": (1, 64, 64),
        "ff_proj": (1, 64, 128), "up_proj": (1, 64, 128),
        "ff_out": (1, 128, 64)}
    assert _shapes(big)["q_proj"] == (1, 4096, 4096)
    assert _shapes(big)["ff_out"] == (1, 12288, 4096)
    sdar = TL.LLaDAConfig.sdar_30b_a3b()
    sdar.validate()
    assert sdar.head_dim == 128 and sdar.d_model // sdar.n_heads == 64
    assert _shapes(sdar) == {
        "attn_norm": (1, 2048), "ff_norm": (1, 2048),
        "q_proj": (1, 2048, 4096), "k_proj": (1, 2048, 512),
        "v_proj": (1, 2048, 512), "attn_out": (1, 4096, 2048),
        "router": (1, 2048, 128), "expert_gate": (1, 128, 2048, 768),
        "expert_up": (1, 128, 2048, 768), "expert_down": (1, 128, 768, 2048),
        "q_norm": (1, 128), "k_norm": (1, 128)}
    p = TL.init_llada_params(sdar, torch.Generator(), device="meta")
    assert TL.count_params(p) == 30_532_122_624


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped GEMM has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [64, 4096], ids=["small-tiles", "large-tiles"])
def test_grouped_gemm_on_the_card(cuda_device, T):
    """The kernel's two launches against their plain version on the same
    bf16 operands (f32 products): the SwiGLU rows within one bf16 rounding
    of their largest, the f32 down rows within f32 summation order; a
    repeat is bitwise equal."""
    g = torch.Generator(device="cuda").manual_seed(12)
    E, d, m, k = 16, 256, 128, 4
    bf = torch.bfloat16
    gate, up = (0.05 * torch.randn(E, d, m, device="cuda", generator=g)
                for _ in range(2))
    down = 0.05 * torch.randn(E, m, d, device="cuda", generator=g)
    gate, up, down = gate.to(bf), up.to(bf), down.to(bf)
    x = torch.randn(T, d, device="cuda", generator=g).to(bf)
    router = torch.randn(d, E, device="cuda", generator=g).to(bf)
    w, ids = M.route(x, router, k, True)
    p = M.plan(ids, E, M.SMALL_TILE if T * k <= M.SMALL_ROWS_MAX * E
               else M.LARGE_TILE)
    assert p.tile_rows == (M.SMALL_TILE if T == 64 else M.LARGE_TILE)
    before = M.grouped_gemm.launches
    mid = M.grouped_gemm(x, p, gate, up, top_k=k, glu=True)
    y = M.grouped_gemm(mid, p, down, scale=w.reshape(-1), top_k=k, glu=False)
    assert M.grouped_gemm.launches - before == 2
    ref_mid = M.grouped_gemm_reference(x, p, gate, up, top_k=k, glu=True)
    ref_y = M.grouped_gemm_reference(mid, p, down, scale=w.reshape(-1),
                                     top_k=k, glu=False)
    scale = ref_mid.float().abs().max()
    assert float((mid.float() - ref_mid.float()).abs().max()) <= \
        2 ** -8 * float(scale)
    torch.testing.assert_close(y, ref_y, rtol=1e-4, atol=1e-4 * float(
        ref_y.abs().max()))
    assert torch.equal(mid, M.grouped_gemm(x, p, gate, up, top_k=k,
                                           glu=True))


@pytest.mark.cuda
def test_block_route_on_the_card(cuda_device):
    """The block sampler's cached route in bf16 on the card (K4 prefill of
    a 4096-position prompt, the grouped kernel, K2 on the folded rows, the
    decode forwards as CUDA graphs) against the plain f32 reference's full
    forwards: every step's logits within bf16's reach (their mean error
    under 2 % of their spread, as a flipped near-tie expert moves a few
    positions further).  A kept ``DecodeGraphs`` replays in a second call
    what the first captured: every decode forward a replay, the host
    launching only the prefill's kernels."""
    cfg = dataclasses.replace(
        _cfg(), d_model=256, n_heads=4, head_dim=64, n_kv_heads=1,
        moe_hidden_size=128, param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16, init_std=0.05)
    conf = dict(CONF, hidden_size=256, head_dim=64, moe_intermediate_size=128)
    params = TL.init_llada_params(cfg, torch.Generator(
        device="cuda").manual_seed(13))
    P, N, bl = 4096, 8, 4
    prompts = torch.randint(0, MASK, (2, P), device="cuda", generator=(
        torch.Generator(device="cuda").manual_seed(14)))
    seen = []
    real = TM._block_step

    def step(dec, graphs, block, *a):
        cur = block[0].clone()
        new, logits = real(dec, graphs, block, *a)
        seen.append((cur, logits[0].float().clone()))
        return new, logits

    opts = TM.MMUOptions(max_new_tokens=N, steps=N, block_length=bl,
                         mask_token=MASK)
    graphs = TM.DecodeGraphs()
    first = TM.mmu_generate(params, cfg, prompts, opts, graphs=graphs)
    assert set(graphs.graphs) == {True, False}
    before = (M.grouped_gemm.launches, RA.flash_attention_rope_qonly.launches,
              RA.flash_attention_rope_prefix.launches, graphs.replays)
    TM._block_step = step
    try:
        out = TM.mmu_generate(params, cfg, prompts, opts, graphs=graphs)
    finally:
        TM._block_step = real
    assert torch.equal(out, first)
    L = cfg.n_layers
    assert (M.grouped_gemm.launches - before[0],
            RA.flash_attention_rope_qonly.launches - before[1],
            RA.flash_attention_rope_prefix.launches - before[2],
            graphs.replays - before[3]) == (2 * L, 0, L, N + N // bl)
    with torch.no_grad():
        for j, (ids, logits) in enumerate(seen):
            bs = P + (j // bl) * bl
            x = out[0].clone()
            x[bs:bs + bl] = ids
            h, _ = RS.hidden(params, conf, x[:bs + bl], P, bl)
            ref = RS.head(params, h[bs:])
            assert float((logits - ref).abs().mean()) < 0.02 * float(
                ref.std())
