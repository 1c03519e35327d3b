"""K2's split-K grid on the CPU: the planner, and the split-and-combine
arithmetic of the kernel written out in plain PyTorch.

* ``plan_splits`` (``ops/rope_attention.py``) with ``split_ranges`` (the
  kernel's cut, ``csrc/attention_ws.cuh`` kSplit): the ranges partition
  the key tiles ``[0, ceil(Lk/64))`` into contiguous,
  non-empty pieces, no split starts at or past Lk, a grid that already
  covers the SMs is not split, the count is the least of the planner's
  modelled device time (``split_cost``), and at the shapes swept on an
  H100 it is the card's fastest count (PERF.md).
* ``split_combine``: per split, the unnormalised ``o`` and the row's max
  ``m`` and sum ``l`` in base 2 (as ``csrc/attention_ws.cuh`` keeps them),
  then ``out = sum_s 2^(m_s - m*) o_s / sum_s 2^(m_s - m*) l_s``.  It equals
  ``flash_attention_rope_qonly_reference`` at atol = rtol = 1e-5 in f32 (the
  same math up to summation order and one rescale per split), and JAX's
  ``flash_attention_rope_qonly(..., interpret=True)`` on the same numpy
  inputs at the JAX kernel tests' 2e-5, with per-row tables, GQA, a padding
  bias, a row masked to -1e30 on every key (mean(v) over all Lk keys, across
  splits) and splits whose keys are masked for every row of a batch row.
  Lk is a multiple of 128 wherever a row is fully masked, so the Pallas
  kernel pads no keys and also gives mean(v).
The kernel itself is held to the plain version on the card by the
``cuda``-marked tests of ``test_torch_qonly_attention.py`` and by
``chip_smoke.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_parallel_tpu.models.llada import _rope_sin_cos as jax_tables
from mmada_parallel_tpu.ops import rope_attention as JR
from mmada_parallel_torch.ops import rope_attention as TR

torch.set_num_threads(1)
SPLIT_TOL = dict(atol=1e-5, rtol=1e-5)
JAX_TOL = dict(atol=2e-5, rtol=2e-5)
H100_SMS = 132


def split_ranges(n_tiles, n_split):
    """The key-tile ranges ``[lo, hi)`` of a split-K launch, as the kernel
    cuts them: split ``s`` of ``S`` takes tiles ``s*n//S`` to
    ``(s+1)*n//S``."""
    return [(s * n_tiles // n_split, (s + 1) * n_tiles // n_split)
            for s in range(n_split)]


@pytest.mark.parametrize("B,H,Lq,Lk,sms", [
    (1, 32, 16, 2424, H100_SMS),      # the A cached edit's partial step
    (1, 32, 22, 2424, H100_SMS),
    (1, 32, 1, 2424, H100_SMS),
    (1, 32, 65, 2424, H100_SMS),
    (2, 32, 308, 2360, H100_SMS),     # the M partial step: 192 blocks
    (1, 32, 2424, 2424, H100_SMS),    # a full refresh
    (2, 32, 2360, 2360, H100_SMS),
    (2, 8, 40, 300, H100_SMS),
    (1, 2, 1, 64, H100_SMS),          # one key tile: nothing to split
    (1, 2, 1, 65, H100_SMS),
    (3, 4, 200, 1000, 114),
    (1, 1, 1, 5, 8),
    (1, 4, 16, 100_000, H100_SMS),
])
def test_planner_partitions_key_tiles(B, H, Lq, Lk, sms):
    blocks = B * H * math.ceil(Lq / TR.Q_TILE)
    n_tiles = math.ceil(Lk / TR.K_TILE)
    S = TR.plan_splits(B, H, Lq, Lk, sms)
    assert 1 <= S <= n_tiles
    ranges = split_ranges(n_tiles, S)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_tiles
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(n_tiles, None)]):
        assert lo < hi == nxt                 # non-empty and contiguous
        assert lo * TR.K_TILE < Lk            # no split starts past Lk
    if blocks >= sms:
        assert S == 1
    else:                                     # the least modelled time
        cost = TR.split_cost(S, B, H, Lq, Lk, sms)
        assert all(cost <= TR.split_cost(n, B, H, Lq, Lk, sms)
                   for n in range(1, n_tiles + 1))


def test_planner_covers_the_card_at_the_partial_step():
    """B=1, Lq=16, Lk=2424, H=32: 32 items unsplit; the split grid runs in
    one wave on at least 90 % of the H100's 132 SMs (4 splits, 128 items:
    a fifth split would start a second wave); a card of 32 SMs is covered
    unsplit."""
    S = TR.plan_splits(1, 32, 16, 2424, H100_SMS)
    assert 0.9 * H100_SMS <= 32 * S <= H100_SMS
    assert TR.plan_splits(1, 32, 16, 2424, 32) == 1


# K2's device time by forced split count on an NVIDIA H100 80GB HBM3 at
# 700 W (chip_ab.py --sweep; PERF.md section 6): each swept shape's fastest
# count, and any count within 3 % of it
SWEPT_FASTEST = {
    (1, 32, 16, 2424): {4},      # the cached A edit's partial step
    (1, 32, 103, 1109): {4},     # the cached A text-to-image's
    (1, 8, 303, 2424): {4, 5},   # the ring's serving chunk (g = 4)
    (1, 16, 606, 2424): {3},     # the ring's training chunk (g = 2)
}


@pytest.mark.parametrize("shape", sorted(SWEPT_FASTEST))
def test_planner_picks_the_cards_fastest_count(shape):
    B, H, Lq, Lk = shape
    assert TR.plan_splits(B, H, Lq, Lk, H100_SMS, 128, H) in \
        SWEPT_FASTEST[shape]


@pytest.mark.parametrize("B,H,Lq,Lk,KV", [
    (1, 32, 2424, 2424, 32),          # the cached A edit's full refresh
    (2, 32, 2360, 2360, 32),          # the M full refresh
    (2, 32, 308, 2360, 32),           # the M partial step: 192 items
    (2, 32, 308, 2360, 8),
    (1, 32, 606, 2424, 32),           # 160 items
    (5, 32, 16, 2424, 32),
])
def test_planner_does_not_split_a_covered_card(B, H, Lq, Lk, KV):
    assert TR.plan_splits(B, H, Lq, Lk, H100_SMS, 128, KV) == 1


def split_combine(q, k, v, sin_q, cos_q, bias, H, KV, n_split):
    """K2's split-K in plain PyTorch: the key tiles cut as the kernel cuts
    them, each split's online-softmax state (o unnormalised, m and l in base
    2), then the combine."""
    B, Lq, HD = q.shape
    D, Lk = HD // H, k.shape[1]
    q4 = TR.rope_tensor(q.reshape(B, Lq, H, D), sin_q, cos_q, True)
    k4 = k.reshape(B, Lk, KV, D).repeat_interleave(H // KV, dim=2)
    v4 = v.reshape(B, Lk, KV, D).repeat_interleave(H // KV, dim=2)
    x = torch.einsum("bqhd,bkhd->bhqk", q4, k4) * D ** -0.5
    if bias is not None:
        x = x + bias
    x = x * math.log2(math.e)
    parts = []
    for lo, hi in split_ranges(math.ceil(Lk / TR.K_TILE), n_split):
        c0, c1 = lo * TR.K_TILE, min(hi * TR.K_TILE, Lk)
        xs = x[..., c0:c1]
        m = xs.amax(dim=-1)
        p = torch.exp2(xs - m[..., None])
        o = torch.einsum("bhqk,bkhd->bhqd", p, v4[:, c0:c1])
        parts.append((o, m, p.sum(dim=-1)))
    m_star = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    num = sum(torch.exp2(m - m_star)[..., None] * o for o, m, _ in parts)
    den = sum(torch.exp2(m - m_star) * l for _, m, l in parts)
    return (num / den[..., None]).permute(0, 2, 1, 3).reshape(B, Lq, HD)


def _inputs(B, Lq, Lk, H, KV, D, per_row, seed, keep=None, dead_row=None):
    """numpy q/k/v, f32 tables at Lq sorted distinct positions of an Lk
    sequence (or 0..Lq-1), and a padding bias keeping ``keep[b]`` keys of
    batch row b, with row ``dead_row`` = (b, i) masked on every key."""
    rng = np.random.default_rng(seed)
    s, c = (np.asarray(t) for t in jax_tables(Lk, D, 10000.0))
    if per_row:
        pos = np.sort(np.stack([rng.choice(Lk, Lq, replace=False)
                                for _ in range(B)]), axis=1)
        sq, cq = s[pos], c[pos]
    else:
        sq, cq = s[:Lq], c[:Lq]
    bias = None
    if keep is not None or dead_row is not None:
        keep = keep if keep is not None else (Lk,) * B
        alive = np.arange(Lk)[None, :] < np.asarray(keep)[:, None]
        bias = np.where(alive[:, None, None, :], 0.0, -1e30).astype(
            np.float32) * np.ones((1, 1, Lq, 1), np.float32)
        if dead_row is not None:
            bias[dead_row[0], 0, dead_row[1], :] = -1e30
    q = rng.normal(size=(B, Lq, H * D)).astype(np.float32)
    k = rng.normal(size=(B, Lk, KV * D)).astype(np.float32)
    v = rng.normal(size=(B, Lk, KV * D)).astype(np.float32)
    return q, k, v, sq, cq, bias


SPLIT_CASES = {
    # name: (B, Lq, Lk, H, KV, per_row, keep, dead_row, n_split)
    "per-row tables": (2, 16, 300, 2, 2, True, None, None, 3),
    "gqa shared tables": (1, 40, 260, 8, 2, False, None, None, 5),
    "one tile per split": (1, 9, 200, 2, 1, True, None, None, 4),
    "unsplit": (1, 9, 200, 2, 2, True, None, None, 1),
    # batch row 1 keeps 150 keys: its last splits are masked on every row
    "padding bias, masked splits": (2, 24, 384, 2, 1, True, (384, 150),
                                    None, 6),
    # row (0, 5) is -1e30 on every key: mean(v) across the 4 splits
    "fully masked row": (2, 12, 256, 2, 2, True, (256, 100), (0, 5), 4),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_combine_matches_reference_and_jax(case):
    B, Lq, Lk, H, KV, per_row, keep, dead, S = SPLIT_CASES[case]
    D = 128
    arrs = _inputs(B, Lq, Lk, H, KV, D, per_row, 11, keep, dead)
    q, k, v, sq, cq, bias = (torch.tensor(a) if a is not None else None
                             for a in arrs)
    got = split_combine(q, k, v, sq, cq, bias, H, KV, S)
    want = TR.flash_attention_rope_qonly_reference(q, k, v, sq, cq, bias,
                                                   n_heads=H, n_kv_heads=KV)
    torch.testing.assert_close(got, want, **SPLIT_TOL)
    jq, jk, jv, jsq, jcq, jb = (jnp.asarray(a) if a is not None else None
                                for a in arrs)
    jax_out = np.asarray(JR.flash_attention_rope_qonly(
        jq, jk, jv, jsq, jcq, jb, n_heads=H, n_kv_heads=KV, interpret=True))
    np.testing.assert_allclose(got.numpy(), jax_out, **JAX_TOL)
    if dead is not None:              # mean(v) over all Lk keys
        b, i = dead
        mean_v = v[b].reshape(Lk, KV, D).mean(dim=0).repeat_interleave(
            H // KV, dim=0).reshape(H * D)
        torch.testing.assert_close(got[b, i], mean_v, **SPLIT_TOL)
