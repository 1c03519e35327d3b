"""Operations and bytes of SDAR-30B-A3B's forwards, from shapes: what the
``*.sdar`` readers count.  ``m`` is the configuration file's dict, in its
published keys (``hidden_size``, ``num_attention_heads``, ``head_dim``,
...): ``counts.head_dim`` assumes ``d / H``, which SDAR breaks (128, not
64).  A multiply-add counts as two operations; bytes count each input read
once and each output written once, bf16 weights and activations.

A forward is ``{"count", "tokens", "attended", "cache_rows", "head_rows",
"prefill"}``: how many such forwards, the query positions it runs (all
rows), the keys those positions attend to summed over them (what the
block-causal mask leaves), the cache positions its rows read (a row's
block sees the same keys: summed over rows, not positions), the positions
the head projects, and whether it is the prompt's prefill (which writes
the cache of its positions) or a block's step or write (which reads the
cache below the block's end and writes the block's).
"""

from __future__ import annotations


def dims(m: dict):
    return (m["hidden_size"], m["num_attention_heads"],
            m["num_key_value_heads"], m["head_dim"], m["num_experts"],
            m["num_experts_per_tok"], m["moe_intermediate_size"],
            m["vocab_size"], m["num_hidden_layers"])


def attention_weights(m: dict) -> int:
    """One layer's q, k, v, o projections, router and norms (elements)."""
    d, H, KV, hd, E, _, _, _, _ = dims(m)
    return 2 * d * H * hd + 2 * d * KV * hd + d * E + 2 * d + 2 * hd


def expert_weights(m: dict) -> int:
    """One expert's gate, up and down (elements)."""
    d, _, _, _, _, _, mm, _, _ = dims(m)
    return 3 * d * mm


def forward_flops(m: dict, fwd: dict) -> int:
    """Model operations of one forward: every layer's projections, router
    and the ``k`` experts of each token, attention over the keys each
    position sees (``4 H hd`` an attended pair), and the head."""
    d, H, KV, hd, E, k, mm, V, L = dims(m)
    T = fwd["tokens"]
    per_token = 2 * (2 * d * H * hd + 2 * d * KV * hd + d * E
                     + k * 3 * d * mm)
    return (L * (T * per_token + 4 * H * hd * fwd["attended"])
            + 2 * d * V * fwd["head_rows"])


def forward_bytes(m: dict, fwd: dict, experts_touched: float) -> float:
    """Least bytes of one forward: the weights it uses once (every layer's
    attention weights, ``experts_touched`` experts summed over its layers,
    the head where it runs, the embedding rows), the cache (every forward
    writes its positions' k and v; a step or write reads what its rows
    see) and the head's f32 logits."""
    d, H, KV, hd, E, k, mm, V, L = dims(m)
    T = fwd["tokens"]
    kv = 2 * KV * hd * 2                       # k and v of a position
    cache = L * kv * (T + (0 if fwd["prefill"] else fwd["cache_rows"]))
    head = (2 * d * V + 4 * V * fwd["head_rows"]) if fwd["head_rows"] else 0
    return (2 * (L * attention_weights(m) + experts_touched
                 * expert_weights(m) + T * d) + cache + head)


def prefill_touched(m: dict, fwd: dict) -> int:
    """Experts a prefill touches over its layers: every expert a layer
    has, or its assignments where fewer."""
    _, _, _, _, E, k, _, _, L = dims(m)
    return L * min(E, fwd["tokens"] * k)


def window_bound_s(m: dict, forwards: list, touched_total: float,
                   peak_flops: float, peak_bytes: float) -> float:
    """The summed least time of the window's forwards: each the larger of
    its operations at the bf16 peak and its bytes at the memory rate.  The
    steps' and writes' experts come from the program's
    ``moe.experts_touched`` counter (all forwards) less what the prefills
    touch; they share it in proportion to their tokens."""
    pre = [f for f in forwards if f["prefill"]]
    dec = [f for f in forwards if not f["prefill"]]
    left = touched_total - sum(f["count"] * prefill_touched(m, f)
                               for f in pre)
    dec_tokens = sum(f["count"] * f["tokens"] for f in dec)
    total = 0.0
    for f in pre:
        total += f["count"] * max(
            forward_flops(m, f) / peak_flops,
            forward_bytes(m, f, prefill_touched(m, f)) / peak_bytes)
    for f in dec:
        each = max(left, 0) * f["tokens"] / max(dec_tokens, 1)
        total += f["count"] * max(
            forward_flops(m, f) / peak_flops,
            forward_bytes(m, f, each) / peak_bytes)
    return total
