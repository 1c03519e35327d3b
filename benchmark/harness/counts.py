"""Operations and bytes from shapes: the arithmetic the per-layer readers
share.  ``m`` is a configuration file's dict (``d_model``, ``n_heads``,
``n_kv_heads``, ``mlp_hidden_size``, ``n_layers``, ``embedding_size``).
A multiply-add counts as two operations.  Bytes count each input read
once and each output written once."""

from __future__ import annotations


def head_dim(m: dict) -> int:
    return m["d_model"] // m["n_heads"]


def block_gemm_flops_per_token(m: dict) -> int:
    """The block GEMMs of every layer for one token: q and the output
    projection (d x d each), k and v (d x kv_d each), and the gated MLP's
    three (d x mlp)."""
    d, h = m["d_model"], m["mlp_hidden_size"]
    kvd = m["n_kv_heads"] * head_dim(m)
    return 2 * m["n_layers"] * (2 * d * d + 2 * d * kvd + 3 * d * h)


def head_flops(m: dict, spans) -> int:
    """The vocab head over ``spans``, ``[[positions, columns], ...]``."""
    return sum(2 * n * cols * m["d_model"] for n, cols in spans)


def attention_flops(m: dict, B: int, Lq: int, Lk: int, bwd: bool) -> int:
    """One attention call over every head: ``4 B H Lq Lk D`` forward
    (scores and the weighted sum), ``10 B H Lq Lk D`` backward (the scores
    again, and the products for dV, dP, dQ, dK)."""
    return (10 if bwd else 4) * B * m["n_heads"] * Lq * Lk * head_dim(m)


def attention_bytes(m: dict, B: int, Lq: int, Lk: int, bwd: bool,
                    bias: bool = False, elt: int = 2) -> int:
    """One fused-RoPE attention call (K1): forward reads q, k, v and the
    f32 sin/cos tables (and the f32 ``[B, Lq, Lk]`` bias) and writes o;
    backward reads q, k, v, o, dO, the f32 row statistics, the tables (and
    the bias) and writes dQ, dK, dV."""
    D = head_dim(m)
    q = B * Lq * m["n_heads"] * D * elt
    kv = B * Lk * m["n_kv_heads"] * D * elt
    tables = 2 * max(Lq, Lk) * D * 4 + (B * Lq * Lk * 4 if bias else 0)
    if not bwd:
        return 2 * q + 2 * kv + tables
    stats = B * m["n_heads"] * Lq * 2 * 4
    return 4 * q + 4 * kv + stats + tables


def attention_bound_s(m: dict, call: dict, peak_flops: float,
                      peak_bytes: float) -> float:
    """Least seconds the card could take for ``call["count"]`` calls of
    one shape: the larger of operations over the bf16 peak and bytes over
    the memory rate."""
    args = (m, call["B"], call["Lq"], call["L"], call["bwd"])
    nbytes = attention_bytes(*args, bias=call.get("bias", False))
    return call["count"] * max(attention_flops(*args) / peak_flops,
                               nbytes / peak_bytes)


def forward_flops(m: dict, fwd: dict, attention: bool = True) -> int:
    """Model operations of ``fwd["count"]`` sequence forwards of one shape:
    the block GEMMs at every position, attention in every layer (when
    ``attention``), the head over its spans."""
    B, L = fwd["B"], fwd["L"]
    per = (L * block_gemm_flops_per_token(m) + head_flops(m, fwd["head"]))
    if attention:
        per += m["n_layers"] * attention_flops(m, 1, L, L, False)
    return fwd["count"] * B * per


def train_step_flops(m: dict, tr: dict) -> dict:
    """One training step's forward operations, ``{"gemm_block",
    "gemm_head", "attention"}``: every row of every microbatch through
    each block GEMM, the head over all positions, and attention's
    forward."""
    rows = tr["microbatches"] * tr["rows"]
    L = tr["L"]
    return {"gemm_block": rows * L * block_gemm_flops_per_token(m),
            "gemm_head": head_flops(m, [[rows * L, m["embedding_size"]]]),
            "attention": m["n_layers"] * attention_flops(m, rows, L, L,
                                                         False)}
