"""Seeded weights, made on the device by the benchmark: the inputs that the
program and the reference both read.

The trees have the layout the program takes (``models/llada.py``,
``models/amused_vq.py``): LLaDA's per-layer weights stacked on a leading
axis, linear weights ``[d_in, d_out]``; VQGAN convolutions OIHW with
``{"w", "b"}``, norms ``{"scale", "bias"}``.  The draws follow the usual
initialisations (normal, std 0.02, the residual output divided by
``sqrt(2 n_layers)``; torch's kaiming-uniform convolutions), so activations
keep the scale of a trained model's at every layer.
"""

from __future__ import annotations

import math

import torch


def llada_params(cfg: dict, gen: torch.Generator, dtype) -> dict:
    """The LLaDA tree of ``cfg`` (a configuration file's ``model``), one
    draw a leaf, in ``dtype`` on the generator's device."""
    dev = gen.device
    d, h, L = cfg["d_model"], cfg["mlp_hidden_size"], cfg["n_layers"]
    kvd = cfg["n_kv_heads"] * (d // cfg["n_heads"])
    std = cfg["init_std"]

    def normal(*shape, scale=1.0):
        w = torch.empty(shape, dtype=dtype, device=dev)
        return w.normal_(0.0, std * scale, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    resid = 1.0 / math.sqrt(2 * L)
    blocks = {"attn_norm": ones(L, d), "ff_norm": ones(L, d),
              "q_proj": normal(L, d, d), "k_proj": normal(L, d, kvd),
              "v_proj": normal(L, d, kvd), "attn_out": normal(L, d, d),
              "ff_proj": normal(L, d, h), "up_proj": normal(L, d, h),
              "ff_out": normal(L, h, d, scale=resid)}
    return {"wte": normal(cfg["embedding_size"], d), "ln_f": ones(d),
            "blocks": blocks, "head": normal(d, cfg["embedding_size"])}


class _Flat:
    """Leaves cut from one buffer of U(-1, 1) draws, each scaled to its
    bound: one random call for a whole VQGAN tree."""

    def __init__(self, n: int, gen: torch.Generator):
        self.buf = torch.empty(n, dtype=torch.float32, device=gen.device)
        self.buf.uniform_(-1.0, 1.0, generator=gen)
        self.at = 0

    def uniform(self, shape, bound: float) -> torch.Tensor:
        n = math.prod(shape)
        t = self.buf[self.at:self.at + n].view(shape)
        self.at += n
        return t.mul_(bound)


def _vq_tree(cfg: dict, u, ones, zeros) -> dict:
    """The Amused-VQ tree, drawing through ``u(shape, bound)``."""
    def conv(k, cin, cout):
        b = math.sqrt(1.0 / (k * k * cin))
        return {"w": u((cout, cin, k, k), b), "b": u((cout,), b)}

    def norm(c):
        return {"scale": ones(c), "bias": zeros(c)}

    def resnet(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(3, cin, cout),
             "norm2": norm(cout), "conv2": conv(3, cout, cout)}
        if cin != cout:
            p["nin_shortcut"] = conv(1, cin, cout)
        return p

    def mid(c):
        m = {"block_1": resnet(c, c), "block_2": resnet(c, c)}
        if cfg["mid_attention"]:
            m["attn_1"] = {"norm": norm(c), **{n: conv(1, c, c) for n in
                                                ("q", "k", "v", "proj_out")}}
        return m

    chans, lpb = cfg["block_out_channels"], cfg["layers_per_block"]
    down, cin = [], chans[0]
    for i, cout in enumerate(chans):
        level = {"block": []}
        for _ in range(lpb):
            level["block"].append(resnet(cin, cout))
            cin = cout
        if i != len(chans) - 1:
            level["downsample"] = {"conv": conv(3, cout, cout)}
        down.append(level)
    enc = {"conv_in": conv(3, cfg["in_channels"], chans[0]), "down": down,
           "mid": mid(chans[-1]), "norm_out": norm(chans[-1]),
           "conv_out": conv(3, chans[-1], cfg["latent_channels"])}
    ed, n = cfg["latent_channels"], cfg["num_vq_embeddings"]
    quant = {"quant_conv": conv(1, cfg["latent_channels"], ed),
             "embedding": u((n, ed), 1.0 / n),
             "post_quant_conv": conv(1, ed, cfg["latent_channels"])}
    up, cin = [None] * len(chans), chans[-1]
    for i in reversed(range(len(chans))):
        level = {"block": []}
        for _ in range(lpb + 1):
            level["block"].append(resnet(cin, chans[i]))
            cin = chans[i]
        if i != 0:
            level["upsample"] = {"conv": conv(3, chans[i], chans[i])}
        up[i] = level
    dec = {"conv_in": conv(3, cfg["latent_channels"], chans[-1]),
           "mid": mid(chans[-1]), "up": up, "norm_out": norm(chans[0]),
           "conv_out": conv(3, chans[0], cfg["out_channels"])}
    return {"encoder": enc, "quant": quant, "decoder": dec}


def _flat_tree(build, gen: torch.Generator) -> dict:
    """``build(u, ones, zeros)`` run twice: once to size one U(-1, 1)
    buffer, once to cut the tree's leaves from it (f32, on the generator's
    device)."""
    dev = gen.device
    sizes = []
    build(lambda shape, b: sizes.append(math.prod(shape)),
          lambda c: None, lambda c: None)
    flat = _Flat(sum(sizes), gen)
    return build(flat.uniform,
                 lambda c: torch.ones(c, dtype=torch.float32, device=dev),
                 lambda c: torch.zeros(c, dtype=torch.float32, device=dev))


def amused_vq_params(cfg: dict, gen: torch.Generator) -> dict:
    """The Amused-VQ tree of ``cfg`` (a configuration file's ``vq``)."""
    return _flat_tree(lambda u, ones, zeros: _vq_tree(cfg, u, ones, zeros),
                      gen)


def _magvit_tree(cfg: dict, u, ones, zeros) -> dict:
    """The MagViT-v2 tree (encoder and decoder), drawing through ``u``."""
    def conv(k, cin, cout):
        b = math.sqrt(1.0 / (k * k * cin))
        return {"w": u((cout, cin, k, k), b), "b": u((cout,), b)}

    def norm(c):
        return {"scale": ones(c), "bias": zeros(c)}

    def resnet(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(3, cin, cout),
             "norm2": norm(cout), "conv2": conv(3, cout, cout)}
        if cin != cout:
            p["nin_shortcut"] = conv(1, cin, cout)
        return p

    def mid(c):
        return {"block_1": resnet(c, c),
                "attn_1": {"norm": norm(c), **{n: conv(1, c, c) for n in
                                               ("q", "k", "v", "proj_out")}},
                "block_2": resnet(c, c)}

    ch, zc = cfg["ch"], cfg["z_channels"]
    enc = {"conv_in": conv(3, cfg["in_ch"], ch)}
    mults = [1] + list(cfg["enc_ch_mult"])
    down = []
    for i, m in enumerate(cfg["enc_ch_mult"]):
        cin, cout = ch * mults[i], ch * m
        level = {"block": []}
        for _ in range(cfg["enc_blocks"][i]):
            level["block"].append(resnet(cin, cout))
            cin = cout
        if i != len(cfg["enc_ch_mult"]) - 1:
            level["downsample"] = {"conv": conv(3, cout, cout)}
        down.append(level)
    c = ch * cfg["enc_ch_mult"][-1]
    enc.update(down=down, mid=mid(c), norm_out=norm(c),
               conv_out=conv(3, c, zc), quant_conv=conv(1, zc, zc))
    c = ch * cfg["dec_ch_mult"][-1]
    dec = {"post_quant_conv": conv(1, zc, zc), "conv_in": conv(3, zc, c),
           "mid": mid(c)}
    up, cin = [None] * len(cfg["dec_ch_mult"]), c
    for i in reversed(range(len(cfg["dec_ch_mult"]))):
        cout = ch * cfg["dec_ch_mult"][i]
        level = {"block": []}
        for _ in range(cfg["dec_blocks"][i]):
            level["block"].append(resnet(cin, cout))
            cin = cout
        if i != 0:
            level["upsample"] = {"conv": conv(3, cout, cout)}
        up[i] = level
    dec.update(up=up, norm_out=norm(cin), conv_out=conv(3, cin, cfg["out_ch"]))
    return {"encoder": enc, "decoder": dec}


def magvit_params(cfg: dict, gen: torch.Generator) -> dict:
    """The MagViT-v2 tree of ``cfg`` (a configuration file's ``vq``)."""
    return _flat_tree(
        lambda u, ones, zeros: _magvit_tree(cfg, u, ones, zeros), gen)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()
