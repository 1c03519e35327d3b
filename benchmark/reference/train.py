"""Plain training steps of the two SFT recipes, in f32: the loss, its
gradients, the global-norm clip and AdamW with no decay on 1-D parameters
(optax's ``clip_by_global_norm`` then ``adamw``).

* Variant A (MMaDA-Parallel-A's ``train.sh``): the masked cross-entropy
  over every labelled position, each microbatch's mean over its labelled
  tokens, averaged over the microbatches; half-cosine learning rate.
* Variant M (MMaDA-Parallel-M's interleave SFT): the last
  ``max_seq_length`` positions are text, their cross-entropy divided by the
  row's masking time ``t`` and summed over the microbatch's rows over
  ``max_seq_length``; the ``num_vq_tokens + 2`` positions before them the
  image, their cross-entropy averaged (unlabelled positions count 0); keys
  and queries padded by the row's mask; linear warmup, then cosine.

The model is ``reference/llada.py`` with each layer recomputed in the
backward, one row at a time, so one row's f32 activations are alive.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import llada as R


def leaves(tree) -> list:
    """``(name, tensor)`` of a nested dict, in insertion order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += [(f"{k}.{n}", t) for n, t in leaves(v)]
        else:
            out.append((k, v))
    return out


def row_ce(params, cfg, ids, labels, mm=R.f32_mm, mask=None):
    """Cross-entropy (f32) at one row's labelled positions, and those
    positions."""
    valid = labels != -100
    h = R.hidden(params, cfg, ids[None], mm=mm, checkpoint_layers=True,
                 mask=None if mask is None else mask[None])[0]
    logits = R.head(params, h[valid], mm=mm)
    ce = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels[valid][:, None])[:, 0]
    return ce, valid.nonzero()[:, 0]


def _start(params):
    for _, p in leaves(params):
        p.requires_grad_(True)
        p.grad = None


def a_loss_and_grads(params, cfg, batch, microbatches: int, mm=R.f32_mm,
                     micro=None):
    """The A step's loss and the gradient of every leaf (``.grad``), from
    ``batch = (ids, labels, ...)`` of ``microbatches`` microbatches.
    ``micro`` keeps only those microbatches (a fault: part of the batch
    left out, the mean over the rest)."""
    ids, labels = batch[:2]
    n = ids.shape[0] // microbatches
    micro = list(range(microbatches) if micro is None else micro)
    _start(params)
    total = 0.0
    for mb in micro:
        scale = 1.0 / (int((labels[mb * n:(mb + 1) * n] != -100).sum())
                       * len(micro))
        for i in range(mb * n, (mb + 1) * n):
            ce, _ = row_ce(params, cfg, ids[i], labels[i], mm)
            loss = ce.sum() * scale
            loss.backward()
            total += float(loss.detach())
    return total


def m_loss_and_grads(params, cfg, batch, microbatches: int, mm=R.f32_mm,
                     micro=None):
    """The M step's loss and gradients, from ``batch = (ids, labels,
    mask, t)``; ``cfg`` also holds ``max_seq_length``, ``num_vq_tokens``
    and the recipe's ``text_coeff`` / ``image_coeff``.  ``micro`` as for
    :func:`a_loss_and_grads`."""
    ids, labels, mask, t = batch
    msl, n_vq = cfg["max_seq_length"], cfg["num_vq_tokens"]
    rc = cfg["recipe"]
    L = ids.shape[1]
    n = ids.shape[0] // microbatches
    micro = list(range(microbatches) if micro is None else micro)
    _start(params)
    total = 0.0
    for mb in micro:
        for i in range(mb * n, (mb + 1) * n):
            ce, pos = row_ce(params, cfg, ids[i], labels[i], mm,
                             mask[i].bool())
            text = ce[pos >= L - msl].sum() / float(t[i]) / msl
            img = (pos >= L - msl - n_vq - 2) & (pos < L - msl)
            image = ce[img].sum() / (n * (n_vq + 2))
            loss = (rc["text_coeff"] * text + rc["image_coeff"] * image) \
                / len(micro)
            loss.backward()
            total += float(loss.detach())
    return total


class AdamW:
    def __init__(self, params, lr_fn, b1, b2, eps, wd, clip):
        self.lr_fn, self.b1, self.b2, self.eps = lr_fn, b1, b2, eps
        self.wd, self.clip = wd, clip
        self.mu = {n: torch.zeros_like(p) for n, p in leaves(params)}
        self.nu = {n: torch.zeros_like(p) for n, p in leaves(params)}
        self.count = 0

    @torch.no_grad()
    def step(self, params) -> dict:
        """Clip, update in place; returns each leaf's clipped gradient
        norm."""
        ps = leaves(params)
        gnorm = math.sqrt(sum(float(p.grad.double().square().sum())
                              for _, p in ps))
        scale = self.clip / gnorm if gnorm >= self.clip else 1.0
        lr = self.lr_fn(self.count)
        self.count += 1
        norms = {}
        for n, p in ps:
            g = p.grad * scale
            norms[n] = float(g.double().norm())
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (mu / (1 - self.b1 ** self.count)) / (
                (nu / (1 - self.b2 ** self.count)).sqrt() + self.eps)
            if p.ndim > 1:
                u = u + self.wd * p
            p.sub_(lr * u)
            p.grad = None
        return norms


def warmup_cosine(base_lr, warmup, total):
    """Variant M's ``cosine``: linear warmup times half a cosine over the
    steps after it."""
    def fn(step):
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * min(step / max(warmup, 1), 1.0) * max(
            0.0, 0.5 * (1 + math.cos(math.pi * prog)))
    return fn


def half_cosine(base_lr, warmup, total, min_lr=0.0):
    def fn(step):
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        prog = (step - warmup) / max(total - warmup, 1)
        return min_lr + (base_lr - min_lr) * 0.5 * (1 + math.cos(math.pi
                                                                 * prog))
    return fn
