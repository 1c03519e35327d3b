"""Seeded inputs: the stand-in tokenizer, images and prompts.

No tokenizer files or images are in the repository, so the benchmark
makes its own, from the run's seed.  The configuration files list them
under ``assumed``.
"""

from __future__ import annotations

import zlib

import numpy as np


class StandInTokenizer:
    """Fixed-length ids from a text: ``bos``, then ``body`` ids drawn from
    ``[lo, hi)`` by a generator seeded with the text's CRC-32, then
    ``eos``, so every prompt comes out at ``body + 2`` ids and different
    texts give different ids.  ``</answer>`` without special tokens is the
    one id ``answer_end``.  ``decode`` joins the ids.  Variant M's
    prompting also calls it on a list of texts and reads ``bos_token_id``
    and ``eos_token_id``."""

    def __init__(self, ids: dict):
        self.bos_token_id, self.eos_token_id = ids["bos"], ids["eos"]
        self.answer_end = ids["answer_end"]
        self.body, self.lo, self.hi = ids["body"], ids["lo"], ids["hi"]

    def _one(self, text: str, add_special_tokens: bool) -> list:
        if not add_special_tokens:
            return [self.answer_end]
        rng = np.random.default_rng(zlib.crc32(text.encode()))
        body = rng.integers(self.lo, self.hi, self.body).tolist()
        return [self.bos_token_id] + body + [self.eos_token_id]

    def __call__(self, text, add_special_tokens=True):
        if isinstance(text, list):
            return {"input_ids": [self._one(t, add_special_tokens)
                                  for t in text]}
        return {"input_ids": self._one(text, add_special_tokens)}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))


def image(rng: np.random.Generator, size: int) -> np.ndarray:
    """A uint8 ``[size, size, 3]`` image: a random smooth field (a few
    random planar waves per channel) plus pixel noise."""
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                         indexing="ij")
    img = np.zeros((size, size, 3))
    for c in range(3):
        for _ in range(3):
            fx, fy, ph = rng.uniform(0.5, 4.0), rng.uniform(0.5, 4.0), \
                rng.uniform(0, 2 * np.pi)
            img[..., c] += np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
    img = 128 + 40 * img + rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)
