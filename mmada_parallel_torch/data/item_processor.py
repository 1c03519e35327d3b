"""Variant-A training item processing: the three sequence layouts.

Mirrors ``MMaDA-Parallel-A/train/train.py:28-165`` (``mask_codes`` +
``ItemProcessor.process_item``): MMU (image -> text), T2I (text -> image
[+text]), TI2TI (text+image -> image[+text]), with cosine-schedule random
masking, 10% ``<uncondition>`` condition dropout, newline-structured image
layout, and padded MMU answers.

Pre-tokenized images arrive as ``{"input_ids": [...], "height": H,
"width": W}`` records (``data/item_processor.py:69-203`` pre-tokenizer
output, pickled per image); text comes through any HF-style tokenizer.

Counterpart of :mod:`mmada_parallel_tpu.data.item_processor`, copied so
that the port imports nothing of the JAX package.  Only what the A trainer
uses is here: the conversation-format ``MMConvItemProcessor`` is not.
"""

from __future__ import annotations

import dataclasses
import math
import pickle
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

from mmada_parallel_torch.tokens import TOKENS_A, VariantATokens, add_break_line

__all__ = ["mask_codes", "load_image_tokens", "AItemProcessor"]

IGNORE = -100


def mask_codes(codes: Sequence[int], sch: str = "cosine", mask: bool = False,
               rng=random, mask_token: int = TOKENS_A.mask,
               ) -> Tuple[List[int], List[int]]:
    """Cosine/linear random masking (``train/train.py:28-53``)."""
    r = rng.uniform(0, 1)
    if len(codes) <= 5 and mask is False:
        mask_ratio = 1.0
    elif sch == "cosine":
        mask_ratio = math.cos(r * math.pi / 2)
    elif sch == "linear":
        mask_ratio = r + 0.05 if r < 0.05 else r
    else:
        raise ValueError(sch)
    num = max(1, int(len(codes) * mask_ratio))
    idx = rng.sample(range(len(codes)), num)
    masked = list(codes)
    labels = [IGNORE] * len(codes)
    for i in idx:
        labels[i] = codes[i]
        masked[i] = mask_token
    return masked, labels


def load_image_tokens(path: str, tokens: VariantATokens = TOKENS_A) -> List[int]:
    """Pickled pre-tokenized image -> newline-structured token list
    (``train/train.py:56-64``; note the reference swaps height/width when
    deriving the grid — ``height, width = width//16, height//16`` — which is
    only correct for square images; here the grid uses (height, width) in
    row-major order as the layout code expects).  Paths go through the
    pluggable reader (``data/reader.py``), so pre-tokenized records may
    live on any registered remote scheme."""
    from mmada_parallel_torch.data.reader import open_general
    with open_general(path, "rb") as f:
        rec = pickle.load(f)
    assert rec["height"] % 16 == 0 and rec["width"] % 16 == 0
    gh, gw = rec["height"] // 16, rec["width"] // 16
    return add_break_line(rec["input_ids"], gh, gw, tokens.newline)


@dataclasses.dataclass
class AItemProcessor:
    """Builds ``(tokens, labels)`` for one annotation item.

    ``item`` keys: ``system_prompt, user_prompt, user_image, answer_image,
    answer_text`` (paths are pre-tokenized pickle files).
    """

    tokenizer: Any
    max_len: int = 5120
    tokens: VariantATokens = TOKENS_A
    uncondition_prob: float = 0.1
    answer_pad_len: int = 1024
    rng: Any = dataclasses.field(default_factory=lambda: random.Random(0))

    def _encode(self, text: str, max_length: int = 1024) -> List[int]:
        return self.tokenizer(text, truncation=True, max_length=max_length,
                              padding=False)["input_ids"]

    def _end_ids(self) -> List[int]:
        return self.tokenizer("</answer>", add_special_tokens=False)["input_ids"]

    def _load_grid(self, path: str) -> Tuple[List[int], int, int]:
        from mmada_parallel_torch.data.reader import open_general
        with open_general(path, "rb") as f:
            rec = pickle.load(f)
        assert rec["height"] % 16 == 0 and rec["width"] % 16 == 0
        return rec["input_ids"], rec["height"] // 16, rec["width"] // 16

    def _instruction(self, item: Dict, drop_condition: bool) -> str:
        if drop_condition:
            return ("<system>" + item["system_prompt"] + "</system>"
                    + "<user>" + "<uncondition>" + "</user>")
        return ("<system>" + item["system_prompt"] + "</system>"
                + "<user>" + item["user_prompt"] + "</user>")

    def process_item(self, item: Dict) -> Tuple[List[int], List[int]]:
        T = self.tokens
        has_user_img = bool(item.get("user_image"))
        has_ans_img = bool(item.get("answer_image"))

        if has_user_img and not has_ans_img:
            return self._mmu(item)
        if not has_user_img and has_ans_img:
            return self._gen(item, with_user_image=False)
        if has_user_img and has_ans_img:
            return self._gen(item, with_user_image=True)
        raise ValueError("item needs user_image and/or answer_image")

    # -- MMU (train/train.py:74-92) --------------------------------------
    def _mmu(self, item: Dict) -> Tuple[List[int], List[int]]:
        T = self.tokens
        instr = self._encode(self._instruction(item, False))
        user_tokens = load_image_tokens(item["user_image"], T)
        instr = instr[:-1] + [T.boi] + user_tokens + [T.eoi] + instr[-1:]
        instr_lab = [IGNORE] * len(instr)

        answer = item["answer_text"] + "</answer>"
        ans = self._encode(answer)
        ans, ans_lab = mask_codes(ans, rng=self.rng, mask_token=T.mask)
        pad = self.answer_pad_len - len(ans)
        tokens = instr + [T.answer_start] + ans + [T.pad] * pad
        labels = instr_lab + [IGNORE] + ans_lab + [IGNORE] * pad
        return tokens, labels

    # -- T2I / TI2TI (train/train.py:94-165) -----------------------------
    def _gen(self, item: Dict, with_user_image: bool) -> Tuple[List[int], List[int]]:
        T = self.tokens
        drop = self.rng.random() < self.uncondition_prob
        instr = self._encode(self._instruction(item, drop))
        if with_user_image and not drop:
            codes, gh, gw = self._load_grid(item["user_image"])
            user_tokens = add_break_line(codes, gh, gw, T.newline)
            instr = instr[:-1] + [T.boi] + user_tokens + [T.eoi] + instr[-1:]
        instr_lab = [IGNORE] * len(instr)

        codes, gh, gw = self._load_grid(item["answer_image"])
        masked, lab = mask_codes(codes, rng=self.rng, mask_token=T.mask)
        img_tokens = add_break_line(masked, gh, gw, T.newline)
        img_labels = add_break_line(lab, gh, gw, IGNORE)

        answer_text = item.get("answer_text") or ""
        if answer_text.strip():
            ans = self._encode(answer_text, max_length=512)
            ans, ans_lab = mask_codes(ans, rng=self.rng, mask_token=T.mask)
            end = self._end_ids()
            tokens = (instr + [T.answer_start, T.boi] + img_tokens + [T.eoi]
                      + ans + end)
            labels = (instr_lab + [IGNORE, IGNORE] + img_labels + [IGNORE]
                      + ans_lab + [IGNORE] * len(end))
        else:
            tokens = (instr + [T.answer_start, T.boi] + img_tokens
                      + [T.eoi, T.answer_end])
            labels = instr_lab + [IGNORE, IGNORE] + img_labels + [IGNORE, IGNORE]
        return tokens, labels

    def predict_length(self, item: Dict) -> int:
        if "token" in item:
            return len(item["token"])
        return int(item.get("len", 1024))
