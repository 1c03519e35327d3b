"""Variant-A training item processing: the three sequence layouts.

Mirrors ``MMaDA-Parallel-A/train/train.py:28-165`` (``mask_codes`` +
``ItemProcessor.process_item``): MMU (image -> text), T2I (text -> image
[+text]), TI2TI (text+image -> image[+text]), with cosine-schedule random
masking, 10% ``<uncondition>`` condition dropout, newline-structured image
layout, and padded MMU answers.

Pre-tokenized images arrive as ``{"input_ids": [...], "height": H,
"width": W}`` records (``data/item_processor.py:69-203`` pre-tokenizer
output, pickled per image); text comes through any HF-style tokenizer.

The conversation-format ``MMConvItemProcessor`` (multi-turn items with
inline media symbols) follows the A processor.

Counterpart of :mod:`mmada_parallel_tpu.data.item_processor`, copied so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import pickle
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

from mmada_parallel_torch.tokens import TOKENS_A, VariantATokens, add_break_line

__all__ = ["mask_codes", "load_image_tokens", "AItemProcessor",
           "MMConvItemProcessor", "LabelAllZeroError"]

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


# ---------------------------------------------------------------------------
# Conversation-format processor with media-symbol machinery
# ---------------------------------------------------------------------------


class LabelAllZeroError(Exception):
    """Raised when a training item has nothing to predict
    (``xllm/data/item_processor.py:13-17``)."""


class MMConvItemProcessor:
    """Multi-turn conversation items with inline media symbols.

    Port of ``xllm/data/item_processor.py:31-263`` (``MMConvItemProcessor``).
    Upstream this class is unreachable legacy — the repo ships only the
    abstract ``ConversationBase`` whose ``process()`` raises — so this port
    pairs the machinery with a concrete two-role template
    (:meth:`default_template_process`) to make the capability usable:

    * ``collect_and_process_media``: gather per-symbol media lists from the
      raw item (symbol key or stripped name), run each through its
      ``transform`` callable.
    * implicit-media insertion: media without an explicit symbol in the
      text are prepended to the first human turn (``:112-132``), or to the
      conversation start when ``implicit_at_beginning``.
    * piece-wise label building: the conversation is tokenized whole, then
      re-derived piece by piece (``encode_wo_prefix_space`` for non-initial
      pieces) asserting exact concatenation; assistant pieces become
      labels (``:210-238``).
    * ``replace_media_token_with_media``: media-symbol token ids are
      replaced in the token list by the prepared media dicts, tagged
      ``to_predict`` from the label at that position (``:92-104``).

    ``tokenizer`` needs ``encode(s, bos, eos)`` / ``encode_wo_prefix_space``
    (:class:`mmada_parallel_torch.data.tokenizer.Tokenizer`); media-symbol
    token ids come from ``media_token_ids`` or, if the wrapped tokenizer
    supports ``add_tokens``, are registered automatically.
    """

    def __init__(self, transform: Dict[str, Any], media_symbols: List[str],
                 tokenizer: Any, conv_template=None,
                 media_token_ids: Optional[Dict[str, int]] = None,
                 implicit_at_beginning: bool = False):
        self.transform = transform
        self.media_symbols = list(media_symbols)
        self.tokenizer = tokenizer
        self.conv_template = conv_template or self.default_template_process
        self.implicit_at_beginning = implicit_at_beginning

        if media_token_ids is None:
            inner = getattr(tokenizer, "tokenizer", None)
            if inner is not None and hasattr(inner, "add_tokens"):
                inner.add_tokens(self.media_symbols)
            media_token_ids = {}
            for sym in self.media_symbols:
                t = tokenizer.encode(sym, bos=False, eos=False)
                assert len(t) == 1, f"{sym!r} must tokenize to 1 token"
                media_token_ids[sym] = t[0]
        self.d_media_symbol2token = dict(media_token_ids)
        self.d_media_token2symbol = {v: k
                                     for k, v in media_token_ids.items()}

    # -- conversation template -------------------------------------------
    ROLES = ("Human", "Assistant")

    @classmethod
    def default_template_process(cls, source: List[Dict]) -> Dict[str, Any]:
        """Concrete template: ``Human: ...\\n`` / ``Assistant: ...\\n``
        pieces; assistant pieces are predicted."""
        pieces = []
        for i, turn in enumerate(source):
            frm = turn["from"].lower()
            if i % 2 == 0:
                assert frm == "human", frm
                pieces.append({"data": f"{cls.ROLES[0]}: {turn['value']}\n",
                               "predict": False})
            else:
                assert frm in ("gpt", "assistant"), frm
                pieces.append({"data": f"{cls.ROLES[1]}: {turn['value']}\n",
                               "predict": True})
        return {"conv": "".join(p["data"] for p in pieces), "pieces": pieces}

    # -- media machinery ---------------------------------------------------
    def collect_and_process_media(self, data_item: Dict) -> Dict[str, List]:
        d_media: Dict[str, List] = {}
        for sym in self.media_symbols:
            if sym in data_item:
                l_media = data_item[sym]
            elif sym.lstrip("<|").rstrip("|>") in data_item:
                l_media = data_item[sym.lstrip("<|").rstrip("|>")]
            else:
                l_media = []
            if not isinstance(l_media, list):
                l_media = [l_media]
            d_media[sym] = []
            for media in l_media:
                media = self.transform[sym](media)
                assert isinstance(media, dict)
                media["type"] = sym
                d_media[sym].append(media)
        return d_media

    @staticmethod
    def insert_implicit_media_symbol_in_q1(source: List[Dict],
                                           d_media: Dict) -> List[Dict]:
        import copy as _copy
        source = _copy.deepcopy(source)
        for sym, l_media in d_media.items():
            count = "".join(t["value"] for t in source
                            if t["value"] is not None).count(sym)
            if count > 0:
                assert count == len(l_media), (
                    f"{count} {sym} in text, {len(l_media)} media given")
            elif l_media:
                source[0]["value"] = ((sym + " ") * len(l_media)
                                      + source[0]["value"])
        return source

    @staticmethod
    def insert_implicit_media_symbol_at_beginning(conv: str,
                                                  d_media: Dict) -> str:
        for sym, l_media in d_media.items():
            count = conv.count(sym)
            if count > 0:
                assert count == len(l_media), (
                    f"{count} {sym} in text, {len(l_media)} media given")
            elif l_media:
                conv = (sym + " ") * len(l_media) + conv
        return conv

    def replace_media_token_with_media(self, tokens: List, labels: List,
                                       d_media: Dict):
        counter = {k: 0 for k in d_media}
        for i, t in enumerate(tokens):
            if t in self.d_media_token2symbol:
                sym = self.d_media_token2symbol[t]
                media = d_media[sym][counter[sym]]
                counter[sym] += 1
                tokens[i] = media
                media["to_predict"] = labels[i] > 0
        assert all(counter[k] == len(d_media[k]) for k in d_media)
        return tokens, labels

    # -- main entry ----------------------------------------------------------
    def process_item(self, data_item: Dict, training_mode: bool = False):
        d_media = self.collect_and_process_media(data_item)
        source = data_item["conversations"]
        if not self.implicit_at_beginning:
            source = self.insert_implicit_media_symbol_in_q1(source, d_media)
        processed = self.conv_template(source)
        conversation, pieces = processed["conv"], processed["pieces"]
        if self.implicit_at_beginning:
            conversation = self.insert_implicit_media_symbol_at_beginning(
                conversation, d_media)

        tokens = self.tokenizer.encode(conversation, bos=True, eos=False)
        labels = [IGNORE for _ in tokens]

        for sym, l_media in d_media.items():
            tok = self.d_media_symbol2token[sym]
            assert tokens.count(tok) == len(l_media), (
                f"{tokens.count(tok)} {sym} tokens vs {len(l_media)} media")

        pos = 0
        for i, p in enumerate(pieces):
            if i == 0:
                piece_tokens = self.tokenizer.encode(p["data"], bos=True,
                                                     eos=False)
            else:
                piece_tokens = self.tokenizer.encode_wo_prefix_space(p["data"])
            assert tokens[pos:pos + len(piece_tokens)] == piece_tokens, (
                "conversation/pieces tokenization mismatch")
            if p["predict"]:
                labels[pos:pos + len(piece_tokens)] = piece_tokens
            pos += len(piece_tokens)

        if training_mode and all(l <= 0 for l in labels):
            raise LabelAllZeroError()

        tokens, labels = self.replace_media_token_with_media(tokens, labels,
                                                             d_media)
        assert len(tokens) == len(labels)
        return (tokens, labels) if training_mode else tokens

    def predict_item_token_length(self, data_item: Dict) -> int:
        if "conversations" in data_item:
            return sum(len(t["value"]) for t in data_item["conversations"])
        return 1
