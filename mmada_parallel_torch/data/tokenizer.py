"""Tokenizer wrapper with segment-style probing (variant A's ``Tokenizer``).

Mirrors ``MMaDA-Parallel-A/xllm/model/tokenizer.py:20-156``: one interface
over sentencepiece ``.model`` files and HF tokenizers, with the
leading-space style probe that makes mid-text segment encoding consistent
(``_probe_tokenizer_style``, ``encode_segment``/``encode_wo_prefix_space``).

Counterpart of :mod:`mmada_parallel_tpu.data.tokenizer`, copied so that the
port imports nothing of the JAX package; ``sentencepiece`` and
``transformers`` are imported inside ``__init__``.
"""

from __future__ import annotations

from typing import List

__all__ = ["Tokenizer", "ConversationTemplate"]


class Tokenizer:
    def __init__(self, model_path: str):
        if model_path.endswith(".model"):
            try:
                from sentencepiece import SentencePieceProcessor
            except ImportError as e:
                raise ImportError(
                    "sentencepiece is required for .model tokenizers") from e
            self.tokenizer_type = "spm"
            self.tokenizer = SentencePieceProcessor(model_file=model_path)
            self.bos_id = self.tokenizer.bos_id()
            self.eos_id = self.tokenizer.eos_id()
        else:
            from transformers import AutoTokenizer
            self.tokenizer_type = "transformers"
            self.tokenizer = AutoTokenizer.from_pretrained(
                model_path, trust_remote_code=True)
            self.bos_id = (self.tokenizer.bos_token_id
                           if self.tokenizer.bos_token_id is not None
                           else self.tokenizer.eos_token_id)
            self.eos_id = self.tokenizer.eos_token_id
        self._probe_tokenizer_style()

    @property
    def n_words(self) -> int:
        if self.tokenizer_type == "spm":
            return self.tokenizer.vocab_size()
        return len(self.tokenizer)

    def encode(self, s: str, bos: bool, eos: bool) -> List[int]:
        if self.tokenizer_type == "transformers":
            t = self.tokenizer.encode(s, truncation=False,
                                      add_special_tokens=False)
        else:
            t = self.tokenizer.encode(s)
        if bos:
            t = [self.bos_id] + t
        if eos:
            t = t + [self.eos_id]
        return t

    def encode_segment(self, s: str) -> List[int]:
        s = s.lstrip(" ")
        if self.need_space_before_segment:
            return self.encode(" " + s, bos=False, eos=False)
        return self.encode(s, bos=False, eos=False)

    def encode_wo_prefix_space(self, s: str) -> List[int]:
        if self.need_space_before_segment:
            return self.encode(s, bos=False, eos=False)
        for prefix in ["@", "\n", "\\", "=", ">", "`"]:
            pt = self.encode(prefix, bos=False, eos=False)
            ct = self.encode(prefix + s, bos=False, eos=False)
            if ct[:len(pt)] == pt:
                return ct[len(pt):]
        raise NotImplementedError(
            f"all probe prefixes merged into {s!r} during tokenization")

    def _probe_tokenizer_style(self):
        s1 = self.encode("Hi my darling", bos=False, eos=False)
        s2 = self.encode("my darling", bos=False, eos=False)
        if s1[-len(s2):] == s2:
            self.need_space_before_segment = False
        else:
            s3 = self.encode(" my darling", bos=False, eos=False)
            assert s1[-len(s3):] == s3
            self.need_space_before_segment = True

    def decode(self, t: List[int]) -> str:
        return self.tokenizer.decode(t)


class ConversationTemplate:
    """Minimal role/message container (``xllm/data/conversation/template.py``)."""

    roles = ("user", "assistant")

    def __init__(self):
        self.messages: List[List[str]] = []

    def append_message(self, role: str, message: str):
        self.messages.append([role, message])

    def clear(self):
        self.messages = []
