"""UniversalPrompting (variant M) — task-sequence builders, numpy host-side.

Mirrors ``MMaDA-Parallel-M/training/prompting_utils.py:33-470``.  Each
builder returns ``(sequence_ids, masks, labels)`` numpy arrays with exactly
the reference's layouts:

* ``t2i``:  ``[left pad][<|t2i|>][bos]text[eos][<|soi|>]image[<|eoi|>]``
  with attention 0 on pads; labels copy the text (pads -> -100) and the
  image-label row (``:81-133``).
* ``lm``:   ``[bos]text[eos][eos pad...]`` labels = ids (``:171-203``).
* ``lm_chat``: same ids; mask marks the prompt up to the last
  ``<|end_header_id|>`` (``:205-248``).
* ``mmu``:  ``[<|mmu|>][<|soi|>]image[<|eoi|>][bos]text[eos pad...]`` with a
  prompt mask through the image prefix / header (``:250-311``).
* ``r2i``:  ``[<|r2i|>]text_full[<|soi|>]image[<|eoi|>]`` with sparse prompt
  mask (``:361-409``).
* ``interleave`` (from ``train_interleave.py:700-799``):
  ``[task][<|soi|>]img_in[<|eoi|>][bos]text_in[eos][pad eos...]
  [<|soi|>]img_out[<|eoi|>]text_out`` with the padding attention masks.

A ``TokenizerLike`` needs ``bos_token_id``, ``eos_token_id``, and
``__call__(texts)['input_ids']``.

Counterpart of :mod:`mmada_parallel_tpu.data.prompting`, copied so that the
port imports nothing of the JAX package.  It stays numpy host code: the
dropout streams are numpy ``default_rng(0)`` draws, so both packages draw
the same ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from mmada_parallel_torch.tokens import TOKENS_M, VariantMTokens

__all__ = ["UniversalPrompting", "encode_output_texts"]

IGNORE = -100


def encode_output_texts(tokenizer: Any, texts: Sequence[str], msl: int,
                        tokens: VariantMTokens = TOKENS_M
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Output-text rows normalized like ``train_interleave.py:735-747``:
    bos-prefixed, eos-suffixed (only when not already present), eos fill;
    truncation keeps a final eos (``ids[:msl-1] + [eos]``) so the trained
    layout always matches the inference template.

    Returns ``(padded_ids [B, msl], lengths [B])`` where ``lengths`` are the
    pre-padding lengths the reference uses to build the output padding
    attention mask (``train_interleave.py:741-745``).
    """
    from mmada_parallel_torch.tokens import normalize_text_ids
    _bos = getattr(tokenizer, "bos_token_id", None)
    _eos = getattr(tokenizer, "eos_token_id", None)
    bos = tokens.bos if _bos is None else int(_bos)
    eos = tokens.eos if _eos is None else int(_eos)
    out = np.full((len(texts), msl), eos, np.int64)
    out[:, 0] = bos
    lengths = np.full(len(texts), 2, np.int64)  # bare [bos, eos]
    if tokenizer is None:
        return out, lengths
    for i, t in enumerate(texts):
        ids = normalize_text_ids(
            list(tokenizer(t)["input_ids"]) if t else [],
            bos, eos, append_eos_always=False)
        if len(ids) > msl:
            ids = ids[:msl - 1] + [eos]
        out[i, :len(ids)] = np.asarray(ids, np.int64)
        lengths[i] = len(ids)
    return out, lengths


@dataclasses.dataclass
class UniversalPrompting:
    tokenizer: Any
    max_text_len: int = 512            # reference stores max_text_len + 1
    cond_dropout_prob: float = 0.1
    tokens: VariantMTokens = TOKENS_M
    end_header_id: Optional[int] = None
    rng: Any = None

    def __post_init__(self):
        self.max_text_len = self.max_text_len + 1  # prompting_utils.py:78
        if self.rng is None:
            self.rng = np.random.default_rng(0)

    # -- helpers ---------------------------------------------------------
    def _bos_eos(self, ids: Sequence[int]) -> List[int]:
        ids = list(ids)
        bos, eos = self.tokenizer.bos_token_id, self.tokenizer.eos_token_id
        if not ids or ids[0] != bos:
            ids = [bos] + ids
        if ids[-1] != eos:
            ids = ids + [eos]
        return ids

    def _header_prompt_len(self, ids: Sequence[int]) -> int:
        if self.end_header_id is None:
            return 0
        for pos in range(len(ids) - 1, -1, -1):
            if ids[pos] == self.end_header_id:
                return pos + 1
        return 0

    # -- t2i -------------------------------------------------------------
    def t2i(self, texts: Sequence[str], image_ids: np.ndarray,
            image_labels: np.ndarray, dropout: bool = True):
        tk = self.tokens
        bos, eos = self.tokenizer.bos_token_id, self.tokenizer.eos_token_id
        text_ids = self.tokenizer(list(texts))["input_ids"]
        N_img = image_ids.shape[-1]
        seqs, masks, labels = [], [], []
        for i, t in enumerate(text_ids):
            t = list(t)
            if not t or t[0] != bos:
                t = [bos] + t
            temp = [tk.t2i] + t + [eos]
            if dropout and self.rng.random() < self.cond_dropout_prob:
                temp = [tk.t2i, bos, eos]
            if self.max_text_len >= len(temp):
                old = len(temp)
                temp = [tk.ipad] * (self.max_text_len - old) + temp
                mask = [0] * (self.max_text_len - old) + [1] * (old + N_img + 2)
            else:
                temp = temp[:self.max_text_len - 1] + [eos]
                mask = [1] * (len(temp) + N_img + 2)
            lab = np.concatenate([np.asarray(temp), [tk.soi],
                                  image_labels[i], [tk.eoi]])
            lab = np.where(lab == tk.ipad, IGNORE, lab)
            seq = np.concatenate([np.asarray(temp), [tk.soi],
                                  image_ids[i], [tk.eoi]])
            seqs.append(seq); masks.append(np.asarray(mask)); labels.append(lab)
        return (np.stack(seqs).astype(np.int64), np.stack(masks),
                np.stack(labels).astype(np.int64))

    def t2i_gen(self, texts: Sequence[str], image_ids: np.ndarray):
        s, m, _ = self.t2i(texts, image_ids, np.full_like(image_ids, IGNORE),
                           dropout=False)
        return s, m

    # -- lm --------------------------------------------------------------
    def lm(self, texts: Sequence[str], max_seq_len: int):
        eos = self.tokenizer.eos_token_id
        text_ids = self.tokenizer(list(texts))["input_ids"]
        seqs, masks, labels = [], [], []
        for t in text_ids:
            temp = self._bos_eos(t)
            if max_seq_len >= len(temp):
                n = len(temp)
                temp = temp + [eos] * (max_seq_len - n)
                mask = [1] * n + [0] * (max_seq_len - n)
            else:
                temp = temp[:max_seq_len]
                mask = [1] * max_seq_len
            seqs.append(np.asarray(temp)); masks.append(np.asarray(mask))
            labels.append(np.asarray(temp))
        return (np.stack(seqs).astype(np.int64), np.stack(masks),
                np.stack(labels).astype(np.int64))

    def lm_chat(self, texts: Sequence[str], max_seq_len: int):
        seqs, _, labels = self.lm(texts, max_seq_len)
        masks = []
        for row in seqs:
            pl = self._header_prompt_len(list(row))
            masks.append(np.asarray([1] * pl + [0] * (len(row) - pl)))
        return seqs, np.stack(masks), labels

    # -- mmu -------------------------------------------------------------
    def mmu(self, image_ids: np.ndarray, texts: Sequence[str]):
        tk = self.tokens
        eos = self.tokenizer.eos_token_id
        mtl = self.max_text_len - 1
        text_ids = self.tokenizer(list(texts))["input_ids"]
        N_img = image_ids.shape[-1]
        seqs, masks, labels = [], [], []
        for i, t in enumerate(text_ids):
            temp = self._bos_eos(t)
            if mtl >= len(temp):
                temp = temp + [eos] * (mtl - len(temp))
            else:
                temp = temp[:mtl - 1] + [eos]
            lab = np.concatenate([[IGNORE, IGNORE],
                                  np.full(N_img, IGNORE), [IGNORE],
                                  np.asarray(temp)])
            lab = np.where(lab == tk.ipad, IGNORE, lab)
            seq = np.concatenate([[tk.mmu, tk.soi], image_ids[i], [tk.eoi],
                                  np.asarray(temp)])
            hp = self._header_prompt_len(temp)
            prompt_len = len(seq) - len(temp) + hp
            mask = [1] * prompt_len + [0] * (len(seq) - prompt_len)
            seqs.append(seq); masks.append(np.asarray(mask)); labels.append(lab)
        return (np.stack(seqs).astype(np.int64), np.stack(masks),
                np.stack(labels).astype(np.int64))

    # -- r2i -------------------------------------------------------------
    def r2i(self, image_ids: np.ndarray, texts: Sequence[str]):
        tk = self.tokens
        eos = self.tokenizer.eos_token_id
        mtl = self.max_text_len - 1
        text_ids = self.tokenizer(list(texts))["input_ids"]
        seqs, masks = [], []
        for i, t in enumerate(text_ids):
            temp = self._bos_eos(t)
            if mtl >= len(temp):
                full = temp + [eos] * (mtl - len(temp))
            else:
                full = temp[:mtl - 1] + [eos]
            seq = np.concatenate([[tk.r2i], np.asarray(full), [tk.soi],
                                  image_ids[i], [tk.eoi]])
            mask = np.zeros(len(seq), np.int64)
            mask[0] = 1
            hp = self._header_prompt_len(full)
            if hp > 0:
                mask[1:hp + 1] = 1
            else:
                mask[1:len(full) + 1] = 1
            mask[len(full) + 1] = 1
            mask[len(full) + 2 + image_ids.shape[-1]] = 1
            seqs.append(seq); masks.append(mask)
        s = np.stack(seqs).astype(np.int64)
        return s, np.stack(masks), s.copy()

    # -- interleave (train_interleave.py:700-799) ------------------------
    def interleave(self, input_image_ids: np.ndarray,
                   input_texts: Sequence[str],
                   output_image_ids: np.ndarray,
                   output_text_ids: np.ndarray,
                   output_text_labels: np.ndarray,
                   task_token: Optional[int] = None,
                   cond_dropout_prob: float = 0.0,
                   output_image_labels: Optional[np.ndarray] = None,
                   output_text_lengths: Optional[Sequence[int]] = None,
                   is_text_only: Optional[Sequence[bool]] = None):
        """Builds the interleave SFT sequence.  ``output_text_ids`` /
        ``output_text_labels`` are the already-noised text and its labels
        (from :func:`mmada_parallel_torch.training.masking.interleave_noising`),
        fixed-length ``max_seq_length``.

        ``is_text_only`` rows get the ``<|t2it|>`` task token and zeroed
        input-image tokens (``train_interleave.py:640-643,684``; the
        reference's ``'<t2it>'`` lookup at :684 is a KeyError-on-touch typo
        for ``'<|t2it|>'`` — the intended id is used here)."""
        tk = self.tokens
        bos, eos = self.tokenizer.bos_token_id, self.tokenizer.eos_token_id
        # <|interleave|> = 126095 (train_interleave.py:13, inference.py:13)
        task_default = task_token if task_token is not None else tk.interleave
        in_text = self.tokenizer(list(input_texts))["input_ids"]
        B, N_in = input_image_ids.shape
        msl = output_text_ids.shape[1]
        if output_image_labels is None:
            output_image_labels = np.full_like(output_image_ids, IGNORE)
        # pre-draw both dropout streams for ALL rows up front
        # (train_interleave.py:675-676) so seeded runs reproduce regardless
        # of how many rows are text-only
        drop_text = self.rng.random(B)
        drop_img = self.rng.random(B)
        seqs, labels, masks = [], [], []
        for i in range(B):
            text_only = bool(is_text_only[i]) if is_text_only is not None \
                else False
            task = tk.t2it if text_only else task_default
            t = self._bos_eos(in_text[i])
            # text/image condition dropout (train_interleave.py:699-703;
            # image dropout zeroes the tokens)
            if drop_text[i] < cond_dropout_prob:
                t = [bos, eos]
            img_in = input_image_ids[i]
            if text_only or drop_img[i] < cond_dropout_prob:
                img_in = np.zeros_like(img_in)
            max_text = msl
            if max_text >= len(t):
                in_mask = [1] * (len(t) + 3 + N_in) + [0] * (max_text - len(t))
                t = t + [eos] * (max_text - len(t))
            else:
                in_mask = [1] * (max_text + 3 + N_in)
                t = t[:max_text - 1] + [eos]
            in_ids = np.concatenate([[task, tk.soi], img_in, [tk.eoi],
                                     np.asarray(t)])
            in_lab = np.full(len(in_ids), IGNORE)
            out_ids = np.concatenate([[tk.soi], output_image_ids[i],
                                      [tk.eoi], output_text_ids[i]])
            out_lab = np.concatenate([[IGNORE], output_image_labels[i],
                                      [IGNORE], output_text_labels[i]])
            # padding mask over the padded output text tail
            # (train_interleave.py:741-745)
            tlen = (msl if output_text_lengths is None
                    else min(int(output_text_lengths[i]), msl))
            out_mask = ([1] * (2 + output_image_ids.shape[1])
                        + [1] * tlen + [0] * (msl - tlen))
            seqs.append(np.concatenate([in_ids, out_ids]))
            labels.append(np.concatenate([in_lab, out_lab]))
            masks.append(np.asarray(in_mask + out_mask))
        return (np.stack(seqs).astype(np.int64),
                np.stack(labels).astype(np.int64), np.stack(masks))
