"""Offline VQ pre-tokenizer with sharded progress-resume.

Mirrors the A-variant offline pipeline
(``MMaDA-Parallel-A/pre_tokenizer/pre_tokenize.py:143-342`` +
``data/item_processor.py:69-203`` + ``pre_tokenizer/concat_record.py``):

* images are var-center-cropped against the 32px crop ladder, encoded to VQ
  codes on the device (here: the port's Amused-VQ or MagViT-v2 encoder,
  run inside ``vq_precision()``: TF32 off), and written as ``{"input_ids", "height", "width"}`` pickles;
* work splits into N shards; each shard appends to a jsonl record file and
  keeps a ``{shard}-progress.txt`` high-water mark so a killed run resumes;
  a ``finished`` sentinel marks completion;
* ``concat_records`` merges shard records into ``all_records.json``.

Counterpart of :mod:`mmada_parallel_tpu.data.pretokenize`, copied so that
the port imports nothing of the JAX package; ``datasets`` (and through it
``pyarrow``) is imported only by :func:`parquet_items`.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

__all__ = ["PreTokenizer", "concat_records"]


class PreTokenizer:
    def __init__(self, encode_fn: Callable[[np.ndarray], np.ndarray],
                 out_dir: str, shard: int = 0, num_shards: int = 1,
                 target_size: int = 512):
        """``encode_fn``: ``[1, H, W, 3] float32 -> [1, N] codes``, an
        array or a tensor on any device (e.g. a wrapped Amused-VQ
        ``encode+quantize``); it is called inside ``vq_precision()`` and
        without autograd."""
        self.encode_fn = encode_fn
        self.out_dir = out_dir
        self.shard = shard
        self.num_shards = num_shards
        self.target_size = target_size
        os.makedirs(os.path.join(out_dir, "tokens"), exist_ok=True)
        self.record_path = os.path.join(out_dir, f"{shard:05d}-record.jsonl")
        self.progress_path = os.path.join(out_dir, f"{shard:05d}-progress.txt")
        self.finished_path = os.path.join(out_dir, f"{shard:05d}-finished")

    def _progress(self) -> int:
        if os.path.exists(self.progress_path):
            with open(self.progress_path) as f:
                txt = f.read().strip()
                return int(txt) if txt else -1
        return -1

    def encode_image(self, img) -> Dict[str, Any]:
        from mmada_parallel_torch.models.vqgan_common import vq_precision
        from mmada_parallel_torch.utils.image import (generate_crop_size_list,
                                                      var_center_crop,
                                                      image_to_array)
        crop_list = generate_crop_size_list((self.target_size // 32) ** 2, 32)
        img = var_center_crop(img.convert("RGB"), crop_list)
        w, h = img.size
        with torch.no_grad(), vq_precision():
            codes = self.encode_fn(image_to_array(img))
        if isinstance(codes, torch.Tensor):
            codes = codes.cpu().numpy()
        codes = np.asarray(codes)[0]
        return {"input_ids": [int(c) for c in codes], "height": h, "width": w}

    def run(self, items: Iterable[Dict], load_image: Callable[[Dict], Any],
            log_every: int = 100) -> int:
        """Process this shard's slice of ``items``; returns #processed.

        Each record gets ``{"id", "token_path", ...item metadata}``.
        """
        if os.path.exists(self.finished_path):
            return 0
        items = list(items)[self.shard::self.num_shards]
        start = self._progress() + 1
        done = 0
        with open(self.record_path, "a") as rec:
            for i in range(start, len(items)):
                item = items[i]
                rec_entry = dict(item)
                img = load_image(item)
                out = self.encode_image(img)
                tok_path = os.path.join(
                    self.out_dir, "tokens", f"{self.shard:05d}-{i:08d}.pkl")
                with open(tok_path, "wb") as f:
                    pickle.dump(out, f)
                rec_entry["token_path"] = tok_path
                rec_entry["len"] = len(out["input_ids"])
                rec.write(json.dumps(rec_entry) + "\n")
                rec.flush()
                with open(self.progress_path, "w") as f:
                    f.write(str(i))
                done += 1
        with open(self.finished_path, "w") as f:
            f.write("ok")
        return done


def parquet_items(dataset_path: str, task_type: str,
                  target_size: int = 512):
    """Yield (caption, images) pre-tokenizer items from an HF arrow/parquet
    dataset, by task type.

    Mirrors ``pre_tokenizer/pre_tokenize.py:44-140`` (``ParquetItemProcessor``):
    field-name fallbacks per task (edit/ti2ti: input+output image pairs;
    t2i: one image; mmu / mmu_multi_image: context image(s)), caption from
    the first present of input_text/prompt/caption/instruction/text.
    """
    import io as _io
    from PIL import Image
    from datasets import load_dataset, load_from_disk

    try:
        ds = load_from_disk(dataset_path)
    except Exception:
        ds = load_dataset(dataset_path, split="train")

    def load_img(field):
        if hasattr(field, "convert"):
            return field.convert("RGB")
        if isinstance(field, (bytes, bytearray)):
            return Image.open(_io.BytesIO(field)).convert("RGB")
        if isinstance(field, dict) and "bytes" in field:
            return Image.open(_io.BytesIO(field["bytes"])).convert("RGB")
        if isinstance(field, str):
            from mmada_parallel_torch.data.reader import read_general
            return Image.open(read_general(field)).convert("RGB")
        raise ValueError(f"unsupported image field type: {type(field)}")

    def first_image(item, keys):
        for k in keys:
            if item.get(k) is not None:
                try:
                    return load_img(item[k])
                except Exception:
                    continue
        return None

    for item in ds:
        if task_type in ("edit", "ti2ti"):
            a = first_image(item, ["input_image", "input_image_bytes", "image"])
            b = first_image(item, ["output_image", "output_image_bytes",
                                   "edited_image"])
            if a is None or b is None:
                continue
            images = [a, b]
        elif task_type == "t2i":
            img = first_image(item, ["output_image", "image",
                                     "output_image_bytes", "image_bytes"])
            if img is None:
                continue
            images = [img]
        elif task_type in ("mmu", "mmu_single_image"):
            img = first_image(item, ["input_image", "image",
                                     "input_image_bytes", "image_bytes"])
            if img is None:
                continue
            images = [img]
        elif task_type == "mmu_multi_image":
            lst = next((item[k] for k in ["image_list", "images",
                                          "input_images"] if item.get(k)),
                       None)
            if not lst:
                continue
            images = [load_img(e["image"] if isinstance(e, dict) else e)
                      for e in lst]
        else:
            raise ValueError(f"unsupported task type: {task_type}")

        caption = next((item[k] for k in ("input_text", "prompt", "caption",
                                          "instruction", "text")
                        if item.get(k) is not None), None)
        if caption is None:
            continue
        yield {"caption": caption, "images": images, "task_type": task_type}


def concat_records(out_dir: str, num_shards: int,
                   output: str = "all_records.json") -> str:
    """Merge shard jsonl records (``pre_tokenizer/concat_record.py:16-55``)."""
    all_recs: List[Dict] = []
    for s in range(num_shards):
        p = os.path.join(out_dir, f"{s:05d}-record.jsonl")
        if not os.path.exists(p):
            continue
        with open(p) as f:
            all_recs.extend(json.loads(l) for l in f if l.strip())
    out_path = os.path.join(out_dir, output)
    with open(out_path, "w") as f:
        json.dump(all_recs, f)
    return out_path
