"""Tar-shard streaming dataset (the M-variant webdataset pipeline).

Mirrors ``MMaDA-Parallel-M/training/data.py:73-289`` without the webdataset
dependency: brace-expanded shard lists, non-throwing tar sample grouping
(files sharing a basename form one sample; a corrupt member skips the
sample), decode -> caption lookup -> transform -> fixed-count epochs.

Counterpart of :mod:`mmada_parallel_tpu.data.shards`, copied so that the
port imports nothing of the JAX package.  PIL is imported only where an
image is decoded.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import re
import tarfile
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

__all__ = ["braceexpand", "ShardReader", "Text2ImageShardDataset",
           "InterleavePairShardDataset",
           "SidecarCaptions", "JsonCaptions", "CsvCaptions", "CaptionRouter",
           "CaptionProcessor", "remove_caption_prefix"]


def braceexpand(pattern: str) -> List[str]:
    """Minimal ``{000..123}`` / ``{a,b}`` brace expansion (left-most first)."""
    m = re.search(r"\{([^{}]*)\}", pattern)
    if not m:
        return [pattern]
    body = m.group(1)
    rng = re.fullmatch(r"(\d+)\.\.(\d+)", body)
    if rng:
        lo, hi = rng.group(1), rng.group(2)
        opts = [str(i).zfill(len(lo)) for i in range(int(lo), int(hi) + 1)]
    else:
        opts = body.split(",")
    return [p for opt in opts
            for p in braceexpand(pattern[:m.start()] + opt + pattern[m.end():])]



def _with_epoch(stream_once: Callable[[], Iterator],
                samples_per_epoch: Optional[int]) -> Iterator:
    """webdataset ``with_epoch`` semantics (``data.py:265-289``): a fixed
    per-epoch sample count over an endlessly restarting stream; an empty
    stream terminates instead of spinning."""
    if samples_per_epoch is None:
        yield from stream_once()
        return

    def forever():
        while True:
            n = 0
            for d in stream_once():
                yield d
                n += 1
            if n == 0:
                return
    yield from itertools.islice(forever(), samples_per_epoch)


class ShardReader:
    """Iterate ``(key, {ext: bytes})`` samples from tar shards, tolerating
    corrupt members (``data.py:73-108`` group_by_keys_nothrow).

    Entries stream through the native prefetching tar parser
    (``native/tarstream.cc``: header parsing + read() on a C++ thread with
    the GIL released — the one-process replacement for the reference's
    DataLoader worker processes, ``data.py:279-286``) and fall back to
    Python ``tarfile`` when the native library cannot build
    (``use_native=False`` forces the fallback)."""

    def __init__(self, shards: Sequence[str], handler: str = "warn",
                 use_native: bool = True):
        self.shards = list(shards)
        self.handler = handler
        self.use_native = use_native

    def _entries(self, shard: str) -> Iterator[tuple]:
        """Yield ``(member_name, payload | None)`` — None marks a member
        the fallback reader could not extract (corrupt sample sentinel)."""
        if self.use_native:
            from mmada_parallel_torch.data import tarstream
            if tarstream.native_available():
                with tarstream.NativeTarStream(shard) as ts:
                    yield from ts
                return
        with tarfile.open(shard) as tf:
            for member in tf:
                if not member.isfile():
                    continue
                try:
                    data = tf.extractfile(member).read()
                except Exception:
                    yield member.name, None
                    continue
                yield member.name, data

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for shard in self.shards:
            try:
                current_key: Optional[str] = None
                sample: Dict[str, Any] = {}
                for name, data in self._entries(shard):
                    base = os.path.basename(name)
                    if "." not in base:
                        continue
                    key, ext = base.split(".", 1)
                    if current_key is not None and key != current_key:
                        if sample:
                            yield sample
                        sample = {}
                    current_key = key
                    if data is None:  # corrupt member -> drop the sample
                        sample = {}
                        current_key = None
                        continue
                    sample.setdefault("__key__", key)
                    sample.setdefault("__url__", shard)
                    sample[ext.lower()] = data
                if sample:
                    yield sample
            except (tarfile.TarError, OSError) as e:
                if self.handler == "raise":
                    raise
                print(f"[shards] skipping corrupt shard {shard}: {e}")


# ---------------------------------------------------------------------------
# Caption sources — the reference's external-caption zoo
# (``training/data.py:206-228`` loaders + ``:338-530`` per-dataset branches)
# expressed as composable lookup objects routed by shard URL.
# ---------------------------------------------------------------------------

# ``remove_prefix`` (``training/data.py:142-151``)
_CAPTION_PREFIXES = (
    "The image features ", "The image presents ",
    "The image you've sent is, ", "In the center of the image, ",
    "The image showcases ", "The image is ", "The image captures ",
    "In the given image ", "The image portrays ", "In the image, ",
    "In this image, we see ", "The image depicts ", "This is ",
    "In this image, ", "This image captures ",
)


def remove_caption_prefix(caption: str) -> str:
    for p in _CAPTION_PREFIXES:
        caption = caption.replace(p, "")
    return caption


class SidecarCaptions:
    """Per-key caption files on disk.

    ``nested=False``: ``<root>/<key><ext>`` (the SA1B layout,
    ``data.py:339-345``); ``nested=True``: ``<root>/<shard-stem>/<key><ext>``
    (the LAION-12M / CC12M layout, ``data.py:367-372,397-402``)."""

    def __init__(self, root: str, ext: str = ".txt", nested: bool = False):
        self.root, self.ext, self.nested = root, ext, nested

    def lookup(self, url: str, key: str) -> Optional[str]:
        base = key.split("/")[-1]
        if self.nested:
            stem = os.path.basename(url).split(".")[0]
            path = os.path.join(self.root, stem, base + self.ext)
        else:
            path = os.path.join(self.root, base + self.ext)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read().strip()


class JsonCaptions:
    """One json dict ``key -> caption`` or ``key -> [captions]`` (the
    JourneyDB layout, ``data.py:206-210,522-528``); list values pick the
    first entry (pass ``pick`` for another policy, e.g. seeded random)."""

    def __init__(self, path: str, pick: Optional[Callable] = None):
        with open(path) as f:
            self.table = json.load(f)
        self.pick = pick or (lambda lst: lst[0])

    def lookup(self, url: str, key: str) -> Optional[str]:
        v = self.table.get(key)
        if isinstance(v, list):
            return self.pick(v) if v else None
        return v


class CsvCaptions:
    """CSV keyed on an image-filename column (the ai2d/clevr/docvqa/geo
    layout, ``data.py:212-219,437-508``: key matched as
    ``<key><key_suffix>``)."""

    def __init__(self, path: str, key_col: str = "image",
                 caption_col: str = "caption", key_suffix: str = ""):
        import csv
        self.table: Dict[str, str] = {}
        with open(path) as f:
            for row in csv.DictReader(f):
                k, c = row.get(key_col), row.get(caption_col)
                if k and c is not None:
                    self.table[str(k)] = c
        self.key_suffix = key_suffix

    def lookup(self, url: str, key: str) -> Optional[str]:
        return self.table.get(key.split("/")[-1] + self.key_suffix)


class CaptionRouter:
    """URL-substring -> source: the reference's if/elif chain over
    ``sample['__url__']`` (``data.py:338-530``) as data.

    ``routes``: ordered ``(substring, source)`` pairs; first match wins;
    ``default`` handles everything else (``None`` -> fall through to the
    sample's own txt/json members)."""

    def __init__(self, routes: Sequence = (), default=None):
        self.routes = list(routes)
        self.default = default

    def lookup(self, url: str, key: str) -> Optional[str]:
        # match the shard URL only — the reference's chain tests
        # sample['__url__'] exclusively (data.py:338-530); matching the
        # per-sample key would misroute e.g. key 'geometry3k_0012' inside a
        # cc12m shard to a ('geo', ...) route
        for substr, source in self.routes:
            if substr in url:
                return source.lookup(url, key)
        if self.default is not None:
            return self.default.lookup(url, key)
        return None


class CaptionProcessor:
    """Caption post-processing (``data.py:311-334,345-365``): captioning
    mode prepends a sampled instruction prompt; generation mode optionally
    truncates to the first sentence (prob 0.5) and strips boilerplate
    prefixes.  ``rng``: ``random.Random``-like; None = deterministic
    (no prompt, full caption)."""

    def __init__(self, is_captioning: bool = False,
                 prompts: Optional[Sequence[str]] = None, rng=None,
                 short_caption_prob: float = 0.5):
        self.is_captioning = is_captioning
        self.prompts = list(prompts) if prompts else None
        self.rng = rng
        self.short_caption_prob = short_caption_prob

    def __call__(self, caption: str) -> str:
        if self.is_captioning:
            if self.prompts:
                p = (self.rng.choice(self.prompts) if self.rng is not None
                     else self.prompts[0])
                return p + caption
            return caption
        if (self.rng is not None
                and self.rng.random() < self.short_caption_prob):
            caption = caption.split(".")[0]
        return remove_caption_prefix(caption)


class Text2ImageShardDataset:
    """(image, caption) stream with external caption files and a
    ``with_epoch``-style fixed sample count (``data.py:157-289``)."""

    def __init__(self, shard_pattern: str,
                 caption_files: Optional[Sequence[str]] = None,
                 image_exts: Sequence[str] = ("jpg", "jpeg", "png", "webp"),
                 transform: Optional[Callable] = None,
                 tokenize: Optional[Callable] = None,
                 samples_per_epoch: Optional[int] = None,
                 caption_source=None,
                 caption_processor: Optional[Callable] = None):
        self.shards = braceexpand(shard_pattern)
        self.image_exts = image_exts
        self.transform = transform
        self.tokenize = tokenize
        self.samples_per_epoch = samples_per_epoch
        # external sources take precedence over in-sample txt/json, matching
        # the reference's pipeline split (data.py:236-265)
        self.caption_source = caption_source
        self.caption_processor = caption_processor
        self.captions: Dict[str, str] = {}
        for cf in caption_files or []:
            if cf.endswith(".json"):
                with open(cf) as f:
                    self.captions.update(json.load(f))
            elif cf.endswith(".csv"):
                import csv
                with open(cf) as f:
                    for row in csv.DictReader(f):
                        key = row.get("key") or row.get("image")
                        cap = row.get("caption") or row.get("text")
                        if key and cap:
                            self.captions[key] = cap

    def _decode(self, sample: Dict) -> Optional[Dict]:
        from PIL import Image
        img_bytes = next((sample[e] for e in self.image_exts if e in sample),
                         None)
        if img_bytes is None:
            return None
        try:
            img = Image.open(io.BytesIO(img_bytes)).convert("RGB")
        except Exception:
            return None
        caption = None
        if self.caption_source is not None:
            caption = self.caption_source.lookup(
                sample.get("__url__", ""), sample["__key__"])
        if caption is None and "txt" in sample:
            caption = sample["txt"].decode("utf-8", errors="replace")
        elif caption is None and "json" in sample:
            try:
                caption = json.loads(sample["json"]).get("caption")
            except Exception:
                caption = None
        if caption is None:
            caption = self.captions.get(sample["__key__"], "")
        if self.caption_processor is not None:
            caption = self.caption_processor(caption)
        out: Dict[str, Any] = {"__key__": sample["__key__"],
                               "image": img, "caption": caption}
        if self.transform is not None:
            out["pixels"] = self.transform(img)
        if self.tokenize is not None:
            out["input_ids"] = self.tokenize(caption)
        return out

    def _stream_once(self):
        for s in ShardReader(self.shards):
            d = self._decode(s)
            if d is not None:
                yield d

    def __iter__(self):
        yield from _with_epoch(self._stream_once, self.samples_per_epoch)


class InterleavePairShardDataset:
    """(input image, instruction, output image, output text) edit-pair
    stream for the interleave SFT trainer.

    Mirrors the reference's ``normalize_example`` field zoo
    (``train_interleave.py:340-476``): each candidate key list is scanned
    in order, missing images become black placeholders and mark the sample
    ``is_text_only`` (input) — exactly the reference's fallbacks — while a
    sample with neither text field is dropped.
    """

    IN_TEXT_KEYS = ("input_text.txt", "input_text", "instruction", "prompt",
                    "text", "txt")
    OUT_TEXT_KEYS = ("output_text.txt", "output_text", "reasoning_text",
                     "caption", "answer")
    IN_IMG_KEYS = ("input.jpg", "input_image", "image.jpg", "image", "img",
                   "jpg", "png")
    OUT_IMG_KEYS = ("output.jpg", "output_image", "output_image.jpg",
                    "out_img")

    def __init__(self, shard_pattern: str,
                 transform: Optional[Callable] = None,
                 resolution: int = 512,
                 samples_per_epoch: Optional[int] = None):
        self.shards = braceexpand(shard_pattern)
        self.transform = transform
        self.resolution = resolution
        self.samples_per_epoch = samples_per_epoch

    def _text(self, sample: Dict, keys) -> Optional[str]:
        for k in keys:
            v = sample.get(k)
            if not v:
                continue
            if isinstance(v, bytes):
                try:
                    s = v.decode("utf-8").strip()
                except UnicodeDecodeError:
                    continue
            else:
                s = str(v).strip()
            if s:  # whitespace-only falls through to the next candidate
                return s  # (train_interleave.py:347-361 `if input_text`)
        return None

    def _image(self, sample: Dict, keys):
        from PIL import Image
        for k in keys:
            v = sample.get(k)
            if not v:
                continue
            try:
                return Image.open(io.BytesIO(v)).convert("RGB")
            except Exception:
                continue
        return None

    def _decode(self, sample: Dict) -> Optional[Dict]:
        from PIL import Image
        instruction = self._text(sample, self.IN_TEXT_KEYS) or ""
        output_text = self._text(sample, self.OUT_TEXT_KEYS) or ""
        if not instruction and not output_text:
            return None
        img_in = self._image(sample, self.IN_IMG_KEYS)
        img_out = self._image(sample, self.OUT_IMG_KEYS)
        is_text_only = img_in is None
        # single-image (t2i-style) samples train with input == target — the
        # reference would substitute a black placeholder here with a warning
        # per sample (train_interleave.py:463-466), which silently trains
        # the image branch toward black; input-as-target is the useful
        # semantics for caption-only shards
        if img_out is None and img_in is not None:
            img_out = img_in
        if img_in is None or img_out is None:
            placeholder = Image.new("RGB",
                                    (self.resolution, self.resolution),
                                    (0, 0, 0))
            img_in = img_in if img_in is not None else placeholder
            img_out = img_out if img_out is not None else placeholder
        out: Dict[str, Any] = {
            "__key__": sample["__key__"],
            "instruction": instruction,
            "output_text": output_text,
            "input_image": img_in,
            "output_image": img_out,
            "is_text_only": is_text_only,
        }
        if self.transform is not None:
            out["pixels_in"] = self.transform(img_in)
            out["pixels_out"] = self.transform(img_out)
        return out

    def _stream_once(self):
        for s in ShardReader(self.shards):
            d = self._decode(s)
            if d is not None:
                yield d

    def __iter__(self):
        yield from _with_epoch(self._stream_once, self.samples_per_epoch)
