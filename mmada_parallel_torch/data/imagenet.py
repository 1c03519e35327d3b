"""Class-folder image dataset with templated captions.

Mirrors ``MMaDA-Parallel-M/training/imagenet_dataset.py:24-82``: an
ImageNet-style directory of class folders yields (image, "An image of
{label}") pairs; an optional ``class_mapping`` json maps folder names to
human labels.

Counterpart of :mod:`mmada_parallel_tpu.data.imagenet`, copied so that the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional, Tuple

__all__ = ["ImageFolderCaptionDataset"]

IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


class ImageFolderCaptionDataset:
    def __init__(self, root: str,
                 caption_template: str = "An image of {label}.",
                 class_mapping_json: Optional[str] = None,
                 transform: Optional[Callable] = None):
        self.root = root
        self.transform = transform
        self.caption_template = caption_template
        mapping = {}
        if class_mapping_json:
            with open(class_mapping_json) as f:
                mapping = json.load(f)
        self.samples: List[Tuple[str, str]] = []
        for cls in sorted(os.listdir(root)):
            cdir = os.path.join(root, cls)
            if not os.path.isdir(cdir):
                continue
            label = mapping.get(cls, cls.replace("_", " "))
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(IMG_EXTS):
                    self.samples.append((os.path.join(cdir, fn), label))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int):
        from PIL import Image
        path, label = self.samples[i]
        img = Image.open(path).convert("RGB")
        caption = self.caption_template.format(label=label)
        out = {"image": img, "caption": caption, "path": path}
        if self.transform is not None:
            out["pixels"] = self.transform(img)
        return out
