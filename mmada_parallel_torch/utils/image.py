"""Host-side image preprocessing (PIL + numpy).

Mirrors ``MMaDA-Parallel-A/utils/image_utils.py:80-157,175-285`` (variable
aspect-ratio crops, painting masks) and the M-side transforms
(``training/utils.py:200-213``).  On-device pixel math (normalize, NHWC)
stays in numpy so the device boundary receives ready tensors.

Counterpart of :mod:`mmada_parallel_tpu.utils.image`, copied so that the port
imports nothing of the JAX package.  PIL is imported inside the functions
that need it, so a caller that hands in arrays never imports it.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "generate_crop_size_list", "center_crop", "var_center_crop",
    "preprocess_image", "image_to_array", "array_to_image",
    "painting_latent_mask", "image_transform", "image_transform_squash",
]


def generate_crop_size_list(num_patches: int, patch_size: int,
                            max_ratio: float = 4.0) -> List[Tuple[int, int]]:
    """All (w, h) with ``w/p * h/p <= num_patches`` and aspect <= max_ratio
    (``image_utils.py:137-147``)."""
    assert max_ratio >= 1.0
    out = []
    wp, hp = num_patches, 1
    while wp > 0:
        if max(wp, hp) / min(wp, hp) <= max_ratio:
            out.append((wp * patch_size, hp * patch_size))
        if (hp + 1) * wp <= num_patches:
            hp += 1
        else:
            wp -= 1
    return out


def center_crop(pil_image, crop_size: Tuple[int, int], rng=random):
    """BOX-downscale, BICUBIC to cover, then random-offset crop
    (``image_utils.py:113-125``)."""
    from PIL import Image
    while (pil_image.size[0] >= 2 * crop_size[0]
           and pil_image.size[1] >= 2 * crop_size[1]):
        pil_image = pil_image.resize(tuple(x // 2 for x in pil_image.size),
                                     resample=Image.BOX)
    scale = max(crop_size[0] / pil_image.size[0],
                crop_size[1] / pil_image.size[1])
    pil_image = pil_image.resize(
        tuple(round(x * scale) for x in pil_image.size),
        resample=Image.BICUBIC)
    left = rng.randint(0, pil_image.size[0] - crop_size[0])
    top = rng.randint(0, pil_image.size[1] - crop_size[1])
    return pil_image.crop((left, top, left + crop_size[0], top + crop_size[1]))


def var_center_crop(pil_image, crop_size_list: Sequence[Tuple[int, int]],
                    random_top_k: int = 1, rng=random):
    """Pick the best-aspect crop size, then crop (``image_utils.py:127-134``)."""
    w, h = pil_image.size
    rem = [min(cw / w, ch / h) / max(cw / w, ch / h)
           for cw, ch in crop_size_list]
    best = sorted(zip(rem, crop_size_list), reverse=True)[:random_top_k]
    crop_size = rng.choice(best)[1]
    return center_crop(pil_image, crop_size, rng=rng)


def preprocess_image(path_or_img, target_size: Tuple[int, int] = (512, 512)):
    """Reference entry-point crop pipeline (``image_utils.py:80-93``)."""
    from PIL import Image
    img = (Image.open(path_or_img) if isinstance(path_or_img, str)
           else path_or_img).convert("RGB")
    crop_list = generate_crop_size_list((target_size[0] // 32) ** 2, 32)
    return var_center_crop(img, crop_list)


def image_to_array(img, normalize: str = "zero_one") -> np.ndarray:
    """PIL -> ``[1, H, W, 3]`` float32.  ``zero_one`` for Amused-VQ
    (VaeImageProcessor do_normalize=False), ``pm_one`` for MagViT-v2."""
    x = np.asarray(img, dtype=np.float32) / 255.0
    if normalize == "pm_one":
        x = x * 2.0 - 1.0
    return x[None]


def array_to_image(x: np.ndarray, from_range: str = "zero_one"):
    """``[H, W, 3]`` or ``[1, H, W, 3]`` float -> PIL."""
    from PIL import Image
    if x.ndim == 4:
        x = x[0]
    if from_range == "pm_one":
        x = (x + 1.0) / 2.0
    x = np.clip(np.nan_to_num(x), 0.0, 1.0)
    return Image.fromarray((x * 255.0).round().astype(np.uint8))


def image_transform(img, resolution: int = 256, rng=random):
    """M-variant training transform: resize shorter side + center crop +
    [-1, 1] normalize (``training/utils.py:200-207``)."""
    from PIL import Image
    w, h = img.size
    scale = resolution / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
    w, h = img.size
    left, top = (w - resolution) // 2, (h - resolution) // 2
    img = img.crop((left, top, left + resolution, top + resolution))
    return image_to_array(img, "pm_one")


def image_transform_squash(img, resolution: int = 256):
    """Aspect-squashing resize (``training/utils.py:209-213``)."""
    from PIL import Image
    img = img.resize((resolution, resolution), Image.BICUBIC)
    return image_to_array(img, "pm_one")


def painting_latent_mask(
    image_hw: Tuple[int, int],
    latent_hw: Tuple[int, int],
    mask_h_ratio: float = 1.0,
    mask_w_ratio: float = 0.2,
    mask_mode: str = "inpainting",
    dilate_latent_k: int = 0,
) -> np.ndarray:
    """Center-rectangle pixel mask -> latent-grid bool mask (True = mask).

    Area-downsampling + 0.5 threshold + optional max-pool dilation,
    mirroring ``image_utils.py:243-271``.  The caller combines this with
    encoder indices to produce MASK/code tokens (``encode_img_with_paint``).
    """
    H, W = image_hw
    lh, lw = latent_hw
    mh, mw = int(round(H * mask_h_ratio)), int(round(W * mask_w_ratio))
    top, left = (H - mh) // 2, (W - mw) // 2
    px = np.zeros((H, W), np.float32)
    px[top:top + mh, left:left + mw] = 1.0
    if mask_mode == "outpainting":
        px = 1.0 - px
    elif mask_mode != "inpainting":
        raise ValueError(mask_mode)
    # area downsample: average pool to (lh, lw)
    assert H % lh == 0 and W % lw == 0, "pixel dims must divide latent grid"
    fh, fw = H // lh, W // lw
    area = px.reshape(lh, fh, lw, fw).mean(axis=(1, 3))
    mask = area > 0.5
    if dilate_latent_k > 0:
        k = dilate_latent_k
        padded = np.pad(mask, k)
        out = np.zeros_like(mask)
        for dy in range(2 * k + 1):
            for dx in range(2 * k + 1):
                out |= padded[dy:dy + lh, dx:dx + lw]
        mask = out
    return mask


def paint_visualization(img, mask_h_ratio: float, mask_w_ratio: float,
                        mask_mode: str = "inpainting", gray: int = 127):
    """Gray-rectangle visualization (``image_utils.py:218-231``)."""
    from PIL import Image, ImageDraw
    W, H = img.size
    mh, mw = int(round(H * mask_h_ratio)), int(round(W * mask_w_ratio))
    top, left = (H - mh) // 2, (W - mw) // 2
    if mask_mode == "inpainting":
        vis = img.copy()
        ImageDraw.Draw(vis).rectangle([left, top, left + mw, top + mh],
                                      fill=(gray,) * 3)
    else:
        vis = Image.new("RGB", (W, H), (gray,) * 3)
        vis.paste(img.crop((left, top, left + mw, top + mh)), (left, top))
    return vis
