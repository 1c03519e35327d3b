"""High-level pipelines, the port of :mod:`mmada_parallel_tpu.pipeline`:

* ``TI2TIPipeline`` (variant A): prompt + image -> (edited image, thinking
  text);
* ``InterleavePipeline`` (variant M): instruction + image -> (image, text)
  through the interleave samplers.

Same constructors and ``__call__`` arguments.  The input image may be a PIL
image or a uint8 ``[H, W, 3]`` array (the pixels ``np.asarray(pil_image)``
gives), and for ``TI2TIPipeline`` also a path.  An array input that needs
no resize never touches PIL: the first return value is then ``None``, and
for any input the decoded pixels are in ``info["pixels"]`` (``[H, W, 3]``
float in [0, 1]).  Every tokenizer encode and decode runs in f32 with
cuDNN's TF32 off (``vq_precision``), whatever the caller set.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mmada_parallel_torch import tokens as tk
from mmada_parallel_torch.models import amused_vq as AVQ
from mmada_parallel_torch.models import magvit2 as MVQ
from mmada_parallel_torch.models.llada import LLaDAConfig
from mmada_parallel_torch.models.vqgan_common import vq_precision
from mmada_parallel_torch.samplers.interleave import (
    InterleaveOptions, interleave_generate, interleave_generate_cached)
from mmada_parallel_torch.samplers.parallel_ti2ti import (
    TI2TIOptions, decode_text, generate_ti2ti, generate_ti2ti_cached)
from mmada_parallel_torch.utils.spans import span

__all__ = ["TI2TIPipeline", "InterleavePipeline"]

SYSTEM_PROMPT_EDIT = ("Generate an image applying the following editing "
                      "instruction based on the original image.")


def _pixels01(image) -> np.ndarray:
    """``[1, H, W, 3]`` float32 in [0, 1] from a uint8 ``[H, W, 3]`` array
    or a PIL image."""
    if isinstance(image, np.ndarray):
        return image.astype(np.float32)[None] / 255.0
    from mmada_parallel_torch.utils.image import image_to_array
    return image_to_array(image, "zero_one")


@dataclasses.dataclass
class TI2TIPipeline:
    llada_cfg: LLaDAConfig
    llada_params: Any
    vq_cfg: AVQ.AmusedVQConfig
    vq_params: Any
    tokenizer: Any
    tokens: tk.VariantATokens = tk.TOKENS_A

    @property
    def device(self) -> torch.device:
        return self.llada_params["wte"].device

    @torch.inference_mode()
    @vq_precision()
    def _encode(self, px: np.ndarray) -> np.ndarray:
        """``[1, H, W, 3]`` float pixels in [0, 1] -> ``[1, h*w]`` codes."""
        x = torch.as_tensor(px, dtype=torch.float32,
                            device=self.vq_params["quant"]["embedding"].device)
        lat = AVQ.amused_encode(self.vq_params, self.vq_cfg, x)
        return AVQ.amused_quantize(self.vq_params, self.vq_cfg,
                                   lat)[1].cpu().numpy()

    # -- tokenize an image with newline structure
    def encode_img_with_breaks(self, img) -> list:
        return AVQ.amused_img_span(self._encode, self.vq_cfg, _pixels01(img),
                                   self.tokens)

    def encode_img_with_paint(self, img, mask_h_ratio: float,
                              mask_w_ratio: float,
                              mask_mode: str = "inpainting") -> list:
        """Painting-mode span (no boi/eoi)."""
        from mmada_parallel_torch.utils import image as IM
        px = _pixels01(img)
        H, W = px.shape[1], px.shape[2]
        codes = self._encode(px)[0]
        h, w = H // self.vq_cfg.scale, W // self.vq_cfg.scale
        m = IM.painting_latent_mask((H, W), (h, w), mask_h_ratio,
                                    mask_w_ratio, mask_mode)
        T = self.tokens
        toks = [T.mask if m.reshape(-1)[i] else int(codes[i]) + T.vq_offset
                for i in range(h * w)]
        return tk.add_break_line(toks, h, w, T.newline)

    @torch.inference_mode()
    @vq_precision()
    def decode_vq_to_pixels(self, codes, height: int,
                            width: int) -> np.ndarray:
        """Codes ``[1, N]`` -> pixels ``[H, W, 3]`` float in [0, 1]."""
        gh, gw = height // self.vq_cfg.scale, width // self.vq_cfg.scale
        c = torch.tensor(np.asarray(codes), device=self.vq_params["quant"][
            "embedding"].device)
        px = AVQ.amused_decode_code(self.vq_params, self.vq_cfg, c, (gh, gw))
        return px[0].float().cpu().numpy()

    def __call__(self, prompt: str, image, height: int = 512,
                 width: int = 512, opts: TI2TIOptions = TI2TIOptions(),
                 text_gen_length: int = 256,
                 system_prompt: str = SYSTEM_PROMPT_EDIT,
                 seed: int = 0, painting_mode: Optional[str] = None,
                 mask_h_ratio: float = 0.5, mask_w_ratio: float = 0.5,
                 use_cache: bool = False,
                 ) -> Tuple[Any, Any, Dict]:
        """Run one edit; returns ``(pil_image, thinking_text, info)`` with
        ``info`` holding ``elapsed``, ``layout``, ``codes``, the final
        ``ids`` and the decoded ``pixels``; the image is ``None`` for an
        array input.  ``use_cache=True`` samples through the opt-in
        :func:`generate_ti2ti_cached` approximation."""
        T = self.tokens
        with span("edit"):
            with span("edit.encode"):
                cond_txt, uncond_txt = tk.make_ti2ti_prompt(prompt,
                                                            system_prompt)
                prompt_ids = self.tokenizer(cond_txt)["input_ids"]
                uncond_ids = self.tokenizer(uncond_txt)["input_ids"]

                if isinstance(image, str):
                    from mmada_parallel_torch.utils import image as IM
                    image = IM.preprocess_image(image)
                input_img_token = self.encode_img_with_breaks(image)
                con_input = (prompt_ids[:-1] + input_img_token
                             + prompt_ids[-1:])
                uncon_text = np.asarray(
                    uncond_ids[:-1] + input_img_token + uncond_ids[-1:],
                    np.int64)
                uncon_image = np.asarray(prompt_ids, np.int64)

                _, _, gh, gw = tk.calculate_vq_params(height, width,
                                                      self.vq_cfg.scale)
                end_ids = self.tokenizer(
                    "</answer>", add_special_tokens=False)["input_ids"]
                span_ids = None
                if painting_mode:
                    span_ids = self.encode_img_with_paint(
                        image, mask_h_ratio, mask_w_ratio, painting_mode)
                ids, layout = tk.assemble_ti2ti_sequence(
                    con_input, text_gen_length, gh, gw, end_ids,
                    image_span_tokens=span_ids, tokens=T)

            # seed=0 draws an OS-random seed (the reference's unseeded
            # runs); temperature-0 runs are deterministic regardless
            dev = self.device
            gen = torch.Generator(device=dev).manual_seed(
                seed if seed else int(np.random.randint(1, 2 ** 31)))
            sampler = generate_ti2ti_cached if use_cache else generate_ti2ti
            t0 = time.time()
            with span("edit.sample"):
                fin, codes = sampler(
                    self.llada_params, self.llada_cfg,
                    torch.as_tensor(ids, device=dev)[None], layout, opts,
                    uncond_text_prefix=uncon_text if opts.cfg_scale else None,
                    uncond_image_prefix=(uncon_image if opts.cfg_img
                                         else None),
                    generator=gen)
                codes = codes.cpu().numpy()
            elapsed = time.time() - t0

            with span("edit.decode"):
                text = decode_text(fin, layout, opts, self.tokenizer)
                pixels = self.decode_vq_to_pixels(codes, height, width)
                out_img = None
                if not isinstance(image, np.ndarray):
                    from mmada_parallel_torch.utils import image as IM
                    out_img = IM.array_to_image(pixels)
                ids = fin.cpu().numpy()
        return out_img, text, {"elapsed": elapsed, "layout": layout,
                               "codes": codes, "ids": ids,
                               "pixels": pixels}


def _pixels_pm_one(image, resolution: int) -> np.ndarray:
    """``[1, R, R, 3]`` float32 in [-1, 1]: the M transform (aspect-squashing
    bicubic resize to ``resolution``).  A uint8 array already at that size
    needs no resize and never touches PIL (a same-size PIL resize is a
    copy); anything else goes through ``image_transform_squash``."""
    if isinstance(image, np.ndarray) and image.shape[:2] == (resolution,
                                                             resolution):
        return image.astype(np.float32)[None] / 255.0 * 2.0 - 1.0
    from mmada_parallel_torch.utils import image as IM
    if isinstance(image, np.ndarray):
        from PIL import Image
        image = Image.fromarray(image)
    return IM.image_transform_squash(image, resolution)


@dataclasses.dataclass
class InterleavePipeline:
    llada_cfg: LLaDAConfig
    llada_params: Any
    vq_cfg: MVQ.MagvitConfig
    vq_params: Any
    tokenizer: Any
    tokens: tk.VariantMTokens = tk.TOKENS_M
    num_vq_tokens: int = 1024
    max_seq_length: int = 256
    resolution: int = 512

    @property
    def device(self) -> torch.device:
        return self.llada_params["wte"].device

    @property
    def _vq_device(self) -> torch.device:
        return self.vq_params["encoder"]["conv_in"]["w"].device

    @torch.inference_mode()
    @vq_precision()
    def get_code(self, px) -> torch.Tensor:
        """MagViT codes ``[B, N]`` of pixels ``[B, R, R, 3]`` in [-1, 1]
        (an array or a tensor), on the tokenizer's device."""
        px = torch.as_tensor(px, dtype=torch.float32, device=self._vq_device)
        return MVQ.magvit_get_code(self.vq_params, self.vq_cfg, px)

    def build_sequences(self, instruction: str, image):
        """``(ids, un_ids, layout)``: the reference inference template --
        bos/eos-normalised text, the uncond image span zeroed after the
        vocab offset (literal token id 0), both padded with eos on the right
        to one length."""
        T = self.tokens
        codes = self.get_code(_pixels_pm_one(
            image, self.resolution))[0].cpu().numpy() + T.vq_offset

        bos = getattr(self.tokenizer, "bos_token_id", None)
        eos = getattr(self.tokenizer, "eos_token_id", None)
        bos = T.bos if bos is None else int(bos)
        eos = T.eos if eos is None else int(eos)
        instr_ids = tk.normalize_text_ids(
            self.tokenizer(instruction)["input_ids"], bos, eos)
        uncond_ids = tk.normalize_text_ids(
            self.tokenizer("")["input_ids"], bos, eos)
        prompt = ([T.interleave, T.soi] + [int(c) for c in codes] + [T.eoi]
                  + instr_ids)
        un_prompt = ([T.interleave, T.soi] + [0] * len(codes) + [T.eoi]
                     + uncond_ids)
        L = max(len(prompt), len(un_prompt))
        prompt += [eos] * (L - len(prompt))
        un_prompt += [eos] * (L - len(un_prompt))

        ids, layout = tk.assemble_interleave_sequence(
            prompt, self.num_vq_tokens, self.max_seq_length, T)
        un_ids, _ = tk.assemble_interleave_sequence(
            un_prompt, self.num_vq_tokens, self.max_seq_length, T)
        return ids, un_ids, layout

    @torch.inference_mode()
    @vq_precision()
    def decode_codes_to_pixels(self, codes) -> np.ndarray:
        """Codes ``[1, N]`` -> pixels ``[H, W, 3]`` float in [0, 1]."""
        c = torch.as_tensor(np.asarray(codes), device=self._vq_device)
        px = MVQ.magvit_decode_code(self.vq_params, self.vq_cfg, c)
        return ((px[0].float() + 1.0) / 2.0).clamp(0.0, 1.0).cpu().numpy()

    def __call__(self, instruction: str, image,
                 opts: InterleaveOptions = InterleaveOptions(),
                 seed: int = 0, use_cache: bool = False,
                 cache_kw: Optional[Dict] = None) -> Tuple[Any, Any, Dict]:
        """Run one interleave generation; returns ``(pil_image, text,
        info)`` with ``info`` holding ``elapsed``, ``layout``, ``codes``,
        the final ``ids`` and the decoded ``pixels``; the image is ``None``
        for an array input.  ``use_cache=True`` samples through the opt-in
        :func:`interleave_generate_cached` approximation (``cache_kw``
        passes ``cache_ratio``/``refresh_interval``/``warmup_ratio``/
        ``refresh_on_image_steps``); the default is the exact path."""
        with span("edit"):
            with span("edit.encode"):
                ids, un_ids, layout = self.build_sequences(instruction,
                                                           image)
            dev = self.device
            # seed=0 draws an OS-random seed (the reference's unseeded
            # runs); temperature-0 runs are deterministic regardless
            gen = torch.Generator(device=dev).manual_seed(
                seed if seed else int(np.random.randint(1, 2 ** 31)))
            args = (self.llada_params, self.llada_cfg,
                    torch.as_tensor(ids, device=dev)[None],
                    torch.as_tensor(un_ids, device=dev)[None], layout, opts)
            t0 = time.time()
            with span("edit.sample"):
                if use_cache:
                    fin, codes = interleave_generate_cached(
                        *args, generator=gen, **(cache_kw or {}))
                else:
                    fin, codes = interleave_generate(*args, generator=gen)
                codes = codes.cpu().numpy()
            elapsed = time.time() - t0

            with span("edit.decode"):
                fin = fin.cpu().numpy()
                text_ids = [int(t) for t in fin[0][layout.text_start:]
                            if int(t) != self.tokens.mask]
                text = (self.tokenizer.decode(text_ids,
                                              skip_special_tokens=True)
                        if hasattr(self.tokenizer, "decode") else text_ids)
                pixels = self.decode_codes_to_pixels(codes)
                out_img = None
                if not isinstance(image, np.ndarray):
                    from mmada_parallel_torch.utils import image as IM
                    out_img = IM.array_to_image(pixels)
        return out_img, text, {"elapsed": elapsed, "layout": layout,
                               "codes": codes, "ids": fin,
                               "pixels": pixels}
