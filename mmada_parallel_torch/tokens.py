"""Token-space contracts and sequence layouts for both model variants.

The reference keeps its token-space constants scattered across entry points
(``MMaDA-Parallel-A/inference.py:22-31``, ``model/modeling_xllmx_dimoo.py:28-34``,
``MMaDA-Parallel-M/training/prompting_utils.py:17-29``).  Here they are a single
typed contract, kept as *data* so the two variants share all layout code.

Variant A ("xllmx" / Lumina-DiMOO lineage, Amused-VQ tokenizer):
    text vocab ``[0, 126356)``; VQ codes occupy ``[126356, 126356+8192)``;
    images are laid out row-major with a newline token (126084) after every
    grid row (``MMaDA-Parallel-A/utils/image_utils.py:149-157``).

Variant M (MMaDA / Show-o lineage, MagViT-v2 tokenizer):
    reserved special ids 126084-126094 (``training/prompting_utils.py:17-29``
    — note ``<|soi|>`` collides with A's newline id by lineage accident);
    VQ codes sit at ``len(text_tokenizer) + code`` with no newline structure.

Everything in this module is host-side Python/numpy: sequence assembly happens
once per request, outside the jitted hot loop.  The jit-facing outputs are
*static* index maps (`SequenceLayout`) that parameterize the fused samplers.

Counterpart of :mod:`mmada_parallel_tpu.tokens`, copied so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "VariantATokens",
    "VariantMTokens",
    "TOKENS_A",
    "TOKENS_M",
    "SequenceLayout",
    "add_break_line",
    "strip_break_line",
    "newline_mask_for_grid",
    "image_position_map",
    "calculate_vq_params",
    "build_ti2ti_layout",
    "build_interleave_layout",
    "PROMPT_TEMPLATES",
    "DENSE_MAP_DESCRIPTIONS",
    "make_ti2ti_prompt",
    "make_t2i_prompt",
    "make_edit_prompt",
    "make_mmu_prompt",
    "edit_type_prompt",
    "edit_type_system_prompt",
    "normalize_text_ids",
]


@dataclasses.dataclass(frozen=True)
class VariantATokens:
    """Special-token table for variant A.

    Values mirror ``MMaDA-Parallel-A/inference.py:22-31`` and
    ``model/modeling_xllmx_dimoo.py:28-34``.
    """

    mask: int = 126336
    newline: int = 126084
    answer_start: int = 126354
    answer_end: int = 126355
    boi: int = 126349
    eoi: int = 126350
    uncondition: int = 126351
    pad: int = 126339
    text_vocab_size: int = 126356  # VQ offset: code c -> text_vocab_size + c
    codebook_size: int = 8192

    @property
    def vq_offset(self) -> int:
        return self.text_vocab_size

    @property
    def full_vocab_size(self) -> int:
        return self.text_vocab_size + self.codebook_size


@dataclasses.dataclass(frozen=True)
class VariantMTokens:
    """Reserved special-token table for variant M.

    Values mirror ``MMaDA-Parallel-M/training/prompting_utils.py:17-29``.
    The VQ offset is ``len(text_tokenizer)`` at runtime (126464 for the
    LLaDA-8B tokenizer with its padding to a multiple of 128).
    """

    mask: int = 126336
    soi: int = 126084
    eoi: int = 126085
    sov: int = 126086
    eov: int = 126087
    t2i: int = 126088
    mmu: int = 126089
    t2v: int = 126090
    v2v: int = 126091
    lvg: int = 126092
    ipad: int = 126093
    r2i: int = 126094
    # the interleave trainer/inference extend the table in-place
    # (train_interleave.py:1-15, inference.py:13)
    interleave: int = 126095
    t2it: int = 126096   # text-only rows' task token (train_interleave.py:684)
    bos: int = 126080  # LLaDA tokenizer <s>; override from the real tokenizer
    eos: int = 126081
    text_vocab_size: int = 126464  # len(tokenizer); VQ offset
    codebook_size: int = 8192

    @property
    def vq_offset(self) -> int:
        return self.text_vocab_size

    @property
    def full_vocab_size(self) -> int:
        return self.text_vocab_size + self.codebook_size


TOKENS_A = VariantATokens()
TOKENS_M = VariantMTokens()


# ---------------------------------------------------------------------------
# 2D image-token grid layout (variant A)
# ---------------------------------------------------------------------------


def add_break_line(sequence: Sequence[int], height: int, width: int,
                   newline: int) -> List[int]:
    """Insert ``newline`` after every row of a row-major ``height*width`` grid.

    Matches ``MMaDA-Parallel-A/utils/image_utils.py:149-157`` — output length
    is ``height * (width + 1)``.
    """
    seq = list(sequence)
    if len(seq) != height * width:
        raise ValueError(
            f"sequence length {len(seq)} != height*width = {height * width}")
    out: List[int] = []
    for i in range(height):
        out.extend(seq[i * width:(i + 1) * width])
        out.append(newline)
    return out


def strip_break_line(sequence: Sequence[int], height: int, width: int) -> List[int]:
    """Inverse of :func:`add_break_line`: drop the trailing token of each row."""
    seq = list(sequence)
    if len(seq) != height * (width + 1):
        raise ValueError(
            f"sequence length {len(seq)} != height*(width+1) = {height * (width + 1)}")
    out: List[int] = []
    for i in range(height):
        row = seq[i * (width + 1):(i + 1) * (width + 1)]
        out.extend(row[:-1])
    return out


def newline_mask_for_grid(height: int, width: int) -> np.ndarray:
    """Boolean mask over a laid-out image span: True at newline positions.

    Position ``j`` in the ``height*(width+1)``-long span is a newline iff
    ``j % (width+1) == width``.
    """
    span = height * (width + 1)
    idx = np.arange(span)
    return (idx % (width + 1)) == width


def image_position_map(image_start: int, height: int, width: int) -> np.ndarray:
    """Absolute sequence positions of the ``height*width`` VQ tokens.

    Static equivalent of the reference's per-request python scan
    (``generators/parallel_generator.py:164-172``): it walks
    ``[image_start, image_end)`` collecting non-newline positions.  Because the
    grid layout is deterministic, the map is computable without looking at the
    tokens.
    """
    span_idx = np.arange(height * (width + 1))
    keep = (span_idx % (width + 1)) != width
    return image_start + span_idx[keep]


def calculate_vq_params(image_height: int, image_width: int,
                        vae_scale: int = 16) -> Tuple[int, int, int, int]:
    """``(seq_len, newline_every, grid_h, grid_w)`` for an output resolution.

    Mirrors ``MMaDA-Parallel-A/utils/image_utils.py:95-111``.
    """
    grid_h = image_height // vae_scale
    grid_w = image_width // vae_scale
    return grid_h * grid_w, grid_w, grid_h, grid_w


# ---------------------------------------------------------------------------
# Sequence layouts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SequenceLayout:
    """Static index map of one assembled generation sequence.

    All fields are python ints — they parameterize the jitted samplers as
    static arguments, so XLA compiles one program per layout bucket
    (fixing the reference's ragged-list repadding in
    ``model/modeling_xllmx_dimoo.py:53-62``).
    """

    total_len: int
    code_start: int      # index of <answer_start> (A) / output span start (M)
    image_start: int     # first token inside the image span (after <boi>/<soi>)
    image_end: int       # one past the last image-span token (before <eoi>)
    text_start: int      # first generated-text position
    text_end: int        # one past the last generated-text position
    grid_h: int = 0      # image token grid (A: with newline per row; M: flat)
    grid_w: int = 0
    has_newlines: bool = True

    @property
    def num_vq_tokens(self) -> int:
        return self.grid_h * self.grid_w

    @property
    def text_gen_length(self) -> int:
        return self.text_end - self.text_start

    def image_positions(self) -> np.ndarray:
        """Absolute positions of VQ tokens (excluding newlines)."""
        if self.has_newlines:
            return image_position_map(self.image_start, self.grid_h, self.grid_w)
        return np.arange(self.image_start, self.image_end)


def build_ti2ti_layout(
    prompt_len: int,
    text_gen_length: int,
    grid_h: int,
    grid_w: int,
    end_token_len: int = 1,
    tokens: VariantATokens = TOKENS_A,
) -> SequenceLayout:
    """Index map of the A-variant TI2TI sequence.

    Layout (``MMaDA-Parallel-A/inference.py:150-158``)::

        [prompt+input image tokens][<answer_start>][<boi>]
        [grid_h*(grid_w+1) image span with newlines][<eoi>]
        [text_gen_length MASK][</answer> tokens]

    ``prompt_len`` counts everything before ``<answer_start>`` (system/user
    prompt tokens with the input image already spliced in).
    """
    image_span = grid_h * (grid_w + 1)
    code_start = prompt_len
    image_start = prompt_len + 2          # skip <answer_start>, <boi>
    image_end = image_start + image_span
    text_start = image_end + 1            # skip <eoi>
    text_end = text_start + text_gen_length
    total = text_end + end_token_len
    del tokens
    return SequenceLayout(
        total_len=total,
        code_start=code_start,
        image_start=image_start,
        image_end=image_end,
        text_start=text_start,
        text_end=text_end,
        grid_h=grid_h,
        grid_w=grid_w,
        has_newlines=True,
    )


def assemble_ti2ti_sequence(
    cond_prompt_ids: Sequence[int],
    text_gen_length: int,
    grid_h: int,
    grid_w: int,
    end_token_ids: Sequence[int],
    image_span_tokens: Optional[Sequence[int]] = None,
    tokens: VariantATokens = TOKENS_A,
) -> Tuple[np.ndarray, SequenceLayout]:
    """Build the full TI2TI input ids + layout.

    ``image_span_tokens`` overrides the all-MASK image span for
    inpainting/outpainting (``utils/image_utils.py:175-285`` painting mode);
    it must already contain newlines.
    """
    if image_span_tokens is None:
        grid = [tokens.mask] * (grid_h * grid_w)
        image_span_tokens = add_break_line(grid, grid_h, grid_w, tokens.newline)
    image_span_tokens = list(image_span_tokens)
    if len(image_span_tokens) != grid_h * (grid_w + 1):
        raise ValueError("image span length mismatch with grid")

    ids = (list(cond_prompt_ids)
           + [tokens.answer_start, tokens.boi]
           + image_span_tokens
           + [tokens.eoi]
           + [tokens.mask] * text_gen_length
           + list(end_token_ids))
    layout = build_ti2ti_layout(
        prompt_len=len(cond_prompt_ids),
        text_gen_length=text_gen_length,
        grid_h=grid_h,
        grid_w=grid_w,
        end_token_len=len(end_token_ids),
        tokens=tokens,
    )
    assert layout.total_len == len(ids)
    return np.asarray(ids, dtype=np.int32), layout


def build_interleave_layout(
    prompt_len: int,
    num_vq_tokens: int,
    max_seq_length: int,
    tokens: VariantMTokens = TOKENS_M,
) -> SequenceLayout:
    """Index map of the M-variant interleave output template.

    Template (``MMaDA-Parallel-M/models/modeling_mmada.py:142-152``)::

        [prompt][<|soi|>][num_vq MASK][<|eoi|>][bos][max_seq_length-1 MASK]

    The "text" span in M semantics is the trailing ``max_seq_length`` tokens
    (bos + the masked text) — the reference's text update operates on
    ``combined[:, -max_seq_length:]``.
    """
    image_start = prompt_len + 1
    image_end = image_start + num_vq_tokens
    total = image_end + 1 + max_seq_length
    text_start = total - max_seq_length
    del tokens
    grid = int(round(num_vq_tokens ** 0.5))
    if grid * grid != num_vq_tokens:
        # non-square latent counts keep a consistent (1, N) "grid" — the
        # flat M layout never uses the grid except for num_vq_tokens
        grid_h, grid_w = 1, num_vq_tokens
    else:
        grid_h = grid_w = grid
    return SequenceLayout(
        total_len=total,
        code_start=prompt_len,
        image_start=image_start,
        image_end=image_end,
        text_start=text_start,
        text_end=total,
        grid_h=grid_h,
        grid_w=grid_w,
        has_newlines=False,
    )


def assemble_interleave_sequence(
    prompt_ids: Sequence[int],
    num_vq_tokens: int,
    max_seq_length: int,
    tokens: VariantMTokens = TOKENS_M,
) -> Tuple[np.ndarray, SequenceLayout]:
    """Build M-variant combined input ids + layout."""
    ids = (list(prompt_ids)
           + [tokens.soi]
           + [tokens.mask] * num_vq_tokens
           + [tokens.eoi]
           + [tokens.bos]
           + [tokens.mask] * (max_seq_length - 1))
    layout = build_interleave_layout(len(prompt_ids), num_vq_tokens,
                                     max_seq_length, tokens)
    assert layout.total_len == len(ids)
    return np.asarray(ids, dtype=np.int32), layout


# ---------------------------------------------------------------------------
# Prompt templates (variant A)
# ---------------------------------------------------------------------------

# Mirrors MMaDA-Parallel-A/utils/prompt_utils.py:7-19.
PROMPT_TEMPLATES = {
    "text_understanding": (
        "You are a multimodal model that can process both text and images. "
        "Answer the following question based on the provided images. Analyze "
        "each image and combine relevant details to answer."),
    "image_generation": "Generate an image according to the text prompt.",
    "image_editing": ("Generate an image applying the following editing "
                      "instruction based on the original image."),
    "dense_prediction": "Perform dense prediction on the given images.",
    "control_generation": ("Generate an image according to the text prompt "
                           "and the given control image."),
    "subject_generation": ("Generate an image according to the text prompt "
                           "and the given object image."),
    "multi_view": "Generate a view-image based on the given image.",
    "style_transfer": ("Transform the current image into the style of the "
                       "provided image."),
}


def make_ti2ti_prompt(prompt_text: str, system_prompt: str) -> Tuple[str, str]:
    """Conditional and unconditional TI2TI prompts.

    Mirrors ``utils/prompt_utils.py:209-232``: the CFG negative replaces the
    user slot with ``<uncondition>``.
    """
    cond = f"<system>{system_prompt}</system><user>{prompt_text}</user>"
    uncond = f"<system>{system_prompt}</system><user><uncondition></user>"
    return cond, uncond


def make_t2i_prompt(prompt_text: str) -> Tuple[str, str]:
    """Conditional/unconditional T2I prompts (``utils/prompt_utils.py:23-41``)."""
    return make_ti2ti_prompt(prompt_text, PROMPT_TEMPLATES["image_generation"])


# dense-prediction target descriptions (``utils/prompt_utils.py:145-152``)
DENSE_MAP_DESCRIPTIONS = {
    "canny": "canny edge map",
    "hed": "hed edge map",
    "normal": "normal map",
    "sam2mask": "sam2 mask",
    "depth": "depth map",
    "openpose": "pose estimation map",
}


def edit_type_prompt(edit_type: str, prompt_text) -> str:
    """Edit-type-specific user prompt (``utils/prompt_utils.py:128-178``).

    ``prompt_text`` may be a list for ``*_multiturn_<i>`` edit types — the
    reference indexes the turn out of it.
    """
    if "dense" in edit_type:
        des = DENSE_MAP_DESCRIPTIONS.get(edit_type.split("_")[0],
                                         "dense map")
        return f"Generate a {des} according to the image."
    if "edit" in edit_type:
        if "multiturn" in edit_type:
            ids = int(edit_type.split("_")[-1])
            if ids == 0:
                return (prompt_text[0] if isinstance(prompt_text, list)
                        else prompt_text)
            turn = prompt_text[ids]
            return turn[0] if isinstance(turn, list) else turn
        return prompt_text
    if "ref_transfer" in edit_type:
        return ("Transform the current image into the style of the "
                "provided image.")
    if "multi_view" in edit_type:
        return (f"Generate the {edit_type.split('_')[-1]} view based on "
                "the provided front view.")
    return prompt_text  # control / subject / unknown pass through


def edit_type_system_prompt(edit_type: str) -> str:
    """System prompt per edit type (``utils/prompt_utils.py:180-207``)."""
    for key, template in (("dense", "dense_prediction"),
                          ("control", "control_generation"),
                          ("subject", "subject_generation"),
                          ("edit", "image_editing"),
                          ("ref_transfer", "style_transfer"),
                          ("multi_view", "multi_view")):
        if key in edit_type:
            return PROMPT_TEMPLATES[template]
    return "Generate an image according to the prompt and image."


def make_edit_prompt(prompt_text, edit_type: str) -> Tuple[str, str, str]:
    """``(cond, uncond, system_prompt)`` for an edit type
    (``utils/prompt_utils.py:43-106`` ``generate_image_to_image_prompt``)."""
    system = edit_type_system_prompt(edit_type)
    cond, uncond = make_ti2ti_prompt(edit_type_prompt(edit_type, prompt_text),
                                     system)
    return cond, uncond, system


def normalize_text_ids(ids: Sequence[int], bos: int, eos: int,
                       append_eos_always: bool = True) -> List[int]:
    """bos-prefix / eos-suffix guard shared by every M text span.

    ``append_eos_always=True`` is the inference convention
    (``MMaDA-Parallel-M/inference.py:88-95`` appends eos unconditionally);
    ``False`` is the trainer convention (``train_interleave.py:735-747``
    appends only when the last token is not already eos).
    """
    ids = list(ids)
    if not ids or ids[0] != bos:
        ids = [bos] + ids
    if append_eos_always or ids[-1] != eos:
        ids = ids + [eos]
    return ids


def make_mmu_prompt(question: str) -> str:
    """MMU prompt (``utils/prompt_utils.py:108-127``)."""
    return (f"<system>{PROMPT_TEMPLATES['text_understanding']}</system>"
            f"<user>{question}</user>")
