"""Local, dependency-free default scorers for the ParaBench-style sweep.

The reference repo has no runnable eval (its README eval section is
commented out, ``MMaDA-Parallel-A/README.md:149-150``; ParaBench's
official quality judges are external GPT-based services).  These scorers
give :func:`mmada_parallel_torch.evaluation.run_parabench_sweep` a
DEFAULT that produces numbers end-to-end with no external dependencies,
mirroring ParaBench's axes with local proxies:

* **consistency** (ParaBench "consistency"): fraction of generated VQ
  codes equal to the INPUT image's codes — how much of the source image
  survives the edit (``meta["input_codes"]``).
* **target_match** (ParaBench "alignment", when ground truth exists):
  fraction of generated codes equal to the reference EDITED image's
  codes (``meta["target_codes"]``) — the same token-level alignment
  proxy ParaRL climbs (``training/pararl.make_target_match_reward``).
* **text_alignment**: fraction of required keywords present in the
  generated thinking text (``meta["keywords"]``, strings).
* **code_diversity**: distinct-codebook-entry fraction — catches the
  collapsed-image failure mode (``training/pararl.code_diversity_reward``
  semantics, host-side).
* **edit locality** (when ``meta["edit_mask"]`` marks the region the
  instruction should change): ``region_change`` = fraction of in-region
  codes that differ from the input, ``offregion_survival`` = fraction of
  out-of-region codes preserved — ParaBench's "did it edit the right
  thing and nothing else" axis as a token-level proxy.
* **pixel metrics** (:func:`pixel_edit_scorer`, opt-in with a decoder):
  PSNR + SSIM between the decoded output and the decoded input
  (``pixel_consistency_*``) / decoded ground-truth edit
  (``pixel_target_*``) — numpy-only implementations, no skimage.

These are proxies, not the paper's semantic judges: they rank
checkpoints and catch regressions locally; absolute values are not
comparable to published ParaBench scores.

Counterpart of :mod:`mmada_parallel_tpu.eval_scorers` (numpy only), copied
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

__all__ = ["default_edit_scorer", "pixel_edit_scorer", "aggregate_scores",
           "psnr", "ssim"]

#: identical images would give PSNR = inf; cap so means stay finite.
PSNR_CAP_DB = 100.0


def psnr(a, b, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB, capped at :data:`PSNR_CAP_DB`."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse <= 0.0:
        return PSNR_CAP_DB
    return float(min(10.0 * np.log10(data_range ** 2 / mse), PSNR_CAP_DB))


def _box_mean(x: np.ndarray, w: int) -> np.ndarray:
    """Valid-mode ``w``x``w`` box mean over the two leading axes."""
    c = np.cumsum(np.cumsum(x, axis=0), axis=1)
    pad = [(1, 0), (1, 0)] + [(0, 0)] * (x.ndim - 2)
    c = np.pad(c, pad)
    s = c[w:, w:] - c[:-w, w:] - c[w:, :-w] + c[:-w, :-w]
    return s / (w * w)


def ssim(a, b, data_range: float = 1.0, win: int = 7) -> float:
    """Structural similarity (uniform ``win``x``win`` window, channel-mean).

    Standard SSIM constants (K1=0.01, K2=0.03); inputs ``[H, W]`` or
    ``[H, W, C]``; the window clamps to the image size so tiny eval grids
    (e.g. the 4x4 demo palette) still score.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    w = max(min(win, a.shape[0], a.shape[1]), 1)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = _box_mean(a, w), _box_mean(b, w)
    var_a = _box_mean(a * a, w) - mu_a ** 2
    var_b = _box_mean(b * b, w) - mu_b ** 2
    cov = _box_mean(a * b, w) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))


def default_edit_scorer() -> Callable:
    """``scorer(request, text, codes) -> dict`` for
    :func:`evaluation.run_parabench_sweep`.  Reads optional
    ``request.meta`` fields: ``input_codes`` ``[N_vq]``,
    ``target_codes`` ``[N_vq]``, ``keywords`` (list of strings)."""

    def scorer(request, text: Optional[str], codes) -> Dict[str, Any]:
        meta = request.meta or {}
        # codes is None for text-only sweeps (run_mmu_sweep) — skip the
        # code axes so one default scorer serves every sweep flavor
        codes = None if codes is None else np.asarray(codes).reshape(-1)
        out: Dict[str, Any] = {}
        if codes is not None and meta.get("input_codes") is not None:
            inp = np.asarray(meta["input_codes"]).reshape(-1)
            out["consistency"] = float((codes == inp).mean())
        if codes is not None and meta.get("target_codes") is not None:
            tgt = np.asarray(meta["target_codes"]).reshape(-1)
            out["target_match"] = float((codes == tgt).mean())
        if (codes is not None and meta.get("edit_mask") is not None
                and meta.get("input_codes") is not None):
            m = np.asarray(meta["edit_mask"], dtype=bool).reshape(-1)
            inp = np.asarray(meta["input_codes"]).reshape(-1)
            changed = codes != inp
            if m.any():
                out["region_change"] = float(changed[m].mean())
            if (~m).any():
                out["offregion_survival"] = float((~changed)[~m].mean())
        kws: Sequence[str] = meta.get("keywords") or ()
        if kws and isinstance(text, str):
            low = text.lower()
            out["text_alignment"] = float(
                np.mean([kw.lower() in low for kw in kws]))
        if codes is not None:
            out["code_diversity"] = float(
                len(np.unique(codes)) / max(codes.size, 1))
        out["text_len"] = len(text) if isinstance(text, str) else 0
        return out

    return scorer


def pixel_edit_scorer(decode_fn: Callable, base: Optional[Callable] = None,
                      data_range: float = 1.0) -> Callable:
    """Adds decoded-pixel PSNR/SSIM axes on top of ``base`` (defaults to
    :func:`default_edit_scorer`).

    ``decode_fn(codes_flat_int) -> float image [H, W(, C)]`` — e.g. the
    Amused-VQ/MagViT decoder at production scale, or the palette decode in
    the demo.  Scores ``pixel_consistency_{psnr,ssim}`` against the decoded
    ``meta["input_codes"]`` and ``pixel_target_{psnr,ssim}`` against the
    decoded ``meta["target_codes"]``.
    """
    base = base or default_edit_scorer()

    def scorer(request, text: Optional[str], codes) -> Dict[str, Any]:
        out = base(request, text, codes)
        if codes is None:        # text-only sweep (mmu) — no pixel axes
            return out
        meta = request.meta or {}
        img = np.asarray(decode_fn(np.asarray(codes).reshape(-1)))
        if meta.get("input_codes") is not None:
            ref = np.asarray(decode_fn(
                np.asarray(meta["input_codes"]).reshape(-1)))
            out["pixel_consistency_psnr"] = psnr(img, ref, data_range)
            out["pixel_consistency_ssim"] = ssim(img, ref, data_range)
        if meta.get("target_codes") is not None:
            ref = np.asarray(decode_fn(
                np.asarray(meta["target_codes"]).reshape(-1)))
            out["pixel_target_psnr"] = psnr(img, ref, data_range)
            out["pixel_target_ssim"] = ssim(img, ref, data_range)
        return out

    return scorer


def aggregate_scores(results) -> Dict[str, float]:
    """Mean of every numeric score key over a sweep's ``results`` list
    (entries without a key are simply not counted for it)."""
    sums: Dict[str, list] = {}
    for r in results:
        for k, v in (r.get("scores") or {}).items():
            if isinstance(v, (int, float)):
                sums.setdefault(k, []).append(float(v))
    return {k: float(np.mean(v)) for k, v in sorted(sums.items())}
