"""ParaBench dataset adapter: the published benchmark, consumable as-is.

The paper's benchmark is an external HF dataset
(``huggingface.co/datasets/tyfeld/ParaBench``; the reference
``README.md:30-35``) — the reference repo itself ships NO loader for it
(its eval section is commented out, ``MMaDA-Parallel-A/README.md:
149-150``).  This module maps a local copy of the dataset — HF
``save_to_disk`` directory, hub parquet snapshot, or JSONL export — into
the eval harness's request objects so ``cli/eval_sweep.py --parabench
<path>`` runs the full batched sweep over it the moment a copy exists.

Schema handling: the exact column names are not verified against the
published dataset, so field roles are AUTO-DETECTED from documented candidate
lists (first match wins, see ``FIELD_CANDIDATES``) and every role can be
pinned explicitly (``--pb_fields instruction=edit_prompt,image=src``).
The committed miniature fixture (``tests/fixtures/parabench_mini.
parquet``, written with the HF ``datasets`` Image feature) keeps the
whole path executable and regression-tested offline.

Counterpart of :mod:`mmada_parallel_tpu.data.parabench`, copied so that the
port imports nothing of the JAX package.  ``datasets`` (HF dirs and parquet)
and PIL (image columns) are imported only where a row needs them, so a jsonl
export of text-only rows loads with neither.
"""

from __future__ import annotations

import base64
import glob
import io
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["FIELD_CANDIDATES", "load_parabench", "detect_fields",
           "parabench_requests"]

# role -> candidate column names, in detection order.  Pin any role
# explicitly via field_map when the real dataset differs.
FIELD_CANDIDATES: Dict[str, Sequence[str]] = {
    "instruction": ("instruction", "edit_instruction", "prompt", "text",
                    "caption", "question"),
    "image": ("input_image", "image", "source_image", "input_img", "img"),
    "type": ("task_type", "task", "type", "category", "edit_type"),
    "id": ("id", "idx", "index", "uid", "key", "name"),
    "target_text": ("output_text", "target_text", "thinking", "answer",
                    "response"),
    "target_image": ("output_image", "target_image", "edited_image",
                     "gt_image"),
}


def _rows_from_hf(ds) -> List[Dict[str, Any]]:
    return [dict(r) for r in ds]


def load_parabench(path: str) -> List[Dict[str, Any]]:
    """Rows (list of dicts) from any local form of the dataset.

    * HF ``save_to_disk`` dir (``state.json``/``dataset_info.json``) —
      via ``datasets.load_from_disk`` (Image columns arrive as PIL);
    * a parquet file, or a dir containing parquet shard(s) (the hub
      snapshot layout) — via ``datasets``' parquet reader;
    * ``.jsonl``/``.json`` export — image fields may be file paths
      (relative to the file), base64 strings, or ``{"bytes": ...,
      "path": ...}`` dicts.
    """
    if os.path.isdir(path):
        if (os.path.exists(os.path.join(path, "state.json"))
                or os.path.exists(os.path.join(path, "dataset_info.json"))):
            import datasets
            return _rows_from_hf(datasets.load_from_disk(path))
        shards = sorted(glob.glob(os.path.join(path, "**", "*.parquet"),
                                  recursive=True))
        if shards:
            import datasets
            ds = datasets.load_dataset("parquet", data_files=shards,
                                       split="train")
            return _rows_from_hf(ds)
        jsonls = sorted(glob.glob(os.path.join(path, "*.jsonl")))
        if jsonls:
            return [r for p in jsonls for r in _load_jsonl(p)]
        raise FileNotFoundError(
            f"{path}: no HF dataset dir, parquet shards or jsonl found")
    if path.endswith(".parquet"):
        import datasets
        return _rows_from_hf(datasets.load_dataset(
            "parquet", data_files=path, split="train"))
    if path.endswith((".jsonl", ".json")):
        return _load_jsonl(path)
    raise ValueError(f"unrecognized ParaBench path: {path}")


def _load_jsonl(path: str) -> List[Dict[str, Any]]:
    base = os.path.dirname(os.path.abspath(path))
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                r = json.loads(line)
                r["_base_dir"] = base
                rows.append(r)
    return rows


def detect_fields(row: Dict[str, Any],
                  field_map: Optional[Dict[str, str]] = None
                  ) -> Dict[str, Optional[str]]:
    """Resolve role -> column name for one schema; explicit ``field_map``
    entries win, then the first present candidate, else None."""
    out: Dict[str, Optional[str]] = {}
    fm = field_map or {}
    for role, cands in FIELD_CANDIDATES.items():
        if role in fm:
            if fm[role] and fm[role] not in row:
                raise KeyError(
                    f"--pb_fields {role}={fm[role]!r}: column not in the "
                    f"dataset (columns: {sorted(row)})")
            out[role] = fm[role] or None
            continue
        out[role] = next((c for c in cands if c in row), None)
    if out["instruction"] is None:
        raise KeyError(
            "could not detect the instruction column (tried "
            f"{FIELD_CANDIDATES['instruction']}); pin it with "
            "--pb_fields instruction=<name>")
    return out


def as_pil(val: Any, base_dir: Optional[str] = None):
    """Decode any of the dataset image encodings to a PIL image."""
    if val is None:
        return None
    from PIL import Image
    if isinstance(val, Image.Image):
        return val.convert("RGB")
    if isinstance(val, dict):           # HF Image feature as plain dict
        if val.get("bytes"):
            raw = val["bytes"]
            if isinstance(raw, str):
                raw = base64.b64decode(raw)
            return Image.open(io.BytesIO(raw)).convert("RGB")
        val = val.get("path")
    if isinstance(val, bytes):
        return Image.open(io.BytesIO(val)).convert("RGB")
    if isinstance(val, str):
        p = val
        if not os.path.isabs(p) and base_dir:
            p = os.path.join(base_dir, p)
        if os.path.exists(p):
            return Image.open(p).convert("RGB")
        return Image.open(io.BytesIO(base64.b64decode(val))).convert("RGB")
    raise TypeError(f"cannot decode image field of type {type(val)!r}")


def parabench_requests(
        rows: List[Dict[str, Any]],
        task: str,
        tokenize: Callable[[str], List[int]],
        encode_image: Optional[Callable] = None,
        field_map: Optional[Dict[str, str]] = None,
        system_prompt: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """Rows -> eval_sweep request dicts (the CLI's JSONL schema), so the
    adapter slots in front of the existing request pipeline unchanged.

    ``encode_image`` contract by task (both return RAW VQ codes,
    pre-offset): ``edit`` -> ``(span_ids, raw_codes)`` — the
    newline-structured boi/eoi span (``pipeline.TI2TIPipeline.
    encode_img_with_breaks``) plus flat codes; ``interleave``/``t2i``/
    ``mmu`` -> ``raw_codes``.  Rows with images require it; text-only
    rows don't.  ``meta`` carries id/type/instruction plus
    ``input_codes``/``target_codes``/``keywords`` so the default scorer's
    consistency/target/locality axes light up where the dataset provides
    the material.
    """
    if not rows:
        raise ValueError("empty ParaBench rows")
    # detect over the UNION of the first rows' columns: JSONL exports
    # often omit null fields per-row, so row 0 alone can silently
    # disable the image/type/target roles for the whole dataset
    probe: Dict[str, Any] = {}
    for r in rows[:64]:
        for k, v in r.items():
            probe.setdefault(k, v)
    fields = detect_fields(probe, field_map)
    out = []
    for i, row in enumerate(rows):
        base = row.get("_base_dir")
        if fields["instruction"] not in row:
            # heterogeneous exports: fail with the curated guidance, not
            # a bare KeyError (detection only sees row 0)
            raise ValueError(
                f"row {i} lacks the detected instruction column "
                f"{fields['instruction']!r} (columns: "
                f"{sorted(k for k in row if not k.startswith('_'))}); "
                "map columns explicitly with --pb_fields")
        instr = str(row[fields["instruction"]])
        meta: Dict[str, Any] = {"instruction": instr}
        if fields["id"] and row.get(fields["id"]) is not None:
            meta["id"] = row[fields["id"]]
        if fields["type"] and row.get(fields["type"]) is not None:
            meta["task_type"] = row[fields["type"]]
        tgt_txt = row.get(fields["target_text"]) if fields["target_text"] \
            else None
        if tgt_txt:
            # keyword axis: content words of the reference text
            meta["keywords"] = [w for w in str(tgt_txt).split()
                                if len(w) > 3][:16]
        img = as_pil(row.get(fields["image"]), base) if fields["image"] \
            else None
        tgt_img = as_pil(row.get(fields["target_image"]), base) \
            if fields["target_image"] else None
        if (img is not None or tgt_img is not None) and encode_image is None:
            raise ValueError(
                "dataset rows carry images; pass encode_image (the CLI "
                "derives it from --vq_checkpoint)")

        if task == "edit":
            from mmada_parallel_torch import tokens as tk
            from mmada_parallel_torch.pipeline import SYSTEM_PROMPT_EDIT
            cond_txt, _ = tk.make_ti2ti_prompt(
                instr, system_prompt or SYSTEM_PROMPT_EDIT)
            prompt_ids = list(tokenize(cond_txt))
            if img is not None:
                span, raw = encode_image(img)
                prompt_ids = (prompt_ids[:-1] + list(span)
                              + prompt_ids[-1:])
                meta["input_codes"] = [int(c) for c in raw]
            if tgt_img is not None:
                _, raw_t = encode_image(tgt_img)
                meta["target_codes"] = [int(c) for c in raw_t]
            out.append({"prompt_ids": prompt_ids, "meta": meta})
        elif task == "interleave":
            req: Dict[str, Any] = {"instr_ids": list(tokenize(instr)),
                                   "meta": meta}
            if img is None:
                # fail HERE with guidance, not minutes later inside
                # InterleaveServer.submit ("pass exactly one of codes=
                # or image=") after checkpoint load + compiles
                raise ValueError(
                    f"row {i} ({meta.get('id', '?')}) has no input "
                    "image but interleave generation requires one — "
                    "filter the dataset or run --task t2i for "
                    "text-only rows")
            raw = encode_image(img)
            req["codes"] = [int(c) for c in raw]
            meta["input_codes"] = req["codes"]
            if tgt_img is not None:
                meta["target_codes"] = [int(c) for c in
                                        encode_image(tgt_img)]
            out.append(req)
        elif task == "t2i":
            if tgt_img is not None:
                meta["target_codes"] = [int(c) for c in
                                        encode_image(tgt_img)]
            out.append({"text_ids": list(tokenize(instr)), "meta": meta})
        elif task == "mmu":
            from mmada_parallel_torch import tokens as tk
            T = tk.TOKENS_M
            # bos/eos-normalize the question span like the serve CLI's
            # /mmu path (serve.py) — MMUServer.submit passes prompt_ids
            # through untouched, and un-guarded spans are silently
            # non-parity (CLAUDE.md invariant)
            ids = tk.normalize_text_ids(
                list(tokenize(tk.make_mmu_prompt(instr))), T.bos, T.eos,
                append_eos_always=False)
            if img is not None:
                raw = encode_image(img)
                ids = ([T.mmu, T.soi]
                       + [int(c) + T.vq_offset for c in raw]
                       + [T.eoi] + ids)
            out.append({"prompt_ids": ids, "meta": meta})
        else:
            raise ValueError(f"unknown task {task!r}")
    return out
