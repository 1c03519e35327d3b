"""The port's copies of the JAX package's framework-free host modules
(``tokens``, ``utils/image``, ``config``, ``utils/logging``, the A
trainer's ``data``, ``eval_scorers`` and ``data/parabench``) give what their
originals give on the same inputs.

The port imports nothing of ``mmada_parallel_tpu``; these tests may, to hold
each copy against the module it was copied from."""

import dataclasses
import json
import os
import pickle
import random

import numpy as np
import pytest
from PIL import Image

from mmada_parallel_torch import config as PC
from mmada_parallel_torch import tokens as PT
from mmada_parallel_torch.data import dataset as PD
from mmada_parallel_torch.data import item_processor as PIP
from mmada_parallel_torch.utils import image as PIM
from mmada_parallel_torch.utils import logging as PL
from mmada_parallel_tpu import config as JC
from mmada_parallel_tpu import tokens as JT
from mmada_parallel_tpu.data import dataset as JD
from mmada_parallel_tpu.data import item_processor as JIP
from mmada_parallel_tpu.utils import image as JIM
from mmada_parallel_tpu.utils import logging as JL


@pytest.mark.parametrize("name", ["TOKENS_A", "TOKENS_M"])
def test_token_constants(name):
    port, ref = getattr(PT, name), getattr(JT, name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.vq_offset == ref.vq_offset
    assert port.full_vocab_size == ref.full_vocab_size


def test_variant_m_tokens_with_overrides():
    kw = dict(mask=250, soi=251, eoi=252, bos=249, eos=248, interleave=247,
              text_vocab_size=256, codebook_size=16)
    port, ref = PT.VariantMTokens(**kw), JT.VariantMTokens(**kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.vq_offset, port.full_vocab_size) == (ref.vq_offset,
                                                      ref.full_vocab_size)


@pytest.mark.parametrize("grid,text_len,end", [((32, 32), 256, [126081]),
                                               ((16, 24), 8, [7, 8, 9]),
                                               ((3, 5), 0, [1])])
def test_assemble_ti2ti_sequence(grid, text_len, end):
    rng = np.random.default_rng(grid[0] * 100 + text_len)
    prompt = rng.integers(0, 126000, size=57).tolist()
    ids_p, lay_p = PT.assemble_ti2ti_sequence(prompt, text_len, *grid, end)
    ids_j, lay_j = JT.assemble_ti2ti_sequence(prompt, text_len, *grid, end)
    np.testing.assert_array_equal(ids_p, ids_j)
    assert dataclasses.asdict(lay_p) == dataclasses.asdict(lay_j)
    np.testing.assert_array_equal(lay_p.image_positions(),
                                  lay_j.image_positions())


@pytest.mark.parametrize("num_vq,max_seq", [(1024, 256), (64, 6), (12, 3)])
def test_assemble_interleave_sequence(num_vq, max_seq):
    rng = np.random.default_rng(num_vq)
    prompt = rng.integers(0, 126000, size=51).tolist()
    ids_p, lay_p = PT.assemble_interleave_sequence(prompt, num_vq, max_seq)
    ids_j, lay_j = JT.assemble_interleave_sequence(prompt, num_vq, max_seq)
    np.testing.assert_array_equal(ids_p, ids_j)
    assert dataclasses.asdict(lay_p) == dataclasses.asdict(lay_j)
    np.testing.assert_array_equal(lay_p.image_positions(),
                                  lay_j.image_positions())


def test_prompts_and_text_ids():
    for fn, args in (("make_ti2ti_prompt", ("add a hat", "sys")),
                     ("edit_type_prompt", ("style", "add a hat")),
                     ("edit_type_system_prompt", ("style",)),
                     ("make_mmu_prompt", ("what is this?",))):
        assert getattr(PT, fn)(*args) == getattr(JT, fn)(*args)
    ids = [5, 1, 7, 9, 2, 2]
    assert list(PT.normalize_text_ids(ids, 1, 2)) == \
        list(JT.normalize_text_ids(ids, 1, 2))


def _seeded_image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("hw,target", [((600, 800), 512), ((512, 512), 512),
                                       ((300, 200), 256)])
def test_preprocess_image_and_image_to_array(hw, target):
    img = _seeded_image(*hw)
    out = []
    for mod in (PIM, JIM):
        random.seed(1)                  # center_crop draws its offset
        crop = mod.preprocess_image(img, (target, target))
        out.append((crop.size, mod.image_to_array(crop),
                    mod.image_to_array(crop, "pm_one"),
                    mod.image_transform_squash(img, 64)))
    (sp, ap, pp, qp), (sj, aj, pj, qj) = out
    assert sp == sj
    for a, b in ((ap, aj), (pp, pj), (qp, qj)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_array_to_image_and_painting_mask():
    x = np.random.default_rng(2).random((1, 16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(PIM.array_to_image(x)),
                                  np.asarray(JIM.array_to_image(x)))
    for mode in ("inpainting", "outpainting"):
        np.testing.assert_array_equal(
            PIM.painting_latent_mask((64, 64), (8, 8), 0.5, 0.3, mode, 1),
            JIM.painting_latent_mask((64, 64), (8, 8), 0.5, 0.3, mode, 1))


@pytest.mark.parametrize("name", ["data_a.yaml", "infer_m.yaml",
                                  "train_m.yaml"])
def test_load_config(name):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", name)
    overrides = ["training.lr=1e-4", "extra.list=[1,2]", "a.b.c=x"]
    defaults = {"training": {"lr": 1.0, "steps": 3}}
    got = PC.load_config(path, overrides, defaults)
    want = JC.load_config(path, overrides, defaults)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got.training.lr == 1e-4 and isinstance(got, PC.ConfigNode)


class _Tok:
    """HF-style stand-in: characters to ids; ``</answer>`` is one id."""

    def __call__(self, text, add_special_tokens=True, truncation=False,
                 max_length=None, padding=False):
        if not add_special_tokens:
            return {"input_ids": [126081]}
        ids = [1] + [10 + ord(c) % 500 for c in text] + [2]
        return {"input_ids": ids[:max_length] if truncation else ids}


def _grid_file(tmp_path, name, h, w, seed):
    rng = np.random.default_rng(seed)
    rec = {"input_ids": rng.integers(0, 8192, (h // 16) * (w // 16)).tolist(),
           "height": h, "width": w}
    path = tmp_path / name
    with open(path, "wb") as f:
        pickle.dump(rec, f)
    return str(path)


@pytest.mark.parametrize("kind", ["mmu", "t2i", "ti2ti", "ti2ti-no-text"])
def test_a_item_processor(tmp_path, kind):
    user = _grid_file(tmp_path, "user.pkl", 64, 96, 0)
    ans = _grid_file(tmp_path, "ans.pkl", 96, 64, 1)
    item = {"system_prompt": "edit the image", "user_prompt": "add a hat",
            "answer_text": "a hat, red, on the head"}
    if kind != "t2i":
        item["user_image"] = user
    if kind != "mmu":
        item["answer_image"] = ans
    if kind == "ti2ti-no-text":
        item["answer_text"] = ""
    outs = []
    for mod in (PIP, JIP):
        proc = mod.AItemProcessor(_Tok(), max_len=4096, answer_pad_len=64,
                                  rng=random.Random(3))
        # several items in a row: the rng's state carries across them
        outs.append([proc.process_item(item) for _ in range(4)]
                    + [proc.predict_length({"len": 77})])
    assert outs[0] == outs[1]


def test_mask_codes():
    codes = list(range(100, 140))
    for sch in ("cosine", "linear"):
        assert PIP.mask_codes(codes, sch, rng=random.Random(5)) == \
            JIP.mask_codes(codes, sch, rng=random.Random(5))


def test_meta_dataset_and_sampler(tmp_path):
    items = [{"len": 100 + 7 * i, "token": list(range(i % 5 + 1))}
             for i in range(40)]
    (tmp_path / "a.jsonl").write_text(
        "\n".join(json.dumps(x) for x in items[:25]))
    (tmp_path / "b.json").write_text(json.dumps(items[25:]))
    cfg = tmp_path / "data.yaml"
    cfg.write_text(f"META:\n  - path: {tmp_path / 'a.jsonl'}\n    type: x\n"
                   f"  - path: {tmp_path / 'b.json'}\n    type: y\n"
                   f"    ratio: 0.6\n")
    dsp, dsj = PD.MetaDataset(str(cfg)), JD.MetaDataset(str(cfg))
    assert dsp.types == dsj.types and len(dsp) == len(dsj)
    assert [dsp[i] for i in range(len(dsp))] == \
        [dsj[i] for i in range(len(dsj))]
    assert dsp.lengths() == dsj.lengths()
    kw = dict(batch_size=2, world_size=1, rank=0, acc_grad=2, seed=4,
              cluster_window=2)
    sp = PD.LengthClusteredSampler(dsp.lengths(), dsp.types, **kw)
    sj = JD.LengthClusteredSampler(dsj.lengths(), dsj.types, **kw)
    for epoch, start in ((0, 0), (1, 2)):
        sp.set_epoch(epoch, start)
        sj.set_epoch(epoch, start)
        assert list(sp) == list(sj) and len(sp) == len(sj)


def test_metric_logger(tmp_path):
    loggers = [PL.MetricLogger(), JL.MetricLogger()]
    for i in range(30):
        for lg in loggers:
            lg.update(loss=1.0 / (i + 1), lr=1e-4 * i)
    for lg in loggers:
        lg.synchronize_between_processes()      # one process: a no-op
    assert str(loggers[0]) == str(loggers[1])
    assert loggers[0].state_dict() == loggers[1].state_dict()
    w = PL.ScalarWriter(str(tmp_path / "tb"), use_tensorboard=False)
    w.write(3, {"loss": 0.5})
    w.close()
    assert json.loads((tmp_path / "tb" / "log.txt").read_text()) == \
        {"step": 3, "loss": 0.5}


# ---------------------------------------------------------------------------
# eval_scorers and data/parabench (the evaluation slice's host modules)
# ---------------------------------------------------------------------------

from mmada_parallel_torch import eval_scorers as PES  # noqa: E402
from mmada_parallel_torch.data import parabench as PPB  # noqa: E402
from mmada_parallel_tpu import eval_scorers as JES  # noqa: E402
from mmada_parallel_tpu.data import parabench as JPB  # noqa: E402


class _Req:
    def __init__(self, meta):
        self.meta = meta


_PALETTE = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                     [0.0, 0.0, 1.0]])


def _palette_decode(codes):
    return _PALETTE[np.asarray(codes).reshape(4, 4) % 4]


@pytest.mark.parametrize("meta,text,codes", [
    ({"input_codes": [1, 2, 3, 5], "target_codes": [2, 3, 4, 5],
      "keywords": ["rotated", "missing"]}, "the palette was Rotated",
     [2, 3, 4, 4]),
    (None, None, [7, 7]),
    ({"input_codes": [1] * 4 + [2] * 4, "edit_mask": [True] * 4 + [False] * 4},
     None, [9, 9, 1, 1, 2, 2, 2, 5]),
    ({"keywords": ["text"]}, "text", None)])
def test_eval_scorers_copy(meta, text, codes):
    codes = None if codes is None else np.asarray(codes)
    got = PES.default_edit_scorer()(_Req(meta), text, codes)
    assert got == JES.default_edit_scorer()(_Req(meta), text, codes)
    results = [{"scores": got}, {"scores": {"code_diversity": 0.5}}, {}]
    assert PES.aggregate_scores(results) == JES.aggregate_scores(results)


def test_psnr_ssim_and_pixel_scorer_copy():
    rng = np.random.default_rng(0)
    a = rng.random((32, 32, 3))
    for b in (a, np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1),
              rng.random((32, 32, 3))):
        assert PES.psnr(a, b) == JES.psnr(a, b)
        assert PES.ssim(a, b) == JES.ssim(a, b)
    assert PES.ssim(a[:4, :4, 0], a[:4, :4, 1]) == \
        JES.ssim(a[:4, :4, 0], a[:4, :4, 1])
    inp = list(range(16))
    req = _Req({"input_codes": inp,
                "target_codes": [(c + 1) % 4 for c in inp]})
    out = np.array([(c + 2) % 4 for c in inp])
    got = PES.pixel_edit_scorer(_palette_decode)(req, "text", out)
    assert got == JES.pixel_edit_scorer(_palette_decode)(req, "text", out)
    assert {"pixel_consistency_psnr", "pixel_target_ssim"} <= set(got)


_PB_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "parabench_mini.parquet")


def _pb_tokenize(s):
    return [10 + sum(map(ord, w)) % 100 for w in s.split()[:12]] or [10]


def _pb_encode_m(img):
    px = np.asarray(img.resize((4, 4))).astype(np.int64)
    return (px.reshape(-1, 3).sum(axis=1) % 32)[:6]


def _pb_encode_edit(img):
    raw = _pb_encode_m(img)
    grid = [int(c) + 7000 for c in raw]
    return [254] + JT.add_break_line(grid, 2, 3, 251) + [255], raw


def _pil_free(rows):
    """Rows with their images as comparable arrays."""
    return [{k: (np.asarray(JPB.as_pil(v)).tolist()
                 if k.endswith("image") and v is not None else v)
             for k, v in r.items()} for r in rows]


def test_parabench_copy_on_the_fixture():
    rows_p, rows_j = PPB.load_parabench(_PB_FIXTURE), \
        JPB.load_parabench(_PB_FIXTURE)
    assert _pil_free(rows_p) == _pil_free(rows_j)
    assert PPB.FIELD_CANDIDATES == JPB.FIELD_CANDIDATES
    for fm in (None, {"target_image": ""}):
        assert PPB.detect_fields(rows_p[0], fm) == \
            JPB.detect_fields(rows_j[0], fm)
    for task, rows, enc in (("edit", rows_p[:2], _pb_encode_edit),
                            ("interleave", rows_p[:2], _pb_encode_m),
                            ("t2i", rows_p[2:], None),
                            ("mmu", rows_p[:1], _pb_encode_m)):
        assert PPB.parabench_requests(rows, task, _pb_tokenize, enc) == \
            JPB.parabench_requests(rows, task, _pb_tokenize, enc)
    with pytest.raises(ValueError, match="input image"):
        PPB.parabench_requests(rows_p[2:], "interleave", _pb_tokenize,
                               _pb_encode_m)


def test_parabench_copy_on_a_jsonl_export(tmp_path):
    """A jsonl export: an image as a relative path, one as base64, a row
    without its image column; the same requests from both modules."""
    import base64
    import io
    img = _seeded_image(16, 16, 3)
    img.save(tmp_path / "a.png")
    buf = io.BytesIO()
    _seeded_image(16, 16, 4).save(buf, "PNG")
    lines = [{"instruction": "a text-only row", "id": 1},
             {"instruction": "edit this", "input_image": "a.png",
              "output_text": "a red hat on the head", "id": 2},
             {"edit_instruction": "ignored", "instruction": "and this",
              "input_image": base64.b64encode(buf.getvalue()).decode()}]
    path = tmp_path / "pb.jsonl"
    path.write_text("\n".join(json.dumps(x) for x in lines))
    rows_p, rows_j = PPB.load_parabench(str(path)), \
        JPB.load_parabench(str(path))
    assert rows_p == rows_j and len(rows_p) == 3
    for task in ("edit", "mmu"):
        enc = _pb_encode_edit if task == "edit" else _pb_encode_m
        got = PPB.parabench_requests(rows_p, task, _pb_tokenize, enc)
        assert got == JPB.parabench_requests(rows_j, task, _pb_tokenize, enc)
        assert "input_codes" not in got[0]["meta"]


# -- the M trainer's data layer (data/prompting, shards, tokenizer,
# tarstream, tokenstore, pretokenize, imagenet): each copy exports what its
# original does and behaves the same; the shard, prompting and token-store
# behaviour is held in depth by tests/test_torch_data_m.py

import importlib  # noqa: E402

_M_COPIES = ["data.prompting", "data.shards", "data.tokenizer",
             "data.tarstream", "data.tokenstore", "data.pretokenize",
             "data.imagenet", "utils.determinism", "utils.diagnostics",
             "utils.param_store", "utils.profiling"]


@pytest.mark.parametrize("name", _M_COPIES)
def test_m_copies_export_what_their_originals_do(name):
    port = importlib.import_module(f"mmada_parallel_torch.{name}")
    ref = importlib.import_module(f"mmada_parallel_tpu.{name}")
    assert port.__all__ == ref.__all__
    assert all(hasattr(port, n) for n in port.__all__)
    assert f"mmada_parallel_tpu.{name}" in port.__doc__   # its counterpart


class _SegmentTok:
    """A transformers-style inner tokenizer that merges a leading space
    into the next word (as sentencepiece-derived vocabularies do)."""

    def encode(self, s, **kw):
        return [hash(w) % 997 for w in s.replace(" ", " _").split(" ")
                if w]

    def decode(self, ids):
        return " ".join(map(str, ids))


@pytest.mark.parametrize("text", ["my darling", " leading space", "x=1"])
def test_tokenizer_wrapper_copy(text):
    """``Tokenizer``'s probing and segment encoders on one inner tokenizer
    (``__init__``, which loads a model file, is bypassed in both)."""
    from mmada_parallel_torch.data import tokenizer as PTOK
    from mmada_parallel_tpu.data import tokenizer as JTOK
    outs = []
    for mod in (PTOK, JTOK):
        tok = object.__new__(mod.Tokenizer)
        tok.tokenizer_type, tok.tokenizer = "transformers", _SegmentTok()
        tok.bos_id, tok.eos_id = 1, 2
        tok._probe_tokenizer_style()
        outs.append((tok.need_space_before_segment,
                     tok.encode(text, bos=True, eos=True),
                     tok.encode_segment(text), tok.encode_wo_prefix_space(
                         text), tok.decode([3, 4])))
        conv = mod.ConversationTemplate()
        conv.append_message("user", text)
        outs.append((conv.roles, conv.messages))
        conv.clear()
        assert conv.messages == []
    assert outs[0] == outs[2] and outs[1] == outs[3]


def test_image_folder_dataset_copy(tmp_path):
    from mmada_parallel_torch.data.imagenet import \
        ImageFolderCaptionDataset as P
    from mmada_parallel_tpu.data.imagenet import \
        ImageFolderCaptionDataset as J
    for cls, color in (("golden_retriever", 10), ("n0123", 200)):
        (tmp_path / cls).mkdir()
        _seeded_image(12, 10, color).save(tmp_path / cls / "a.png")
    (tmp_path / "n0123" / "notes.txt").write_text("skipped")
    mapping = tmp_path / "map.json"
    mapping.write_text('{"n0123": "tabby cat"}')
    kw = dict(class_mapping_json=str(mapping),
              transform=lambda im: np.asarray(im, np.float32)[None] / 255)
    p, j = P(str(tmp_path), **kw), J(str(tmp_path), **kw)
    assert len(p) == len(j) == 2 and p.samples == j.samples
    for i in range(2):
        a, b = p[i], j[i]
        assert (a["caption"], a["path"]) == (b["caption"], b["path"])
        np.testing.assert_array_equal(a["pixels"], b["pixels"])
    assert [p[i]["caption"] for i in range(2)] == [
        "An image of golden retriever.", "An image of tabby cat."]


def test_parquet_items_copy_without_datasets(monkeypatch, tmp_path):
    """``parquet_items`` maps dataset rows the same way in both packages;
    ``datasets`` is replaced by an in-memory loader."""
    import sys
    import types
    from mmada_parallel_torch.data.pretokenize import parquet_items as P
    from mmada_parallel_tpu.data.pretokenize import parquet_items as J
    img = _seeded_image(8, 8, 5)
    rows = [{"input_image": img, "output_image": img, "prompt": "p1"},
            {"input_image": img, "caption": "c2"},
            {"image_list": [{"image": img}], "text": "t3"}]
    fake = types.ModuleType("datasets")
    fake.load_from_disk = lambda path: rows
    fake.load_dataset = lambda path, split: rows
    monkeypatch.setitem(sys.modules, "datasets", fake)
    for task in ("edit", "t2i", "mmu", "mmu_multi_image"):
        got, want = list(P("x", task)), list(J("x", task))
        assert [(g["caption"], g["task_type"], len(g["images"]))
                for g in got] == [(w["caption"], w["task_type"],
                                   len(w["images"])) for w in want]
        for g, w in zip(got, want):
            for a, b in zip(g["images"], w["images"]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
