"""The port's variant-M data layer against the JAX package's.

``UniversalPrompting`` (every builder) and ``encode_output_texts`` give the
same arrays from the same stand-in tokenizer and the same numpy dropout
stream; the tar-shard datasets and caption sources give the same samples on
the JAX tests' tar fixtures; the native tar reader (built into
``mmada_parallel_torch/_build/``) equals ``tarfile``; ``TokenStore`` round
trips, also across the two packages' builds; ``PreTokenizer`` resumes and
writes JAX's records."""

import io
import json
import os
import pickle
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from mmada_parallel_torch.data import prompting as PP
from mmada_parallel_torch.data import shards as PS
from mmada_parallel_torch.data import tarstream as PTS
from mmada_parallel_torch.data import tokenstore as PTK
from mmada_parallel_torch.data import pretokenize as PPT
from mmada_parallel_torch.utils import image as PIM
from mmada_parallel_tpu.data import prompting as JP
from mmada_parallel_tpu.data import shards as JS
from mmada_parallel_tpu.data import tokenstore as JTK
from mmada_parallel_tpu.data import pretokenize as JPT
from mmada_parallel_tpu.utils import image as JIM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeTokenizer:
    """The JAX tests' stand-in (``tests/test_data.py``): a batch call gives
    ids from the texts' lengths, a single call from the characters."""
    bos_token_id = 1
    eos_token_id = 2

    def __call__(self, text, **kw):
        if isinstance(text, list):
            return {"input_ids": [self("x" * max(len(t) % 7, 1))["input_ids"]
                                  for t in text]}
        ids = [self.bos_token_id] + [10 + (ord(c) % 50) for c in text[:16]]
        return {"input_ids": ids}


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype


TEXTS = ["hello", "a longer prompt text", "", "xy"]


def _call(up, builder, rng):
    B = len(TEXTS)
    img = rng.integers(1000, 2000, (B, 6))
    lab = rng.integers(1000, 2000, (B, 6))
    if builder == "t2i":
        return up.t2i(TEXTS, img, lab)
    if builder == "t2i_gen":
        return up.t2i_gen(TEXTS, img)
    if builder == "lm":
        return up.lm(TEXTS, max_seq_len=6)
    if builder == "lm_chat":
        return up.lm_chat(TEXTS, max_seq_len=12)
    if builder == "mmu":
        return up.mmu(img, TEXTS)
    if builder == "r2i":
        return up.r2i(img, TEXTS)
    msl = 5
    out_text = rng.integers(10, 60, (B, msl))
    out_lab = np.where(rng.random((B, msl)) < 0.5, out_text, -100)
    return up.interleave(img, TEXTS, img + 1, out_text, out_lab,
                         cond_dropout_prob=0.4, output_image_labels=lab,
                         output_text_lengths=[5, 2, 9, 3],
                         is_text_only=[False, True, False, False])


@pytest.mark.parametrize("builder", ["t2i", "t2i_gen", "lm", "lm_chat",
                                     "mmu", "r2i", "interleave"])
@pytest.mark.parametrize("max_text_len,end_header", [(8, None), (3, 12)])
def test_prompting_builders_equal_jax(builder, max_text_len, end_header):
    """Same ids, masks and labels from both packages, dropout included
    (``cond_dropout_prob`` 0.1 in the text builders, 0.4 in
    ``interleave``), over a run of three calls that advance the numpy
    stream; ``end_header`` (12 = the id of ``"<"`` here) sets the
    header-prompt masks, and a short ``max_text_len`` truncates."""
    kw = dict(max_text_len=max_text_len, end_header_id=end_header)
    ups = (PP.UniversalPrompting(FakeTokenizer(), **kw),
           JP.UniversalPrompting(FakeTokenizer(), **kw))
    for seed in range(3):
        got, want = (_call(up, builder, np.random.default_rng(seed))
                     for up in ups)
        _equal(got, want)


@pytest.mark.parametrize("tok", [None, FakeTokenizer()])
@pytest.mark.parametrize("msl", [4, 12])
def test_encode_output_texts_equal_jax(tok, msl):
    texts = ["short", "", "a much longer output text than the slots"]
    _equal(PP.encode_output_texts(tok, texts, msl),
           JP.encode_output_texts(tok, texts, msl))


def _png(color, size=8):
    b = io.BytesIO()
    Image.new("RGB", (size, size), color).save(b, format="PNG")
    return b.getvalue()


def _write_tar(path, members):
    with tarfile.open(path, "w") as tf:
        for name, payload in members:
            ti = tarfile.TarInfo(name)
            ti.size = len(payload)
            tf.addfile(ti, io.BytesIO(payload))


def _comparable(sample):
    """A decoded sample with its PIL images as arrays."""
    return {k: (np.asarray(v) if isinstance(v, Image.Image) else v)
            for k, v in sample.items()}


def _same_samples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _comparable(g), _comparable(w)
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


def test_interleave_pair_dataset_equal_jax(tmp_path):
    """The fixture of ``tests/test_training.py::
    test_interleave_pair_shard_dataset``: a full pair, a text-only sample
    (placeholders), a sample with no text (dropped); with and without the
    trainer's squash transform, and a fixed-count epoch."""
    path = tmp_path / "pairs-000.tar"
    _write_tar(path, [
        ("s0.input.jpg", _png((200, 0, 0))),
        ("s0.output.jpg", _png((0, 200, 0))),
        ("s0.input_text.txt", b"make it green"),
        ("s0.output_text.txt", b"I changed the color."),
        ("s1.instruction", b"just talk"),
        ("s1.output_text.txt", b"ok"),
        ("s2.input.jpg", _png((1, 2, 3))),
    ])
    got = list(PS.InterleavePairShardDataset(str(path), resolution=8))
    want = list(JS.InterleavePairShardDataset(str(path), resolution=8))
    _same_samples(got, want)
    assert [g["__key__"] for g in got] == ["s0", "s1"]
    assert got[1]["is_text_only"] and not got[0]["is_text_only"]
    got = list(PS.InterleavePairShardDataset(
        str(path), transform=lambda im: PIM.image_transform_squash(im, 8),
        resolution=8, samples_per_epoch=5))
    want = list(JS.InterleavePairShardDataset(
        str(path), transform=lambda im: JIM.image_transform_squash(im, 8),
        resolution=8, samples_per_epoch=5))
    _same_samples(got, want)
    assert len(got) == 5 and got[0]["pixels_in"].shape == (1, 8, 8, 3)


def test_text2image_dataset_equal_jax(tmp_path):
    """``tests/test_data.py::test_shard_reader_and_dataset``'s shard: two
    PNG + caption samples, once and with a fixed-count epoch."""
    _write_tar(tmp_path / "shard-000.tar",
               [m for key, cap in [("img1", "a cat"), ("img2", "a dog")]
                for m in [(f"{key}.png", _png((10, 20, 30), 32)),
                          (f"{key}.txt", cap.encode())]])
    pattern = str(tmp_path / "shard-{000..000}.tar")
    for spe in (None, 5):
        got = list(PS.Text2ImageShardDataset(pattern, samples_per_epoch=spe))
        want = list(JS.Text2ImageShardDataset(pattern, samples_per_epoch=spe))
        _same_samples(got, want)
    assert [g["caption"] for g in got[:2]] == ["a cat", "a dog"]


def _mk_shard(path, keys, with_txt=None):
    members = []
    for key in keys:
        members.append((f"{key}.png", _png((5, 5, 5), 16)))
        if with_txt:
            members.append((f"{key}.txt", with_txt[key].encode()))
    _write_tar(path, members)


def _routers(pkg, tmp_path):
    return pkg.CaptionRouter(routes=[
        ("SA1B", pkg.SidecarCaptions(str(tmp_path / "sa_caps"))),
        ("laion", pkg.SidecarCaptions(str(tmp_path / "laion_caps"),
                                      ext=".caption", nested=True)),
        ("JourneyDB", pkg.JsonCaptions(str(tmp_path / "jdb.json"))),
        ("ai2d", pkg.CsvCaptions(str(tmp_path / "ai2d.csv"),
                                 key_suffix=".png")),
    ])


@pytest.mark.parametrize("mode", ["generation", "captioning", "csv_files"])
def test_caption_sources_equal_jax(tmp_path, mode):
    """``tests/test_data.py::test_caption_source_zoo``'s layouts (SA1B
    sidecars, LAION nested sidecars, JourneyDB json, an ai2d csv) routed by
    shard URL, in generation mode (prefixes stripped), captioning mode (an
    instruction prompt prepended), and through ``caption_files``."""
    sa = tmp_path / "sa_caps"
    sa.mkdir()
    (sa / "sa01.txt").write_text("a beach. with waves\n")
    la = tmp_path / "laion_caps" / "laion-000"
    la.mkdir(parents=True)
    (la / "la01.caption").write_text("The image depicts a city")
    (tmp_path / "jdb.json").write_text('{"jd01": ["a painting", "alt"]}')
    (tmp_path / "ai2d.csv").write_text("image,caption\nai01.png,a diagram\n")
    (tmp_path / "caps.csv").write_text("key,caption\nsa01,from csv\n")
    for name, key in [("SA1B", "sa01"), ("laion", "la01"),
                      ("JourneyDB", "jd01"), ("ai2d", "ai01")]:
        _mk_shard(tmp_path / f"{name}-000.tar", [key])
    pattern = str(tmp_path / "{SA1B,laion,JourneyDB,ai2d}-000.tar")
    outs = []
    for pkg in (PS, JS):
        if mode == "csv_files":
            ds = pkg.Text2ImageShardDataset(
                pattern, caption_files=[str(tmp_path / "caps.csv")])
        else:
            proc = pkg.CaptionProcessor(
                is_captioning=mode == "captioning", prompts=["Describe: "])
            ds = pkg.Text2ImageShardDataset(
                pattern, caption_source=_routers(pkg, tmp_path),
                caption_processor=proc)
        outs.append({d["__key__"]: d["caption"] for d in ds})
    assert outs[0] == outs[1]
    if mode == "generation":
        assert outs[0]["la01"] == "a city"
    if mode == "csv_files":
        assert outs[0]["sa01"] == "from csv"


@pytest.mark.parametrize("pattern", ["s-{000..002}.tar", "{a,b}-{0..1}",
                                     "plain.tar", "x{9..11}y"])
def test_braceexpand_equal_jax(pattern):
    assert PS.braceexpand(pattern) == JS.braceexpand(pattern)


def test_native_tar_reader_equals_tarfile(tmp_path):
    """``native/tarstream.cc``, built into ``_build/``: entry-exact against
    ``tarfile`` (long pax names, nested dirs, empty members, a directory
    entry skipped), ``ShardReader`` native == fallback == the JAX
    package's reader; a truncated shard raises and is skipped; a 5000-byte
    pax name round-trips; a corrupt pax record is skipped."""
    assert PTS.native_available()
    assert os.path.dirname(PTS._build_lib()._name) == os.path.join(
        REPO, "mmada_parallel_torch", "_build")
    path = tmp_path / "shard-000.tar"
    long_key = "k" * 120
    with tarfile.open(path, "w") as tf:
        for name, payload in [("a.txt", b"hello"),
                              ("a.jpg", b"\xff\xd8jpegbytes"),
                              ("dir/b.txt", b"nested"),
                              (long_key + ".txt", b"longname payload"),
                              ("empty.bin", b"")]:
            ti = tarfile.TarInfo(name)
            ti.size = len(payload)
            tf.addfile(ti, io.BytesIO(payload))
        tf.addfile(tarfile.TarInfo("somedir/"))
    with tarfile.open(path) as tf:
        want = [(m.name, tf.extractfile(m).read()) for m in tf if m.isfile()]
    assert list(PTS.NativeTarStream(str(path))) == want
    native = list(PS.ShardReader([str(path)]))
    assert native == list(PS.ShardReader([str(path)], use_native=False))
    assert native == list(JS.ShardReader([str(path)], use_native=False))
    assert native[0]["__key__"] == "a" and native[0]["txt"] == b"hello"

    trunc = tmp_path / "trunc-000.tar"
    trunc.write_bytes(path.read_bytes()[:700])
    with pytest.raises(OSError):
        list(PTS.NativeTarStream(str(trunc)))
    assert list(PS.ShardReader([str(trunc)])) == []

    huge = tmp_path / "huge-000.tar"
    huge_name = "h" * 5000 + ".txt"
    _write_tar(huge, [(huge_name, b"abc")])
    assert list(PTS.NativeTarStream(str(huge))) == [(huge_name, b"abc")]

    bad = bytearray(512)
    bad[0:4] = b"junk"
    payload = b"4abc 5 a=b\n"
    bad[124:136] = b"%011o\x00" % len(payload)
    bad[156] = ord("x")
    corrupt = tmp_path / "badpax-000.tar"
    corrupt.write_bytes(bytes(bad) + payload.ljust(512, b"\0") + b"\0" * 1024)
    assert list(PTS.NativeTarStream(str(corrupt))) == []


@pytest.fixture
def records():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 100000, rng.integers(3, 50)).tolist()
            for _ in range(37)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_token_store_round_trip(tmp_path, records, writer):
    """Written by either package, the port's store (its library built in
    ``_build/``) gathers every record back bit for bit, pads, truncates
    with the true lengths, refuses an out-of-range index, prefetches, and
    gives what the JAX package's store gives."""
    path = str(tmp_path / "train.tokstore")
    write = PTK.write_token_store if writer == "port" else \
        JTK.write_token_store
    assert write(path, records) == 37
    ts, ref = PTK.TokenStore(path), JTK.TokenStore(path)
    assert len(ts) == 37 and ts.lengths() == [len(r) for r in records]
    idx = [0, 5, 36, 17]
    out, lens = ts.gather(idx, max_len=64, pad=-7)
    _equal((out, lens), ref.gather(idx, max_len=64, pad=-7))
    for row, i in zip(out, idx):
        assert list(row[:len(records[i])]) == records[i]
        assert (row[len(records[i]):] == -7).all()
    longest = int(np.argmax([len(r) for r in records]))
    out2, lens2 = ts.gather([longest], max_len=4)
    assert out2.shape == (1, 4) and lens2[0] == len(records[longest])
    with pytest.raises(RuntimeError):
        ts.gather([999], max_len=8)
    batches = list(PTK.PrefetchLoader(ts, [[0, 1], [2, 3]], max_len=64,
                                      depth=2))
    assert len(batches) == 2
    _equal(batches[1], ts.gather([2, 3], 64))
    ts.close()
    ref.close()
    bad = tmp_path / "bad.tokstore"
    bad.write_bytes(b"not a token store at all, definitely not")
    with pytest.raises(OSError):
        PTK.TokenStore(str(bad))


def test_pretokenizer_resumes_and_writes_jax_records(tmp_path):
    """``tests/test_data.py::test_pretokenizer_resume`` on the port: shard
    0 of 2 does 3 items, a rerun after ``finished`` does none, and the
    merged records and token pickles equal the JAX package's; the port's
    ``encode_fn`` may return a tensor, and runs inside ``vq_precision``
    with autograd off."""
    seen = []

    def encode_port(x):
        seen.append((torch.is_grad_enabled(),
                     torch.backends.cudnn.allow_tf32))
        return torch.as_tensor(x).mean(-1).reshape(1, -1)[:, :4] * 100

    def encode_jax(x):
        return np.asarray(x).mean(-1).reshape(1, -1)[:, :4] * 100

    def load_image(item):
        return Image.new("RGB", (64 + 8 * item["id"], 64),
                         (100, 50, 20 * item["id"]))

    items = [{"id": i} for i in range(6)]
    outs = []
    for pkg, enc, name in ((PPT, encode_port, "port"),
                           (JPT, encode_jax, "jax")):
        out = tmp_path / name
        pt = pkg.PreTokenizer(enc, str(out), shard=0, num_shards=2,
                              target_size=64)
        assert pt.run(items, load_image) == 3
        assert pt.run(items, load_image) == 0
        pkg.PreTokenizer(enc, str(out), shard=1, num_shards=2,
                         target_size=64).run(items, load_image)
        with open(pkg.concat_records(str(out), 2)) as f:
            recs = json.load(f)
        toks = []
        for r in recs:
            with open(r.pop("token_path"), "rb") as f:
                toks.append(pickle.load(f))
        outs.append((recs, toks))
    assert len(seen) == 6 and not any(g or tf32 for g, tf32 in seen)
    assert outs[0] == outs[1]
    assert len(outs[0][0]) == 6
    assert set(outs[0][1][0]) == {"input_ids", "height", "width"}
