"""The port's spans and counters (``utils/spans.py``) on the CPU.

* with the profiler off a tiny edit and a tiny train step record nothing,
  open no ``record_function`` and make no CUDA event;
* under ``torch.profiler`` a tiny ``TI2TIPipeline`` edit records
  ``edit`` and its phases, a ``ti2ti.step`` a denoising step and the image
  spans on each image step, each under its parent; ``make_train_step``
  records ``train.step`` a step, ``train.microbatch`` a microbatch and
  ``train.update_bytes`` (28 bytes an f32 parameter for AdamW, 20 for
  Lion) for each applied update; ``train_loop`` records
  ``train_m.assemble`` with ``vq.encode`` under it;
* each span is a ``record_function`` event of the same session, at the
  same host interval to within 1 ms (the device trace's clock);
* a second session begins empty;
* ids, codes and parameters are the same bit for bit with the profiler on
  and off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmada_parallel_torch import tokens as tk
from mmada_parallel_torch.cli import train_m as PTM
from mmada_parallel_torch.config import load_config
from mmada_parallel_torch.models import amused_vq as AVQ
from mmada_parallel_torch.models import llada as L
from mmada_parallel_torch.models import magvit2 as MVQ
from mmada_parallel_torch.ops import sampling as S
from mmada_parallel_torch.pipeline import TI2TIPipeline
from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
from mmada_parallel_torch.training import trainer as TR
from mmada_parallel_torch.utils import spans

torch.set_num_threads(1)
OPTS = TI2TIOptions(text_steps=4, timesteps=2, temperature=1.0,
                    text_temperature=0.0, cfg_scale=0.0, cfg_img=4.0,
                    codebook_size=32)


class FakeTok:
    bos_token_id, eos_token_id = 1, 2

    def __call__(self, t, **kw):
        if isinstance(t, list):
            return {"input_ids": [self(x)["input_ids"] for x in t]}
        return {"input_ids": [1] + [10 + ord(c) % 80 for c in t[:8]] + [2]}

    def decode(self, ids, **kw):
        return " ".join(map(str, ids))


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture(scope="module")
def pipe():
    cfg = L.LLaDAConfig.tiny(vocab_size=tk.TOKENS_A.full_vocab_size)
    vcfg = AVQ.AmusedVQConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    return TI2TIPipeline(cfg, L.init_llada_params(cfg, gen), vcfg,
                         AVQ.init_amused_vq_params(vcfg, gen), FakeTok())


def _edit(pipe):
    image = (np.random.default_rng(0).random((16, 16, 3)) * 255).astype(
        np.uint8)
    return pipe("add a hat", image, 16, 16, OPTS, text_gen_length=8,
                seed=11)


def _linear_loss(params, batch, generator):
    x, y = batch
    loss = ((x @ params["w"] + params["b"] - y) ** 2).mean()
    return loss, {"mse": loss.detach()}


def _train(name="adamw", steps=3, nan_at=None):
    """``steps`` steps of a 4x3 linear map (15 f32 parameters) with
    gradients accumulated over 2 microbatches; the loss of step
    ``nan_at`` is NaN (the update is skipped)."""
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 3, generator=gen),
              "b": torch.randn(3, generator=gen)}
    opt = TR.make_optimizer(TR.OptimizerConfig(name=name, lr=0.1), params)
    state = TR.TrainState.create(params, opt)
    step = TR.make_train_step(_linear_loss, opt, accum_steps=2)
    for i in range(steps):
        x = torch.randn(4, 4, generator=gen)
        y = torch.randn(4, 3, generator=gen)
        if i == nan_at:
            y[0, 0] = float("nan")
        state, _ = step(state, (x, y))
    return state.params


def _tree(records):
    """``{name: [parent name, ...]}`` of a session's records."""
    out = {}
    for name, _, _, parent in records:
        out.setdefault(name, []).append(
            None if parent is None else records[parent][0])
    return out


def test_profiler_off_records_nothing(pipe, monkeypatch):
    _traced(lambda: _train(steps=1))          # a session with its records
    before, counted = spans.records(), spans.counters()
    assert before and counted

    def refuse(*a, **k):
        raise AssertionError("a span did work with the profiler off")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _edit(pipe)
    _train()
    assert spans.records() == before and spans.counters() == counted


def test_edit_records_its_phases_and_steps(pipe):
    _traced(lambda: _edit(pipe))
    tree = _tree(spans.records())
    n_img = int(S.image_step_mask(OPTS.text_steps, OPTS.timesteps).sum())
    steps = OPTS.text_steps
    assert tree["edit"] == [None]
    for phase in ("edit.encode", "edit.sample", "edit.decode"):
        assert tree[phase] == ["edit"]
    assert tree["vq.encode"] == ["edit.encode"]
    assert tree["vq.decode"] == ["edit.decode"]
    assert tree["ti2ti.step"] == ["edit.sample"] * steps
    for name in ("ti2ti.cond", "ti2ti.text_update"):
        assert tree[name] == ["ti2ti.step"] * steps
    for name in ("ti2ti.uncond", "ti2ti.image_update"):
        assert tree[name] == ["ti2ti.step"] * n_img
    s = spans.summary()
    assert s["ti2ti.step"]["n"] == steps
    for v in s.values():
        assert v["device_s"] is None                # no card
        assert 0 <= v["self_host_s"] <= v["host_s"]
    assert s["edit"]["host_s"] >= s["edit.sample"]["host_s"] > 0


@pytest.mark.parametrize("name, per_param", [("adamw", 28), ("lion", 20)])
def test_train_step_records_microbatches_and_update_bytes(name, per_param):
    _traced(lambda: _train(name, steps=3, nan_at=1))
    tree = _tree(spans.records())
    assert tree["train.step"] == [None] * 3
    assert tree["train.microbatch"] == ["train.step"] * 6
    assert tree["train.grad_norm"] == ["train.step"] * 3
    assert tree["train.update"] == ["train.step"] * 3
    # two applied updates of 15 f32 parameters (step 1 was skipped)
    assert spans.counters() == {"train.update_bytes": 2 * per_param * 15}


def test_train_loop_records_the_assembly_and_its_encodes():
    cfg = load_config(None, [f"{k}={v}" for k, v in {
        "dataset.preprocessing.max_seq_length": 8,
        "dataset.preprocessing.resolution": 8,
        "model.mmada.num_vq_tokens": 16, "training.batch_size": 1,
        "training.gradient_accumulation_steps": 2,
        "training.max_train_steps": 2, "training.log_every": 1}.items()],
        PTM.DEFAULTS)
    T = tk.TOKENS_M
    mcfg = L.LLaDAConfig.tiny(vocab_size=T.full_vocab_size,
                              mask_token_id=T.mask)
    gen = torch.Generator().manual_seed(0)
    vcfg = MVQ.MagvitConfig.tiny()
    models = PTM.Models(mcfg, L.init_llada_params(mcfg, gen), FakeTok(),
                        vcfg, MVQ.init_magvit_params(vcfg, gen))
    state, step, sched = PTM.build_train_step(mcfg, models.params, cfg)
    rng = np.random.default_rng(0)
    samples = [{"pixels_in": rng.uniform(-1, 1, (1, 8, 8, 3)),
                "pixels_out": rng.uniform(-1, 1, (1, 8, 8, 3)),
                "instruction": f"edit {i}", "output_text": "an answer",
                "is_text_only": False} for i in range(4)]
    _traced(lambda: PTM.train_loop(cfg, state, step, samples, models, sched,
                                   torch.Generator().manual_seed(1)))
    tree = _tree(spans.records())
    assert tree["train_m.assemble"] == [None] * 2
    assert tree["vq.encode"] == ["train_m.assemble"] * 4
    assert tree["train.step"] == [None] * 2
    assert tree["train_m.log"] == [None] * 2


def _ns(e, what):
    fn = getattr(e, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(e, f"{what}_us")()
                                                 * 1000)


def test_spans_are_record_function_events_on_the_trace_clock(pipe):
    _, prof = _traced(lambda: (_edit(pipe), _train(steps=2)))
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            start = _ns(e, "start")
            events.setdefault(e.name(), []).append(
                (start, start + _ns(e, "duration")))
    recs = spans.records()
    assert len(recs) > 20
    for name, start, end, _ in recs:
        assert any(abs(start - a) < 1e6 and abs(end - b) < 1e6
                   for a, b in events.get(name, ())), name


def test_a_second_session_begins_empty(pipe):
    _traced(lambda: _edit(pipe))
    assert "edit" in spans.summary()
    assert set(spans.counters()) == {"vq.norm_bytes"}   # the VQ's norms
    _traced(lambda: _train(steps=1))
    assert {r[0] for r in spans.records()} == {
        "train.step", "train.microbatch", "train.grad_norm", "train.update"}
    assert set(spans.counters()) == {"train.update_bytes"}


def test_outputs_bit_identical_with_the_profiler_on_and_off(pipe):
    (_, text_on, on), _ = _traced(lambda: _edit(pipe))
    _, text_off, off = _edit(pipe)
    assert text_on == text_off
    for k in ("ids", "codes", "pixels"):
        assert np.array_equal(on[k], off[k]), k
    p_on, _ = _traced(_train)
    p_off = _train()
    for k in p_off:
        assert torch.equal(p_on[k], p_off[k]), k


def test_tensor_counters_sum_on_their_device_and_read_as_numbers():
    """A counter fed tensors (the experts a layer touched, counted on the
    device with no sync) reads as the number they sum to, and only while
    the profiler records; ``recording`` says which."""
    assert not spans.recording()
    spans.count("moe.experts_touched", torch.tensor(3))
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.recording()
        spans.count("moe.experts_touched", torch.tensor(3))
        spans.count("moe.experts_touched", 2)
        spans.count("moe.experts_touched", torch.tensor(4))
    got = spans.counters()
    assert got == {"moe.experts_touched": 9}
    assert isinstance(got["moe.experts_touched"], int)
