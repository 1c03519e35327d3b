"""The variant-A SFT step: ``cli/train_a.build_train_step``'s step on
seeded pre-tokenized rows, one step after another.

Traffic parameters (``benchmark/traffic/<name>.json``): ``seq_len``, the
rows of a microbatch and the microbatches of a step, the row layout (the
answer image's grid and the answer text's length; the instruction fills
the rest) and the masking ratio's range.  Each step's rows are drawn on
the card from the run's generator, so no two rows are alike.

Set-up builds the step and its state (f32 parameters from the seed, bf16
compute, AdamW behind the clip, remat per layer) and drives it through
its first three steps, the shapes' warm-up; the window then continues the
same object.  The program's readings are taken there: each step's loss,
the first gradient as the optimizer got it (AdamW's first moment after one
step over ``1 - b1``) and the parameters' change after two steps, by leaf.
After the window the reference (``reference/train.py``) makes the same
parameters from the seed and follows the first two steps on the same
rows in f32.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import port, weights
from benchmark.harness import training as TR
from benchmark.reference import train as RT


def run_log(msg: str) -> None:
    from benchmark.harness.core import log
    log(f"[train-a] {msg}")


class Rows:
    """The A SFT rows of the traffic file: instruction text, ``[boi]`` the
    user image (a grid of codes with a newline after each grid row)
    ``[eoi]``, then the answer ``[answer_start][boi]`` image ``[eoi]``
    text ``[answer_end]`` with each answer token masked with one chance
    a row, drawn from ``mask_ratio``; labels hold the masked tokens."""

    def __init__(self, conf: dict, tr: dict, gen: torch.Generator):
        self.tk, self.tr, self.gen = conf["tokens"], tr, gen
        self.cb = conf["codebook_size"]

    def _image(self, n):
        g, dev = self.tr["grid"], self.gen.device
        codes = torch.randint(0, self.cb, (n, g, g), generator=self.gen,
                              device=dev) + self.tk["text_vocab_size"]
        nl = torch.full((n, g, 1), self.tk["newline"], device=dev)
        return torch.cat([codes, nl], 2).reshape(n, -1)

    def _text(self, n, length):
        return torch.randint(self.tk["lo"], self.tk["hi"], (n, length),
                             generator=self.gen, device=self.gen.device)

    def make(self, n: int):
        """``(ids, labels, lengths)`` of ``n`` rows on the device."""
        tk, tr, dev = self.tk, self.tr, self.gen.device

        def const(*ids):
            return torch.tensor(ids, device=dev).expand(n, len(ids))

        ans_img, ans_txt = self._image(n), self._text(n, tr["answer_text"])
        tail = [const(tk["answer_start"], tk["boi"]), ans_img,
                const(tk["eoi"]), ans_txt, const(tk["answer_end"])]
        user = self._image(n)
        head_len = tr["seq_len"] - sum(t.shape[1] for t in tail) - \
            user.shape[1] - 2
        head = [self._text(n, head_len), const(tk["boi"]), user,
                const(tk["eoi"])]
        ids = torch.cat(head + tail, 1)
        answer = torch.zeros_like(ids, dtype=torch.bool)
        a0 = sum(t.shape[1] for t in head) + 2
        answer[:, a0:a0 + ans_img.shape[1]] = ans_img != tk["newline"]
        t0 = a0 + ans_img.shape[1] + 1
        answer[:, t0:t0 + ans_txt.shape[1]] = True
        lo, hi = tr["mask_ratio"]
        ratio = lo + (hi - lo) * torch.rand(n, 1, generator=self.gen,
                                            device=dev)
        masked = answer & (torch.rand(ids.shape, generator=self.gen,
                                      device=dev) < ratio)
        labels = torch.where(masked, ids, torch.full_like(ids, -100))
        ids = torch.where(masked, torch.full_like(ids, tk["mask"]), ids)
        return ids, labels, torch.full((n,), tr["seq_len"], device=dev)


class TrainDriver:
    def __init__(self, run):
        from mmada_parallel_torch.cli.train_a import build_train_step
        from mmada_parallel_torch.ops import attention_bwd as AB
        from mmada_parallel_torch.ops.rope_attention import \
            flash_attention_rope
        self.run, self.conf, self.tr = run, run.config, run.traffic
        self.k1, self.k1_bwd = flash_attention_rope, \
            AB.flash_attention_rope_bwd
        rc = self.conf["recipe"]
        self.cfg = port.llada_config(self.conf, self.conf["param_dtype"],
                                     self.conf["compute_dtype"], rc["remat"])
        t = time.time()
        params = self._params()
        self.state, self.step, _ = build_train_step(
            self.cfg, params, lr=rc["lr"], min_lr=rc["min_lr"],
            wd=rc["weight_decay"], clip_grad=rc["clip"],
            warmup_steps=rc["warmup_steps"], total_steps=rc["total_steps"],
            accum_steps=self.conf["accum_iter"])
        del params
        self.rows = Rows(self.conf, self.tr, torch.Generator(
            device=run.device).manual_seed(run.seed + 1))
        self.n_rows = self.conf["accum_iter"] * self.conf["batch_size"]
        self.tokens = self.n_rows * self.tr["seq_len"]
        self._sync()
        run_log(f"state made in {time.time() - t:.3f} s")

    def _params(self):
        gen = torch.Generator(device=self.run.device).manual_seed(
            self.run.seed)
        return weights.llada_params(self.conf, gen, torch.float32)

    def _sync(self):
        if self.run.device == "cuda":
            torch.cuda.synchronize()

    def warm_up(self):
        """The first steps, which the reference follows: each step's loss,
        the gradient the optimizer got at step 1, the change after
        ``COMPARED`` steps."""
        t = time.time()
        b1 = self.conf["recipe"]["b1"]
        self.batches, losses = [], []
        for s in range(TR.WARM_STEPS):
            batch = self.rows.make(self.n_rows)
            self.state, m = self.step(self.state, batch)
            losses.append(float(m["loss"]))
            if s < TR.COMPARED:
                self.batches.append(tuple(t.clone() for t in batch[:2]))
            if s == 0:
                grads = TR.moment_norms(self.state.opt_state, b1)
            if s == TR.COMPARED - 1:
                change = TR.change_norms(self.state.params, self._params())
        self.readings = TR.Readings(losses[:TR.COMPARED], grads, change)
        self._sync()
        run_log(f"{TR.WARM_STEPS} steps in {time.time() - t:.3f} s, losses "
                f"{losses}")

    def plan(self, seconds: float) -> int:
        self.warm_up()
        self._sync()
        t = time.time()
        batch = self.rows.make(self.n_rows)
        self.state, _ = self.step(self.state, batch)
        self._sync()
        est = time.time() - t
        self.k1_before = (self.k1.launches, self.k1_bwd.launches)
        return max(2, round(seconds / est))

    def window(self, units: int):
        for _ in range(units):
            self.state, _ = self.step(self.state,
                                      self.rows.make(self.n_rows))

    def end_to_end(self, wall: float, units: int) -> dict:
        rc = self.conf["recipe"]
        fwd = units * self.conf["accum_iter"] * self.cfg.n_layers * (
            2 if self.cfg.remat != "none" else 1)
        bwd = units * self.conf["accum_iter"] * self.cfg.n_layers
        got = (self.k1.launches - self.k1_before[0],
               self.k1_bwd.launches - self.k1_before[1])
        if self.run.device == "cuda" and got != (fwd, bwd):
            raise RuntimeError(f"K1 forward/backward launched {got} times "
                               f"in the window, expected {(fwd, bwd)}")
        return {"train_tokens_per_s": units * self.tokens / wall}

    def work(self, units: int) -> dict:
        L, B = self.tr["seq_len"], self.conf["batch_size"]
        acc = self.conf["accum_iter"]
        calls = units * acc * self.cfg.n_layers
        remat = self.cfg.remat != "none"
        shape = {"B": B, "L": L, "Lq": L}
        return {"model": self.conf,
                "train": {"steps": units, "microbatches": acc, "rows": B,
                          "L": L, "remat": remat},
                "attention": [
                    {**shape, "count": calls * (2 if remat else 1),
                     "bwd": False},
                    {**shape, "count": calls, "bwd": True}]}

    def release(self):
        del self.state, self.step

    def reference(self, mm=None, micro=None) -> TR.Readings:
        rc = self.conf["recipe"]

        def loss(params, batch, mm, micro):
            return RT.a_loss_and_grads(params, self.conf, batch,
                                       self.conf["accum_iter"], mm, micro)

        return TR.reference_run(
            self._params, self.batches, loss, rc,
            RT.half_cosine(rc["lr"], rc["warmup_steps"], rc["total_steps"],
                           rc["min_lr"]), mm, micro)

    def check(self) -> list:
        ref = self.reference()
        run_log(f"reference losses {ref.losses}; program "
                f"{self.readings.losses}")
        r = TR.compare(self.readings, ref)
        return [(k, r[k], self.run.limits[k]) for k in
                sorted(self.run.limits)]


def calibrate(run, control: bool) -> dict:
    """The set-up's steps from the seed and the check's readings; with
    ``control``, also the control's and the half-batch fault's
    (``training.calibration``)."""
    d = TrainDriver(run)
    d.warm_up()
    d.release()
    if not control:
        return TR.compare(d.readings, d.reference())
    return TR.calibration(d.readings, d.reference,
                          range(d.conf["accum_iter"] // 2))


def setup(run) -> TrainDriver:
    return TrainDriver(run)
