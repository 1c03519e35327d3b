"""The variant-M interleave SFT through ``cli/train_m.train_loop``: each
step assembles its batch (``assemble_batch``: two MagViT-v2 encodes of
512x512 pairs, the noising, the interleave rows with their key-padding
masks) and takes the step on it, the assembly in series with the step.

Traffic parameters (``benchmark/traffic/<name>.json``): the instructions
and answers each seeded edit pair draws one of, and ``image_pool``, the
images the window's pairs are drawn from.  The pairs are made on the host
from the seed before the window (decoded samples, as the loop takes
them); the set-up's steps each get new images.

Set-up builds the models (f32 LLaDA parameters and MagViT-v2 from the
seed), ``build_train_step``'s step and state, and drives the loop through
its first three steps one at a time, keeping each assembled batch; the
window is one more ``train_loop`` call of the planned steps.  The check:
the reference follows the first two steps from the batches the program
assembled (the program's own state, see ``PERF.md``), and checks the
assembly apart: the batches' image codes against the reference encoder's
latents, and each row's count of masked image tokens against its time.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from benchmark.harness import inputs, port, weights
from benchmark.harness import training as TR
from benchmark.reference import lowp
from benchmark.reference import magvit2 as RM
from benchmark.reference import train as RT


def run_log(msg: str) -> None:
    from benchmark.harness.core import log
    log(f"[train-m] {msg}")


class MDriver:
    def __init__(self, run):
        from mmada_parallel_torch.cli import train_m as TM
        from mmada_parallel_torch.config import load_config
        from mmada_parallel_torch.models.magvit2 import MagvitConfig
        from mmada_parallel_torch.ops import attention_bwd as AB
        from mmada_parallel_torch.ops.rope_attention import \
            flash_attention_rope
        self.TM, self.run, self.conf = TM, run, run.config
        self.tr, c, rc = run.traffic, run.config, run.config["recipe"]
        self.k1, self.k1_bwd = flash_attention_rope, \
            AB.flash_attention_rope_bwd
        self.mcfg = port.llada_config(c, c["param_dtype"],
                                      c["compute_dtype"], rc["remat"])
        over = {"output_dir": "unused", "device": run.device,
                "dataset.preprocessing.max_seq_length": c["max_seq_length"],
                "dataset.preprocessing.resolution": c["resolution"],
                "model.mmada.num_vq_tokens": c["num_vq_tokens"],
                "model.mmada.codebook_size": c["codebook_size"],
                "training.lr": rc["lr"],
                "training.weight_decay": rc["weight_decay"],
                "training.max_grad_norm": rc["clip"],
                "training.warmup_steps": rc["warmup_steps"],
                "training.max_train_steps": rc["total_steps"],
                "training.scheduler": rc["scheduler"],
                "training.batch_size": c["batch_size"],
                "training.gradient_accumulation_steps": c["accum_iter"],
                "training.min_masking_rate": rc["min_masking_rate"],
                "training.cond_dropout_prob": rc["cond_dropout_prob"],
                "training.text_coeff": rc["text_coeff"],
                "training.image_coeff": rc["image_coeff"],
                "training.save_every": 10 ** 9, "training.log_every": 10 ** 9}
        self.cfg = load_config(None, [f"{k}={v}" for k, v in over.items()],
                               TM.DEFAULTS)
        t = time.time()
        params = self._params()
        vq = dict(c["vq"])
        for k in ("enc_ch_mult", "enc_blocks", "dec_ch_mult", "dec_blocks"):
            vq[k] = tuple(vq[k])
        self.vparams = weights.magvit_params(c["vq"], torch.Generator(
            device=run.device).manual_seed(run.seed + 2))
        self.models = TM.Models(self.mcfg, params,
                                inputs.StandInTokenizer(c["tokens"]),
                                MagvitConfig(**vq), self.vparams)
        self.state, self.step, self.sched = TM.build_train_step(
            self.mcfg, params, self.cfg)
        del params
        self.noise = torch.Generator(device=run.device).manual_seed(
            run.seed + 3)
        self.rng = np.random.default_rng(run.seed)
        self.group = c["batch_size"] * c["accum_iter"]
        self.assembly_s = None
        self._sync()
        run_log(f"models and state made in {time.time() - t:.3f} s")

    def _params(self):
        gen = torch.Generator(device=self.run.device).manual_seed(
            self.run.seed)
        return weights.llada_params(self.conf, gen, torch.float32)

    def _sync(self):
        if self.run.device == "cuda":
            torch.cuda.synchronize()

    @staticmethod
    def _pixels(img):
        return img.astype(np.float32)[None] / 127.5 - 1

    def _sample(self, a, b) -> dict:
        """One decoded edit pair as the loop takes it, from two ``(uint8
        image, [-1, 1] pixels)``: the input image, both pixels, an
        instruction and an answer."""
        tr = self.tr
        return {"input_image": a[0], "pixels_in": a[1], "pixels_out": b[1],
                "instruction": tr["instructions"][int(self.rng.integers(
                    len(tr["instructions"])))],
                "output_text": tr["answers"][int(self.rng.integers(
                    len(tr["answers"])))],
                "is_text_only": False}

    def _image(self):
        img = inputs.image(self.rng, self.conf["resolution"])
        return img, self._pixels(img)

    def _samples(self, n: int) -> list:
        """``n`` pairs of new images: every row of a step differs."""
        return [self._sample(self._image(), self._image())
                for _ in range(n)]

    def _pooled(self, n: int) -> list:
        """``n`` pairs drawn from a pool of ``image_pool`` images (a
        dataset the window passes over more than once; drawing every
        image anew would make set-up longer than the window)."""
        pool = [self._image() for _ in range(self.tr["image_pool"])]
        return [self._sample(*(pool[int(i)] for i in self.rng.choice(
            len(pool), 2, replace=False))) for _ in range(n)]

    @contextlib.contextmanager
    def _assembly(self, record=None, timed=None):
        """``train_m.assemble_batch`` wrapped for the scope: its batches
        appended to ``record``, or its seconds (up to a synchronize) to
        ``timed``."""
        TM, real = self.TM, self.TM.assemble_batch

        def wrapped(*a, **k):
            if timed is not None:
                self._sync()
                t = time.time()
            out = real(*a, **k)
            if timed is not None:
                self._sync()
                timed.append(time.time() - t)
            if record is not None:
                record.append(tuple(x.clone() for x in out))
            return out

        TM.assemble_batch = wrapped
        try:
            yield
        finally:
            TM.assemble_batch = real

    def _loop(self, steps: int, samples) -> list:
        self.cfg.training.max_train_steps = self.state.step + steps
        self.state, hist = self.TM.train_loop(
            self.cfg, self.state, self.step, samples, self.models,
            self.sched, self.noise)
        return hist

    def warm_up(self):
        t = time.time()
        b1 = self.conf["recipe"]["b1"]
        self.batches, self.pairs, losses = [], [], []
        with self._assembly(record=self.batches):
            for s in range(TR.WARM_STEPS):
                pairs = self._samples(self.group)
                losses.append(self._loop(1, pairs)[0]["loss"])
                if s < TR.COMPARED:
                    self.pairs.append(pairs)
                if s == 0:
                    grads = TR.moment_norms(self.state.opt_state, b1)
                if s == TR.COMPARED - 1:
                    change = TR.change_norms(self.state.params,
                                             self._params())
        self.batches = self.batches[:TR.COMPARED]
        self.L = self.batches[0][0].shape[1]
        self.readings = TR.Readings(losses[:TR.COMPARED], grads, change)
        self._sync()
        run_log(f"{TR.WARM_STEPS} steps in {time.time() - t:.3f} s, rows of "
                f"{self.L} tokens, losses {losses}")

    def plan(self, seconds: float) -> int:
        self.warm_up()
        pairs = self._samples(self.group)
        self._sync()
        t = time.time()
        self._loop(1, pairs)
        self._sync()
        units = max(2, round(seconds / (time.time() - t)))
        self.window_pairs = self._pooled(self.group * units)
        self.k1_before = (self.k1.launches, self.k1_bwd.launches)
        return units

    def window(self, units: int):
        if self.run.args.trace:
            self.assembly_s = []
            with self._assembly(timed=self.assembly_s):
                self._loop(units, self.window_pairs)
        else:
            self._loop(units, self.window_pairs)

    def end_to_end(self, wall: float, units: int) -> dict:
        acc, layers = self.conf["accum_iter"], self.mcfg.n_layers
        want = (units * acc * layers * 2, units * acc * layers)
        got = (self.k1.launches - self.k1_before[0],
               self.k1_bwd.launches - self.k1_before[1])
        if self.run.device == "cuda" and got != want:
            raise RuntimeError(f"K1 forward/backward launched {got} times "
                               f"in the window, expected {want}")
        return {"train_tokens_per_s":
                units * self.group * self.L / wall}

    def work(self, units: int) -> dict:
        B, acc = self.conf["batch_size"], self.conf["accum_iter"]
        calls = units * acc * self.mcfg.n_layers
        shape = {"B": B, "L": self.L, "Lq": self.L, "bias": True}
        return {"model": self.conf, "assembly_s": self.assembly_s,
                "train": {"steps": units, "microbatches": acc, "rows": B,
                          "L": self.L, "remat": True},
                "attention": [{**shape, "count": 2 * calls, "bwd": False},
                              {**shape, "count": calls, "bwd": True}]}

    def release(self):
        del self.state, self.step, self.models, self.window_pairs

    def reference(self, mm=None, micro=None) -> TR.Readings:
        rc = self.conf["recipe"]

        def loss(params, batch, mm, micro):
            return RT.m_loss_and_grads(params, self.conf, batch,
                                       self.conf["accum_iter"], mm, micro)

        return TR.reference_run(
            self._params, self.batches, loss, rc,
            RT.warmup_cosine(rc["lr"], rc["warmup_steps"],
                             rc["total_steps"]), mm, micro)

    def assembly_readings(self, control: bool = False) -> dict:
        """The assembled batches' image codes against the reference
        encoder's latents (``vq_bit_gap``: the widest ``|z|`` of a channel
        whose sign a code's bit contradicts; with ``control``, the same of
        TF32 codes), and each row's masked image tokens against
        ``round(N cos(pi/2 max(cos(pi/2 t), eps)))``."""
        c = self.conf
        n, msl, off = c["num_vq_tokens"], c["max_seq_length"], \
            c["tokens"]["vq_offset"]
        zc, eps = c["vq"]["z_channels"], c["recipe"]["min_masking_rate"]
        out = {"vq_bit_gap": 0.0, "image_mask_miscount": 0.0}
        if control:
            out["control.vq_bit_gap"] = 0.0
        for (ids, labels, mask, t), pairs in zip(self.batches, self.pairs):
            L = ids.shape[1]
            lo, hi = L - msl - n - 1, L - msl - 1
            img = ids[:, lo:hi]
            codes_out = torch.where(img == c["tokens"]["mask"],
                                    labels[:, lo:hi], img) - off
            codes_in = ids[:, 2:2 + n] - off
            kept_in = (ids[:, 2:2 + n] != 0).all(-1)     # image not dropped
            for side, codes in (("pixels_out", codes_out),
                                ("pixels_in", codes_in)):
                px = torch.as_tensor(np.concatenate(
                    [p[side] for p in pairs]), device=ids.device)
                with torch.no_grad():
                    lat = RM.encode_latents(self.vparams, c["vq"], px)
                    rows = (torch.ones_like(kept_in) if side == "pixels_out"
                            else kept_in)
                    out["vq_bit_gap"] = max(out["vq_bit_gap"], RM.bit_gap(
                        lat[rows], codes[rows]))
                    if control:
                        with lowp.tf32():
                            clat = RM.encode_latents(self.vparams, c["vq"],
                                                     px)
                        ccodes = ((clat > 0).long() << torch.arange(
                            zc - 1, -1, -1, device=px.device)).sum(-1)
                        out["control.vq_bit_gap"] = max(
                            out["control.vq_bit_gap"], RM.bit_gap(lat, ccodes))
            for r in range(ids.shape[0]):
                masked = int((labels[r, lo:hi] != -100).sum())
                tt = float(t[r])
                want = set()
                for prob in (math.cos(max(math.cos(tt * math.pi / 2), eps)
                                      * math.pi / 2),
                             float(np.cos(np.float32(max(np.cos(np.float32(
                                 tt) * np.float32(math.pi / 2)), eps))
                                 * np.float32(math.pi / 2)))):
                    want.add(max(round(n * prob), 1))
                    want.add(max(int(np.round(np.float32(n * prob))), 1))
                out["image_mask_miscount"] += float(masked not in want)
        return out

    def check(self) -> list:
        ref = self.reference()
        run_log(f"reference losses {ref.losses}; program "
                f"{self.readings.losses}")
        r = {**TR.compare(self.readings, ref), **self.assembly_readings()}
        return [(k, r[k], self.run.limits[k]) for k in
                sorted(self.run.limits)]


def calibrate(run, control: bool) -> dict:
    d = MDriver(run)
    d.warm_up()
    d.window_pairs = None
    d.release()
    out = d.assembly_readings(control)
    if not control:
        return {**out, **TR.compare(d.readings, d.reference())}
    return {**out, **TR.calibration(d.readings, d.reference,
                                    range(d.conf["accum_iter"] // 2))}


def setup(run) -> MDriver:
    return MDriver(run)
