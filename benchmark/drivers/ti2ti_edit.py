"""Variant-A exact edits through ``pipeline.TI2TIPipeline.__call__``, one
after another (a closed loop with one client): tokenize, Amused-VQ
encode, the whole trajectory, text decode and Amused-VQ decode.

Traffic parameters (``benchmark/traffic/<name>.json``): the image size,
``text_gen_length``, the sampler options, ``image_temperatures`` (cycled
over the edits; the greedy ones, at 0, are those the check can judge
token by token), the prompts each edit draws one of, and ``check`` (how
many steps of one greedy edit the reference replays).

The check replays steps of one greedy edit of the window, drawn from the
seed: the ids that entered each forward are recorded (the sampler's
backbone is wrapped for the run), and the reference runs the conditional
and image-unconditional forwards of the chosen steps in f32 on those ids.
It reads the widest gap by which a served text or image token's logit lies
below the reference's best at its position, checks that each step
committed as many text slots and kept as many image codes as the schedule
says, that the first forward's image span holds the reference encoder's
nearest codes, and that the decoded pixels are the reference decoder's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from benchmark.harness import inputs, port, weights
from benchmark.reference import amused_vq as RV
from benchmark.reference import llada as R
from benchmark.reference import lowp
from benchmark.reference import ti2ti as RT


def program_configs(conf: dict):
    from mmada_parallel_torch.models.amused_vq import AmusedVQConfig
    vq = dict(conf["vq"])
    vq["block_out_channels"] = tuple(vq["block_out_channels"])
    return (port.llada_config(conf, conf["dtype"], conf["dtype"]),
            AmusedVQConfig(**vq), port.DTYPES[conf["dtype"]])


class Recorder:
    """Wraps the sampler's backbone: each forward's input ids are kept
    (a 2424-id copy on the device, a few kB) in ``self.calls`` while
    ``self.calls`` is a list."""

    def __init__(self):
        from mmada_parallel_torch.samplers import parallel_ti2ti as P
        self.module, self.real = P, P.llada_hidden
        self.calls = None

        def hidden(params, cfg, ids, *rest, **kw):
            if self.calls is not None:
                self.calls.append(ids.clone())
            return self.real(params, cfg, ids, *rest, **kw)

        P.llada_hidden = hidden

    def restore(self):
        self.module.llada_hidden = self.real


@dataclasses.dataclass
class Request:
    prompt: str
    image: np.ndarray
    temperature: float
    seed: int


class EditDriver:
    def __init__(self, run):
        from mmada_parallel_torch.ops.rope_attention import \
            flash_attention_rope
        from mmada_parallel_torch.pipeline import TI2TIPipeline
        from mmada_parallel_torch.samplers.parallel_ti2ti import \
            TI2TIOptions
        self.run, self.conf, self.tr = run, run.config, run.traffic
        self.k1 = flash_attention_rope
        t = time.time()
        self.lcfg, self.vcfg, dt = program_configs(self.conf)
        gen = torch.Generator(device=run.device).manual_seed(run.seed)
        self.params = weights.llada_params(self.conf, gen, dt)
        self.vparams = weights.amused_vq_params(self.conf["vq"], gen)
        self.tok = inputs.StandInTokenizer(self.conf["tokens"])
        self.pipe = TI2TIPipeline(self.lcfg, self.params, self.vcfg,
                                  self.vparams, self.tok)
        self.opts = {temp: TI2TIOptions(
            **{**self.tr["options"], "temperature": temp,
               "codebook_size": self.conf["vq"]["num_vq_embeddings"],
               "mask_token": self.conf["tokens"]["mask"],
               "text_vocab_size": self.conf["tokens"]["text_vocab_size"]})
            for temp in self.tr["image_temperatures"]}
        self.rng = np.random.default_rng(run.seed)
        self.recorder = Recorder()
        self.requests, self.outputs, self.records = [], [], []
        self._sync()
        run_log(f"weights made on the device in {time.time() - t:.3f} s "
                f"({weights.tree_bytes(self.params) / 2 ** 30:.3f} GiB "
                f"LLaDA, {weights.tree_bytes(self.vparams) / 2 ** 20:.1f} "
                f"MiB VQ)")

    def _sync(self):
        if self.run.device == "cuda":
            torch.cuda.synchronize()

    def _edit(self, req: Request, opts):
        size = self.tr["image_size"]
        return self.pipe(req.prompt, req.image, size, size, opts,
                         text_gen_length=self.tr["text_gen_length"],
                         seed=req.seed)

    def _request(self, i: int) -> Request:
        temps = self.tr["image_temperatures"]
        return Request(
            prompt=self.tr["prompts"][int(self.rng.integers(
                len(self.tr["prompts"])))],
            image=inputs.image(self.rng, self.tr["image_size"]),
            temperature=temps[i % len(temps)],
            seed=int(self.rng.integers(1, 2 ** 31)))

    def warm_up(self):
        """Every shape the window uses (each image temperature), on short
        trajectories; then two timed short edits give the seconds a
        forward takes and the rest of an edit."""
        t = time.time()
        probe_rng = np.random.default_rng([self.run.seed, 1])
        req = Request(self.tr["prompts"][0],
                      inputs.image(probe_rng, self.tr["image_size"]), 0.0, 1)
        temps = self.tr["image_temperatures"]

        def short(temp, steps):
            opts = dataclasses.replace(self.opts[temp], text_steps=steps,
                                       timesteps=steps // 2)
            self._sync()
            t1 = time.time()
            self._edit(dataclasses.replace(req, temperature=temp), opts)
            self._sync()
            return time.time() - t1

        for temp in temps:
            short(temp, 2)
        times = {steps: short(temps[0], steps) for steps in (2, 8)}
        n2, n8 = 2 + 1, 8 + 4
        per_fwd = max((times[8] - times[2]) / (n8 - n2), 1e-6)
        fixed = max(times[2] - n2 * per_fwd, 0.0)
        o = self.opts[self.tr["image_temperatures"][0]]
        self.forwards = o.text_steps + len(RT.image_steps(o.text_steps,
                                                          o.timesteps))
        self.edit_estimate = fixed + self.forwards * per_fwd
        run_log(f"warm-up {time.time() - t:.3f} s: {per_fwd * 1e3:.2f} ms a "
                f"forward, {fixed:.3f} s the rest; an edit ~"
                f"{self.edit_estimate:.2f} s")

    def plan(self, seconds: float) -> int:
        self.warm_up()
        units = max(2, round(seconds / self.edit_estimate))
        self.requests = [self._request(i) for i in range(units)]
        self.k1_before = self.k1.launches
        return units

    def window(self, units: int):
        for i in range(units):
            self._one(i)

    def _one(self, i: int):
        req = self.requests[i]
        self.recorder.calls = []
        _, _, info = self._edit(req, self.opts[req.temperature])
        self.records.append(self.recorder.calls)
        self.recorder.calls = None
        self.outputs.append(info)

    def end_to_end(self, wall: float, units: int) -> dict:
        want = units * self.forwards * self.lcfg.n_layers
        got = self.k1.launches - self.k1_before
        if self.run.device == "cuda" and got != want:
            raise RuntimeError(f"K1 launched {got} times in the window, "
                               f"expected {want}: not the kernel path")
        return {"edit_s": wall / units}

    def work(self, units: int) -> dict:
        """The window's forwards by shape, for the per-layer readers."""
        lay = self.outputs[0]["layout"]
        o = self.opts[self.tr["image_temperatures"][0]]
        n_img = len(RT.image_steps(o.text_steps, o.timesteps))
        V, cb = self.conf["embedding_size"], o.codebook_size
        text, image = lay.text_end - lay.text_start, len(
            lay.image_positions())
        shape = {"B": 1, "L": lay.total_len}
        return {"model": self.conf, "forwards": [
            {**shape, "count": units * o.text_steps,
             "head": [[text, V], [image, cb]]},
            {**shape, "count": units * n_img, "head": [[image, cb]]}],
            "attention": [{**shape, "Lq": lay.total_len,
                           "count": units * self.forwards
                           * self.lcfg.n_layers, "bwd": False}]}

    def release(self):
        self.recorder.restore()
        del self.pipe
        greedy = [i for i, r in enumerate(self.requests)
                  if r.temperature == 0.0]
        if not greedy:
            raise RuntimeError("the window ran no greedy edit to check")
        pick = np.random.default_rng([self.run.seed, 2]).choice(greedy)
        self.checked = int(pick)
        self.records = {self.checked: self.records[self.checked]}

    def check(self) -> list:
        c = EditCheck(self, self.checked)
        readings = c.readings(R.f32_mm)
        return [(k, readings[k], self.run.limits[k]) for k in
                sorted(self.run.limits)]


class EditCheck:
    """The reference's view of one greedy edit of the window."""

    def __init__(self, d: EditDriver, k: int):
        self.d, self.k = d, k
        self.calls = d.records[k]
        self.req, self.out = d.requests[k], d.outputs[k]
        self.opts = d.opts[self.req.temperature]
        self.conf = d.conf
        tk = self.conf["tokens"]
        self.mask, self.tvs = tk["mask"], tk["text_vocab_size"]
        self.lay = self.out["layout"]
        self.img_pos = torch.as_tensor(self.lay.image_positions(),
                                       device=d.run.device)
        o = self.opts
        self.img_steps = RT.image_steps(o.text_steps, o.timesteps)
        # forward inputs of each step: cond, then uncond on image steps
        self.cond, self.uncond, j = {}, {}, 0
        for s in range(o.text_steps):
            self.cond[s] = self.calls[j][0]
            j += 1
            if s in self.img_steps:
                self.uncond[s] = self.calls[j][0]
                j += 1
        if j != len(self.calls):
            raise RuntimeError(f"{len(self.calls)} forwards recorded, the "
                               f"schedule has {j}")
        self.final = torch.as_tensor(self.out["ids"][0],
                                     device=d.run.device)
        ch = d.tr["check"]
        rng = np.random.default_rng([d.run.seed, 3])
        img = sorted(self.img_steps)
        mid = rng.choice(img[1:-1], ch["image_steps"] - 2, replace=False)
        txt = [s for s in range(o.text_steps) if s not in self.img_steps]
        self.steps = sorted({img[0], img[-1], *map(int, mid),
                             *map(int, rng.choice(txt, ch["text_steps"],
                                                  replace=False))})

    def _next(self, s):
        return self.cond[s + 1] if s + 1 in self.cond else self.final

    def _logits(self, ids, mm, text: bool):
        """Text-span logits (full vocab) and image-position codebook
        logits of one forward, f32."""
        P, cfg = self.d.params, self.conf
        h = R.hidden(P, cfg, ids[None], mm=mm)[0]
        ts, te = self.lay.text_start, self.lay.text_end
        cb = self.opts.codebook_size
        vq = R.head(P, h[self.img_pos], self.tvs, self.tvs + cb, mm=mm)
        txt = R.head(P, h[ts:te], mm=mm) if text else None
        return txt, vq

    def readings(self, mm, control_mm=None) -> dict:
        """The numbers the limits hold, and more the calibration reads:
        the widest gap of a served text token, the widest and the mean gap
        of a served image token, the miscounts.  With ``control_mm``, also
        the control's (``control.<name>``): at the same positions, the gap
        of the token that the lower precision puts first."""
        o = self.opts
        ts, te = self.lay.text_start, self.lay.text_end
        masked0 = int((self.cond[0][ts:te] == self.mask).sum())
        gaps = {"text": [], "image": []}
        ctl = {"text": [], "image": []}
        miss_t = miss_i = 0
        with torch.no_grad():
            for s in self.steps:
                cin, nxt = self.cond[s], self._next(s)
                txt, vq = self._logits(cin, mm, text=True)
                cm = cin[ts:te] == self.mask
                nm = nxt[ts:te] == self.mask
                com = cm & ~nm
                gaps["text"].append(RT.token_gaps(txt[com], nxt[ts:te][com]))
                budget = RT.text_budget(masked0, o.text_steps, s)
                n = int(com.sum())
                # a greedy token equal to the mask id leaves its slot masked
                allow = int((txt[cm & nm].argmax(-1) == self.mask).sum())
                miss_t += (n - budget if n >= budget
                           else max(0, budget - n - allow))
                if control_mm is not None:
                    ctxt, cvq = self._logits(cin, control_mm, text=True)
                    ctl["text"].append(RT.token_gaps(txt[com],
                                                     ctxt[com].argmax(-1)))
                if s not in self.img_steps:
                    continue
                uin = self.uncond[s]
                _, uvq = self._logits(uin, mm, text=False)
                logits = RT.cfg_logits(vq, uvq, o.cfg_img)
                unknown = uin[self.img_pos] == self.mask
                kept = unknown & (nxt[self.img_pos] != self.mask)
                if int(kept.sum()) not in RT.kept_counts(
                        len(self.img_pos), int(unknown.sum()), s,
                        o.text_steps):
                    miss_i += 1
                codes = nxt[self.img_pos][kept] - self.tvs
                gaps["image"].append(RT.token_gaps(logits[kept], codes))
                if control_mm is not None:
                    _, cuvq = self._logits(uin, control_mm, text=False)
                    clog = RT.cfg_logits(cvq, cuvq, o.cfg_img)
                    ctl["image"].append(RT.token_gaps(
                        logits[kept], clog[kept].argmax(-1)))
        out = {"text_commit_miscount": float(miss_t),
               "image_keep_miscount": float(miss_i)}
        sides = [("", gaps)] + ([("control.", ctl)] if control_mm else [])
        zero = torch.zeros(1, device=self.final.device)
        for prefix, g in sides:
            # no served token (every count is then off): no gap to read
            t, i = (torch.cat(g[k] + [zero]) for k in ("text", "image"))
            out[prefix + "text_token_gap"] = float(t.max())
            out[prefix + "image_token_gap"] = float(i.max())
            out[prefix + "image_token_mean_gap"] = float(i[:-1].mean()) \
                if len(i) > 1 else 0.0
        out.update(self.vq_readings(control=control_mm is not None))
        run_log(f"check: edit {self.k}, steps {self.steps}: "
                f"{sum(map(len, gaps['text']))} text and "
                f"{sum(map(len, gaps['image']))} image tokens served")
        return out

    def vq_readings(self, control: bool = False) -> dict:
        """The encoder's codes in the first forward's image span against
        the reference's nearest, and the decoded pixels against the
        reference decoder's."""
        vp, vc = self.d.vparams, self.conf["vq"]
        size = self.d.tr["image_size"]
        g = size // 2 ** (len(vc["block_out_channels"]) - 1)
        # the cond prompt is prompt[:-1] + [boi] + g rows of (g codes and a
        # newline) + [eoi] + prompt[-1:]; the stand-in's prompt has body + 2
        start = self.conf["tokens"]["body"] + 2
        grid = self.cond[0][start:start + g * (g + 1)].reshape(g, g + 1)
        codes = (grid[:, :g].reshape(-1) - self.tvs).long()
        px = torch.as_tensor(self.req.image, device=self.d.run.device)
        px = px.float()[None] / 255.0

        def enc_gap(ctx):
            with ctx, torch.no_grad():
                lat = RV.encode_latents(vp, vc, px)
            dist = RV.code_distances(vp, lat)
            return dist, lat

        with torch.no_grad():
            dist, _ = enc_gap(contextlib.nullcontext())
            best = dist.min(dim=-1).values
            got = dist.gather(-1, codes.clamp(0, dist.shape[1] - 1)[:, None])
            out = {"vq_code_gap": float((got[:, 0] - best).max()),
                   "vq_code_flips": float((codes != dist.argmin(-1)).sum())}
            fin = torch.as_tensor(self.out["codes"], device=px.device)
            ref_px = RV.decode(vp, vc, fin, (g, g))[0]
            prog_px = torch.as_tensor(self.out["pixels"], device=px.device)
            out["vq_pixel_err"] = float((ref_px - prog_px).abs().max())
            if control:
                cdist, _ = enc_gap(lowp.tf32())
                ccodes = cdist.argmin(dim=-1)
                out["control.vq_code_gap"] = float(
                    (dist.gather(-1, ccodes[:, None])[:, 0] - best).max())
                out["control.vq_code_flips"] = float(
                    (ccodes != dist.argmin(-1)).sum())
                with lowp.tf32():
                    cpx = RV.decode(vp, vc, fin, (g, g))[0]
                out["control.vq_pixel_err"] = float(
                    (cpx - ref_px).abs().max())
        return out


def run_log(msg: str) -> None:
    from benchmark.harness.core import log
    log(f"[edit] {msg}")


def setup(run) -> EditDriver:
    return EditDriver(run)


def calibrate(run, control: bool) -> dict:
    """One greedy edit of the full trajectory from the seed, and the
    check's readings of it (and the control's, with ``control``)."""
    d = EditDriver(run)
    o = d.opts[0.0]
    d.forwards = o.text_steps + len(RT.image_steps(o.text_steps,
                                                   o.timesteps))
    d.requests = [dataclasses.replace(d._request(0), temperature=0.0)]
    d.k1_before = d.k1.launches
    d._one(0)
    d._sync()
    d.end_to_end(1.0, 1)
    d.release()
    return EditCheck(d, 0).readings(
        R.f32_mm, control_mm=lowp.fp8_mm if control else None)
