"""Variant-A edits on the feature-cached path: ``a-edit``'s exact edits
with ``use_cache=True`` through ``pipeline.TI2TIPipeline.__call__``, one
after another from one client.  The sampler is
``samplers/parallel_ti2ti.generate_ti2ti_cached``: its refresh steps run a
full forward that rebuilds the per-layer k/v cache
(``llada_hidden_with_cache``, K2 over every position), its other steps a
partial forward of a few text slots against the cache
(``llada_hidden_partial``, K2 at a few query rows); the image-unconditional
forwards stay exact (K1).

Traffic parameters: ``a-edit``'s (``drivers/ti2ti_edit.py``) and the
cache's ``cache_ratio``, ``refresh_interval`` and ``warmup_ratio``, which
the pipeline passes as the sampler's defaults (checked at set-up).

The check is ``a-edit``'s, on the cached trajectory: the recorder keeps
the ids entering each step's text update (the sampler's ``_text_update``
is wrapped), the image-unconditional forwards' ids, which steps refreshed
and each partial step's selected ids and positions.  The reference
(``reference/cache.py``) replays whole refresh intervals in f32: the full
forward that built the cache, then each partial step's scatter and
attention in order, its logits scattered into the refresh's text logits as
the sampler does, so every served token is judged against the logits the
sampler had.
"""

from __future__ import annotations

import dataclasses
import inspect
import math

import numpy as np

from benchmark.drivers import ti2ti_edit as TE
from benchmark.reference import cache as RC
from benchmark.reference import llada as R
from benchmark.reference import lowp
from benchmark.reference import ti2ti as RT

CACHE_KEYS = ("cache_ratio", "refresh_interval", "warmup_ratio")


class CachedRecorder:
    """Wraps ``samplers/parallel_ti2ti``'s ``_text_update``, ``_uncond_vq``
    (through its ``hidden_fn``), ``llada_hidden_with_cache`` and
    ``llada_hidden_partial``.  While ``self.calls`` is a list it gets, in
    ``EditCheck``'s order, the ids entering each step's text update and
    each unconditional forward's ids; ``self.kinds`` one entry a step:
    ``None`` for a refresh, ``(sel_ids, sel_pos)`` for a partial step."""

    def __init__(self):
        from mmada_parallel_torch.samplers import parallel_ti2ti as P
        self.P = P
        names = ("_text_update", "_uncond_vq", "llada_hidden_with_cache",
                 "llada_hidden_partial")
        self.real = {n: getattr(P, n) for n in names}
        self.calls = self.kinds = None
        self.pending = None

        def text_update(ids, *a, **kw):
            if self.calls is not None:
                self.calls.append(ids.clone())
                self.kinds.append(self.pending)
            return self.real["_text_update"](ids, *a, **kw)

        def uncond_vq(*a, **kw):
            if self.calls is not None:
                fn = kw.get("hidden_fn", P.llada_hidden)

                def hidden(params, cfg, ids, *b, **k):
                    self.calls.append(ids.clone())
                    return fn(params, cfg, ids, *b, **k)
                kw["hidden_fn"] = hidden
            return self.real["_uncond_vq"](*a, **kw)

        def with_cache(params, cfg, ids, *a, **kw):
            self.pending = None
            return self.real["llada_hidden_with_cache"](params, cfg, ids, *a,
                                                        **kw)

        def partial(params, cfg, sel_ids, sel_pos, cache, *a, **kw):
            if self.calls is not None:
                self.pending = (sel_ids[0].clone(), sel_pos[0].clone())
            return self.real["llada_hidden_partial"](params, cfg, sel_ids,
                                                     sel_pos, cache, *a, **kw)

        P._text_update, P._uncond_vq = text_update, uncond_vq
        P.llada_hidden_with_cache, P.llada_hidden_partial = with_cache, \
            partial

    def restore(self):
        for n, f in self.real.items():
            setattr(self.P, n, f)


class CachedEditDriver(TE.EditDriver):
    def __init__(self, run):
        from mmada_parallel_torch.ops.rope_attention import \
            flash_attention_rope_qonly
        from mmada_parallel_torch.samplers import parallel_ti2ti as P
        super().__init__(run)
        defaults = inspect.signature(P.generate_ti2ti_cached).parameters
        for k in CACHE_KEYS:
            if self.tr[k] != defaults[k].default:
                raise ValueError(f"the traffic's {k} {self.tr[k]} is not "
                                 f"the pipeline's {defaults[k].default}")
        self.k2 = flash_attention_rope_qonly
        self.recorder.restore()
        self.recorder = CachedRecorder()
        self.kinds = []
        o = self.opts[self.tr["image_temperatures"][0]]
        self.refresh = P.cached_refresh_schedule(
            o.text_steps, o.timesteps, self.tr["refresh_interval"],
            self.tr["warmup_ratio"])

    def _edit(self, req: TE.Request, opts):
        size = self.tr["image_size"]
        return self.pipe(req.prompt, req.image, size, size, opts,
                         text_gen_length=self.tr["text_gen_length"],
                         seed=req.seed, use_cache=self.tr["use_cache"])

    def plan(self, seconds: float) -> int:
        units = super().plan(seconds)
        self.k2_before = self.k2.launches
        return units

    def _one(self, i: int):
        self.recorder.kinds = []
        super()._one(i)
        self.kinds.append(self.recorder.kinds)
        self.recorder.kinds = None

    def _steps(self):
        o = self.opts[self.tr["image_temperatures"][0]]
        n_img = len(RT.image_steps(o.text_steps, o.timesteps))
        n_ref = int(self.refresh.sum())
        return o, n_img, n_ref, o.text_steps - n_ref

    def end_to_end(self, wall: float, units: int) -> dict:
        o, n_img, _, _ = self._steps()
        L = self.lcfg.n_layers
        want = {"k2": units * o.text_steps * L, "k1": units * n_img * L}
        got = {"k2": self.k2.launches - self.k2_before,
               "k1": self.k1.launches - self.k1_before}
        if self.run.device == "cuda" and got != want:
            raise RuntimeError(f"launches in the window {got}, expected "
                               f"{want}: not the kernel path")
        return {"edit_s": wall / units}

    def n_sel(self, text_len: int) -> int:
        """The slots a partial step recomputes (the sampler's count)."""
        o = self.opts[self.tr["image_temperatures"][0]]
        return min(math.ceil(text_len / o.text_steps) + 1 + max(
            math.ceil((1.0 - self.tr["cache_ratio"]) * text_len), 1),
            text_len)

    def work(self, units: int) -> dict:
        """The window's forwards by shape: refreshes and unconditional
        forwards over the whole sequence, partial forwards over their
        selected positions (their attention counted as selected x
        selected, a lower bound); K2's calls at ``Lq`` = selected, ``L``
        = the whole sequence."""
        lay = self.outputs[0]["layout"]
        o, n_img, n_ref, n_part = self._steps()
        V, cb = self.conf["embedding_size"], o.codebook_size
        text, image = lay.text_end - lay.text_start, len(
            lay.image_positions())
        L, sel, layers = lay.total_len, self.n_sel(text), self.lcfg.n_layers
        full = {"B": 1, "L": L}
        forwards = [{**full, "count": units * n_ref,
                     "head": [[text, V], [image, cb]]},
                    {**full, "count": units * n_img, "head": [[image, cb]]}]
        attention = [{**full, "Lq": L, "count": units * (n_ref + n_img)
                      * layers, "bwd": False}]
        if n_part:
            forwards.append({"B": 1, "L": sel, "count": units * n_part,
                             "head": [[sel, V]]})
            attention.append({**full, "Lq": sel, "count": units * n_part
                              * layers, "bwd": False})
        return {"model": self.conf, "forwards": forwards,
                "attention": attention}

    def release(self):
        super().release()
        self.kinds = {self.checked: self.kinds[self.checked]}

    def check(self) -> list:
        c = CachedEditCheck(self, self.checked)
        readings = c.readings(R.f32_mm)
        return [(k, readings[k], self.run.limits[k]) for k in
                sorted(self.run.limits)]


class CachedEditCheck(TE.EditCheck):
    """``a-edit``'s check of one greedy cached edit: the steps it picks,
    widened to their whole refresh intervals, each step's text logits
    replayed from its interval's refresh (``_logits``)."""

    def __init__(self, d: CachedEditDriver, k: int):
        super().__init__(d, k)
        self.kinds = d.kinds[k]
        if len(self.kinds) != d.opts[0.0].text_steps or any(
                (kind is None) != bool(d.refresh[s])
                for s, kind in enumerate(self.kinds)):
            raise RuntimeError("the recorded refreshes are not the "
                               "sampler's schedule")
        self.step_of = {id(self.cond[s]): s for s in self.cond}
        refresh = [s for s, kind in enumerate(self.kinds) if kind is None]
        partial = [s for s, kind in enumerate(self.kinds) if kind is not None]
        if partial:     # one interval with partial steps, drawn from the seed
            rng = np.random.default_rng([d.run.seed, 4])
            self.steps = sorted({*self.steps, int(rng.choice(partial))})
        wide = set()
        for s in self.steps:
            r = max(t for t in refresh if t <= s)
            nxt = [t for t in refresh if t > s]
            wide.update(range(r, nxt[0] if nxt else len(self.kinds)))
        self.steps = sorted(wide)
        self.state = None
        ts, te = self.lay.text_start, self.lay.text_end
        self.text_slice = slice(ts, te)

    def _replay(self, s: int, mm):
        """The sampler's text logits at step ``s`` (and the image logits of
        the last refresh): a full forward at the interval's refresh, then
        each partial step up to ``s``, its logits scattered in."""
        P, cfg = self.d.params, self.conf
        st = self.state
        if st is None or st["mm"] is not mm or st["step"] > s or any(
                self.kinds[t] is None for t in range(st["step"] + 1, s + 1)):
            r = max(t for t in range(s + 1) if self.kinds[t] is None)
            h, cache = RC.build(P, cfg, self.cond[r], mm)
            tvs, cb = self.tvs, self.opts.codebook_size
            st = self.state = {
                "mm": mm, "step": r, "cache": cache,
                "text": R.head(P, h[self.text_slice], mm=mm),
                "vq": R.head(P, h[self.img_pos], tvs, tvs + cb, mm=mm)}
        for t in range(st["step"] + 1, s + 1):
            sel_ids, sel_pos = self.kinds[t]
            h = RC.partial(P, cfg, st["cache"], sel_ids, sel_pos, mm)
            st["text"][sel_pos - self.lay.text_start] = R.head(P, h, mm=mm)
        st["step"] = s
        return st["text"].clone(), st["vq"]

    def _logits(self, ids, mm, text: bool):
        s = self.step_of.get(id(ids))
        if s is None or not text:
            return super()._logits(ids, mm, text)
        return self._replay(s, mm)


def setup(run) -> CachedEditDriver:
    return CachedEditDriver(run)


def calibrate(run, control: bool) -> dict:
    """One greedy cached edit of the full trajectory from the seed, and
    the check's readings of it (and the control's, with ``control``)."""
    d = CachedEditDriver(run)
    d.requests = [dataclasses.replace(d._request(0), temperature=0.0)]
    d.k1_before, d.k2_before = d.k1.launches, d.k2.launches
    d._one(0)
    d._sync()
    d.end_to_end(1.0, 1)
    d.release()
    return CachedEditCheck(d, 0).readings(
        R.f32_mm, control_mm=lowp.fp8_mm if control else None)
