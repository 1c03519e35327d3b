"""SDAR-30B-A3B's block generation through
``samplers/mmu.mmu_generate_fast``, one batch after another (a closed loop
with one client): the prompts' prefill into the k/v cache (K4, the grouped
experts at ~4,000 rows an expert), then every block's denoising steps on
its positions against the cache (K2 on the folded GQA rows, the grouped
experts at ~4 rows an expert, the head) and its write forward.

Traffic parameters (``benchmark/traffic/<name>.json``): ``batch`` rows of
``prompt_len`` ids drawn from the seed, ``new_tokens`` in blocks of
``block_length`` (the configuration's), ``steps_per_block``, the sampler's
``temperature``, ``cfg_scale`` and ``remasking``.  A unit is one batch;
``edit_s`` is the window's wall over its units: what the batch's users
wait for their answers.

The check replays every step of the first and the last block of one row of
one unit, both drawn from the seed: the recorder keeps the ids that
entered each of those steps (the row's block), the row's logits there and
its top-k experts in every layer (the sampler's ``_block_step`` and
``ops/moe.route`` are wrapped for the run; the decode forwards run as CUDA
graphs, which the route wrapper's copy is captured into).  The reference
(``reference/sdar.py``) runs a full block-causal forward in f32 over the
row's ids up to the block's end, following the program's experts at a
near-tie (the 8th and 9th probabilities within ``route_tie`` of the
cell's file).  It reads the widest gap by which a committed token's logit
lies below the reference's best at its position, the widest |program -
reference| over the block's logits, the slots committed against the
schedule, and the routing choices that differ away from a near-tie.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from benchmark.harness import sdar as HS
from benchmark.harness import weights
from benchmark.reference import lowp
from benchmark.reference import sdar as RS


class Recorder:
    """Wraps ``samplers/mmu._block_step`` and ``ops/moe.route``.  The
    route wrapper copies every decode forward's top-k choices, all rows,
    into ``self.routes`` (``[n_layers, B, block, k]``), an op that a CUDA
    graph captures with the forward, so a replay refreshes the buffer too.
    While ``watch(row, blocks)`` is on, each step of those blocks appends
    ``{"block", "step", "ids", "logits", "routes"}`` for ``row`` to
    ``self.steps`` (copies on the device, no sync): the step function runs
    on the host for every step, graph or not."""

    def __init__(self, n_layers: int, B: int, bl: int, k: int, spb: int,
                 device):
        from mmada_parallel_torch.ops import moe as MO
        from mmada_parallel_torch.samplers import mmu as TM
        self.TM, self.MO, self.spb = TM, MO, spb
        self.real = (TM._block_step, MO.route)
        real_step, real_route = self.real
        self.routes = torch.zeros((n_layers, B, bl, k), dtype=torch.long,
                                  device=device)
        self.row = self.blocks = None
        self.layer, self.calls, self.steps = 0, 0, []

        def route(h, router, top_k, norm):
            w, ids = real_route(h, router, top_k, norm)
            if ids.shape[0] == B * bl:          # a decode forward's layer
                self.routes[self.layer].copy_(ids.view(B, bl, top_k))
                self.layer = (self.layer + 1) % n_layers
            return w, ids

        def block_step(dec, graphs, block, pos, hi, cache, i):
            watched = False
            if self.row is not None:
                b = self.calls // self.spb
                self.calls += 1
                watched = b in self.blocks
                cur = block[self.row].clone() if watched else None
            new, logits = real_step(dec, graphs, block, pos, hi, cache, i)
            if watched:
                self.steps.append({
                    "block": b, "step": i, "ids": cur,
                    "logits": logits[self.row].float().clone(),
                    "routes": list(self.routes[:, self.row].clone())})
            return new, logits

        TM._block_step, MO.route = block_step, route

    def watch(self, row, blocks):
        self.row, self.blocks = row, set(blocks)
        self.calls, self.steps = 0, []

    def stop(self):
        self.row = None

    def restore(self):
        self.TM._block_step, self.MO.route = self.real


class BlockDriver:
    def __init__(self, run):
        from mmada_parallel_torch.ops import moe as MO
        from mmada_parallel_torch.ops import rope_attention as RA
        from mmada_parallel_torch.samplers import mmu as TM
        self.run, self.conf, self.tr = run, run.config, run.traffic
        self.TM, self.MO, self.k4 = TM, MO, RA.flash_attention_rope_prefix
        t = time.time()
        self.cfg = HS.port_config(self.conf)
        tr = self.tr
        if tr["block_length"] != self.cfg.block_length:
            raise ValueError(f"the traffic's blocks of {tr['block_length']} "
                             f"are not the model's {self.cfg.block_length}")
        self.B, self.P, self.N = tr["batch"], tr["prompt_len"], \
            tr["new_tokens"]
        self.bl, self.spb = tr["block_length"], tr["steps_per_block"]
        self.blocks = self.N // self.bl
        self.opts = TM.MMUOptions(
            max_new_tokens=self.N, steps=self.blocks * self.spb,
            block_length=self.bl, temperature=tr["temperature"],
            cfg_scale=tr["cfg_scale"], remasking=tr["remasking"],
            mask_token=self.conf["tokens"]["mask"])
        gen = torch.Generator(device=run.device).manual_seed(run.seed)
        self.params = HS.sdar_params(self.conf, gen,
                                     HS.port.DTYPES[self.conf["dtype"]])
        self.rng = np.random.default_rng(run.seed)
        self.recorder = Recorder(self.cfg.n_layers, self.B, self.bl,
                                 self.cfg.experts_per_token, self.spb,
                                 run.device)
        # the decode forwards' CUDA graphs, captured in the warm-up and
        # replayed by every unit
        self.graphs = TM.DecodeGraphs()
        self.prompts, self.outputs = [], []
        self._sync()
        with open(os.path.join(run.root, "benchmark", "workloads",
                               run.cell["name"] + ".json")) as f:
            self.route_tie = json.load(f).get("route_tie", 0.0)
        run_log(f"weights made on the device in {time.time() - t:.3f} s "
                f"({weights.tree_bytes(self.params) / 2 ** 30:.3f} GiB)")

    def _sync(self):
        if self.run.device == "cuda":
            torch.cuda.synchronize()

    def _prompts(self, rng) -> torch.Tensor:
        tk = self.conf["tokens"]
        ids = rng.integers(tk["lo"], tk["hi"], (self.B, self.P))
        return torch.as_tensor(ids, device=self.run.device)

    def _generate(self, prompts, opts=None):
        return self.TM.mmu_generate_fast(
            self.params, self.cfg, prompts, opts or self.opts,
            eot_token=self.cfg.eos_token_id, graphs=self.graphs)

    def warm_up(self):
        """The window's shapes, on one whole unit from probe prompts: its
        time is the unit's estimate."""
        probe = self._prompts(np.random.default_rng([self.run.seed, 1]))
        self._sync()
        t = time.time()
        self._generate(probe)
        self._sync()
        self.unit_estimate = time.time() - t
        run_log(f"warm-up unit {self.unit_estimate:.3f} s "
                f"({self.forwards()} forwards)")

    def forwards(self) -> int:
        return 1 + self.blocks * (self.spb + 1)

    def plan(self, seconds: float) -> int:
        self.warm_up()
        units = max(2, round(seconds / self.unit_estimate))
        self.prompts = [self._prompts(self.rng) for _ in range(units)]
        pick = np.random.default_rng([self.run.seed, 2])
        self.checked = int(pick.integers(units))
        self.row = int(pick.integers(self.B))
        self._mark()
        return units

    def _mark(self):
        self.g_before = self.MO.grouped_gemm.launches
        self.k4_before = self.k4.launches
        self.r_before = self.graphs.replays

    def window(self, units: int):
        for i in range(units):
            self._one(i)

    def _one(self, i: int):
        if i == self.checked:
            self.recorder.watch(self.row, (0, self.blocks - 1))
        self.outputs.append(self._generate(self.prompts[i]))
        self.recorder.stop()

    def end_to_end(self, wall: float, units: int) -> dict:
        """On the card, the window's path: each unit's prefill launched K4
        once and the grouped kernel twice a layer, and every decode forward
        was a graph replay (a replay's launches are not counted on the
        host; the traced run's device trace holds them)."""
        L = self.cfg.n_layers
        want = {"grouped_gemm": units * 2 * L, "k4": units * L,
                "replays": units * self.blocks * (self.spb + 1)}
        got = {"grouped_gemm": self.MO.grouped_gemm.launches - self.g_before,
               "k4": self.k4.launches - self.k4_before,
               "replays": self.graphs.replays - self.r_before}
        if self.run.device == "cuda" and got != want:
            raise RuntimeError(f"launches and replays in the window {got}, "
                               f"expected {want}: not the kernel path")
        return {"edit_s": wall / units}

    def work(self, units: int) -> dict:
        """The window's forwards by shape (``harness/moe_counts.py``)."""
        B, P, bl = self.B, self.P, self.bl
        bounds = RS.block_bounds(P, P, bl)
        fwds = [{"count": units, "tokens": B * P,
                 "attended": B * int(bounds.sum()), "cache_rows": 0,
                 "head_rows": 0, "prefill": True}]
        for b in range(self.blocks):
            end = P + (b + 1) * bl
            step = {"tokens": B * bl, "attended": B * bl * end,
                    "cache_rows": B * end, "prefill": False}
            fwds.append({**step, "count": units * self.spb,
                         "head_rows": B * bl})
            fwds.append({**step, "count": units, "head_rows": 0})
        return {"model": self.conf, "sdar_forwards": fwds}

    def release(self):
        self.recorder.restore()
        self.out = self.outputs[self.checked][self.row]
        self.steps = self.recorder.steps
        self.outputs = self.prompts = None

    def check(self) -> list:
        readings = SDARCheck(self).readings(RS.f32_mm, tie=self.route_tie)
        return [(k, readings[k], self.run.limits[k]) for k in
                sorted(self.run.limits)]


class SDARCheck:
    """The reference's view of the recorded steps of one row."""

    def __init__(self, d: BlockDriver):
        self.d = d
        self.mask = d.conf["tokens"]["mask"]
        if len(d.steps) != 2 * d.spb or any(
                s["logits"] is None
                or len(s["routes"]) != d.cfg.n_layers for s in d.steps):
            raise RuntimeError(f"{len(d.steps)} steps recorded, expected "
                               f"{2 * d.spb} with logits and routes")
        self.budgets = d.TM._Decoder(
            d.params, d.cfg, d.out[None, :d.P], d.opts, None, None).budgets

    def _next(self, j: int):
        """The block's ids after step ``j``: the next recorded step's, or
        the finished row's."""
        s = self.d.steps[j]
        if j + 1 < len(self.d.steps) and \
                self.d.steps[j + 1]["block"] == s["block"]:
            return self.d.steps[j + 1]["ids"]
        bs = self.d.P + s["block"] * self.d.bl
        return self.d.out[bs:bs + self.d.bl]

    def readings(self, mm, tie: float, control_mm=None) -> dict:
        """The numbers the limits hold, and more the calibration reads
        (``route_flip_gap``: the widest 8th-to-9th gap where a choice
        differs, ``route_gaps`` all of them; with ``control_mm`` the
        control's, ``control.<name>``)."""
        d, P, bl = self.d, self.d.P, self.d.bl
        gaps, errs, miss, flips, fgaps = [], [], 0, 0, []
        ctl = {"gaps": [], "errs": [], "flips": 0, "fgaps": []}
        zero = torch.zeros(1, device=d.out.device)
        with torch.no_grad():
            for j, s in enumerate(d.steps):
                bs = P + s["block"] * bl
                x = d.out.clone()
                x[bs:bs + bl] = s["ids"]
                x = x[:bs + bl]
                watch = torch.arange(bs, bs + bl, device=x.device)
                h, info = RS.hidden(d.params, d.conf, x, P, bl, mm,
                                    s["routes"], watch, tie)
                ref = RS.head(d.params, h[bs:], mm)
                prog = s["logits"].float()
                errs.append(float((prog - ref).abs().max()))
                flips += sum(i["flips"] for i in info)
                fgaps += [i["gaps"] for i in info]
                cur, nxt = s["ids"], self._next(j)
                com = (cur == self.mask) & (nxt != self.mask)
                gaps.append(ref[com].max(-1).values - ref[com].gather(
                    -1, nxt[com][:, None])[:, 0])
                n, budget = int(com.sum()), int(self.budgets[s["step"]])
                left = (cur == self.mask) & (nxt == self.mask)
                allow = int((prog[left].argmax(-1) == self.mask).sum())
                miss += (n - budget if n >= budget
                         else max(0, budget - n - allow))
                if control_mm is None:
                    continue
                hc, cinfo = RS.hidden(d.params, d.conf, x, P, bl,
                                      control_mm, None, watch)
                cl = RS.head(d.params, hc[bs:], control_mm)
                ctl["errs"].append(float((cl - ref).abs().max()))
                ctl["gaps"].append(ref[com].max(-1).values - ref[com].gather(
                    -1, cl[com].argmax(-1)[:, None])[:, 0])
                _, rinfo = RS.hidden(d.params, d.conf, x, P, bl, mm,
                                     [i["experts"] for i in cinfo], watch,
                                     tie)
                ctl["flips"] += sum(i["flips"] for i in rinfo)
                ctl["fgaps"] += [i["gaps"] for i in rinfo]
        out = {"commit_miscount": float(miss)}
        sides = [("", gaps, errs, flips, fgaps)]
        if control_mm is not None:
            sides.append(("control.", ctl["gaps"], ctl["errs"],
                          ctl["flips"], ctl["fgaps"]))
        for prefix, g, e, f, fg in sides:
            out[prefix + "text_token_gap"] = float(torch.cat(g + [zero]).max())
            out[prefix + "block_logit_err"] = max(e)
            out[prefix + "route_miscount"] = float(f)
            out[prefix + "route_flip_gap"] = float(torch.cat(fg + [zero])
                                                   .max())
            out[prefix + "route_flips"] = float(sum(len(t) for t in fg))
            out[prefix + "route_gaps"] = sorted(
                round(float(x), 7) for x in torch.cat(fg + [zero[:0]]))
        run_log(f"check: unit {d.checked}, row {d.row}, blocks 0 and "
                f"{d.blocks - 1}: {len(d.steps)} steps, "
                f"{sum(len(t) for t in gaps)} tokens committed")
        return out


def run_log(msg: str) -> None:
    from benchmark.harness.core import log
    log(f"[blockgen] {msg}")


def setup(run) -> BlockDriver:
    return BlockDriver(run)


def calibrate(run, control: bool) -> dict:
    """One unit from the seed, recorded as the window's checked unit, and
    the check's readings under the cell's ``route_tie`` with every
    differing choice's gap (``route_gaps``), and the control's with
    ``control``."""
    d = BlockDriver(run)
    d.warm_up()                 # captures the decode graphs
    d.prompts = [d._prompts(d.rng)]
    pick = np.random.default_rng([run.seed, 2])
    d.checked, d.row = 0, int(pick.integers(d.B))
    d._mark()
    d._one(0)
    d._sync()
    d.end_to_end(1.0, 1)
    d.release()
    return SDARCheck(d).readings(RS.f32_mm, tie=d.route_tie,
                                 control_mm=lowp.fp8_mm if control else None)
