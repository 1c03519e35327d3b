"""What the training cells share: the program's readings of its first
steps, the reference's steps on the same rows, and the comparison.

The program's readings (``Readings``): each compared step's loss, the
first gradient as the optimizer got it (AdamW's first moment after one
step, over ``1 - b1``) and the parameters' change after the compared
steps, by leaf.  The reference makes the same parameters from the seed and
follows the same steps on the same rows in f32.
"""

from __future__ import annotations

import dataclasses

from benchmark.reference import llada as R
from benchmark.reference import train as RT

WARM_STEPS = 3          # the set-up's steps; the reference follows
COMPARED = 2            # the first two


@dataclasses.dataclass
class Readings:
    losses: list
    grads: dict          # leaf -> norm of the first gradient
    change: dict         # leaf -> norm of the change after COMPARED steps


def moment_norms(opt_state, b1: float) -> dict:
    """The first gradient by leaf, from AdamW's first moment after one
    step: ``mu = (1 - b1) g``."""
    return {n: float(t.double().norm()) / (1 - b1)
            for n, t in RT.leaves(opt_state["mu"])}


def change_norms(params, params0) -> dict:
    """``|p - p0|`` by leaf; ``params0`` is consumed leaf by leaf."""
    p0 = dict(RT.leaves(params0))
    return {n: float((p.detach() - p0.pop(n)).double().norm())
            for n, p in RT.leaves(params)}


def reference_run(make_params, batches, loss_fn, recipe: dict, lr_fn,
                  mm=None, micro=None) -> Readings:
    """The reference's steps on ``batches`` from ``make_params()``, with
    AdamW at ``recipe``'s betas, eps, weight decay and clip and the
    learning rate ``lr_fn(step)``: ``loss_fn(params, batch, mm, micro)``
    sets the gradients and returns the loss.  ``mm`` and ``micro`` (the
    microbatches kept) put the control or a fault in the program's
    place."""
    mm = mm or R.f32_mm
    params = make_params()
    p0 = {n: p.detach().clone() for n, p in RT.leaves(params)}
    opt = RT.AdamW(params, lr_fn, recipe["b1"], recipe["b2"], recipe["eps"],
                   recipe["weight_decay"], recipe["clip"])
    losses, grads = [], None
    for batch in batches:
        losses.append(loss_fn(params, batch, mm, micro))
        norms = opt.step(params)
        grads = grads or norms
    return Readings(losses, grads, change_norms(params, p0))


def compare(prog: Readings, ref: Readings) -> dict:
    """The loss's widest relative gap over the steps, and, by the worst
    leaf, the gap between the two sides' norms of the first gradient and
    of the change, each over the larger of the reference's norm of that
    leaf and of the median leaf.  Leaves whose reference gradient is under
    a thousandth of the median leaf's are left out of the change (they
    move by round-off alone)."""
    def worst(a, b, names):
        med = sorted(b[n] for n in names)[len(names) // 2]
        return max(abs(a[n] - b[n]) / max(b[n], med, 1e-30) for n in names)

    names = list(ref.grads)
    med = sorted(ref.grads.values())[len(names) // 2]
    moved = [n for n in names if ref.grads[n] >= 1e-3 * med]
    return {"loss_rel_gap": max(abs(a - b) / abs(b) for a, b in
                                zip(prog.losses, ref.losses)),
            "grad_norm_gap": worst(prog.grads, ref.grads, names),
            "change_norm_gap": worst(prog.change, ref.change, moved)}


def calibration(prog: Readings, run_ref, half) -> dict:
    """The check's readings, and the control's (the reference with fp8
    products in the program's place) and the fault's of half of the batch
    left out (the reference on ``half`` of the microbatches, the mean over
    them), each against the f32 reference.  ``run_ref(mm, micro)``."""
    from benchmark.reference import lowp
    ref = run_ref(R.f32_mm, None)
    out = compare(prog, ref)
    for name, mm, micro in (("control", lowp.fp8_mm, None),
                            ("half_batch", R.f32_mm, half)):
        got = compare(run_ref(mm, micro), ref)
        out.update({f"{name}.{k}": v for k, v in got.items()})
    return out
