"""Training steps: the port's compiled train step (``make_train_fn``, the
step ``launch/train.py``'s ``train_loop`` runs) on batches the benchmark
draws from the seed on the host, each between two steps.

Traffic parameters (``traffic/<mix>.json``): ``batch``, ``seq``; ``train``,
the ``TrainConfig`` fields the step is made with; ``optimizer``, AdamW's
constants and the schedule's floor as the reference applies them;
``trace_s``.

Set-up makes the weights, the port's zero state and the step, and drives
that one step object through its first three steps (the first captures its
graph); the window then goes on with the same object.  End-to-end:
``train_tokens_per_s``, the tokens of all whole steps in the window over
the time from the synchronisation before its first step to the one after
its last.

``correct``: the reference (``reference/train.py`` over the
configuration's reference module, ``cell.reference``) follows the first
three steps from the same weights and batches.  Compared are
each step's loss (``loss_rel``: the largest relative gap), the norm of each
leaf's first gradient as the optimizer got it, read from its first moment
after one step (``grad_gap``), and the norm of each leaf's change after
the three steps (``change_gap``), each by the worst leaf: the gap between
the two norms over the reference's norm of that leaf or of the median
leaf, whichever is larger.  Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the change.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import weights
from portbench.reference import decoder
from portbench.reference import train as reference
from portbench.tracing import span

CHECKED_STEPS = 3


def batches(run):
    """``draw(i)``: the i-th batch, tokens and labels (B, S) from one
    draw of (B, S + 1) ids, on the run's device."""
    tr, vocab = run.traffic, run.cfg["vocab_size"]

    def draw(i):
        ids = run.rng(f"batch-{i}").integers(
            0, vocab, size=(tr["batch"], tr["seq"] + 1), dtype=np.int64)
        t = torch.from_numpy(ids)
        return {"tokens": t[:, :-1].to(run.device),
                "labels": t[:, 1:].to(run.device)}
    return draw


def gap(program: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |program − reference| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    paths = [p for p in ref if keep is None or p in keep]
    med = float(np.median([ref[p] for p in paths]))
    return max(abs(program[p] - ref[p]) / max(ref[p], med) for p in paths)


def run(run, make_params) -> None:
    from repro_torch.train import step as TS
    tr = run.traffic
    tc = TS.TrainConfig(**tr["train"])
    draw = batches(run)
    params = make_params()
    start = {p: t.clone() for p, t in weights.leaves(params)}
    state = TS.init_state(run.arch, tc, params)
    step_fn = TS.make_train_fn(run.arch, tc)
    b1 = tr["optimizer"]["b1"]
    losses, first_grad = [], None
    for i in range(CHECKED_STEPS):
        params, state, m = step_fn(params, state, draw(i))
        losses.append(float(m["loss"]))
        if i == 0:
            first_grad = {p: float(t.norm()) / (1 - b1)
                          for p, t in weights.leaves(state["opt"]["mu"])}
    change = {p: float((t - start[p]).norm())
              for p, t in weights.leaves(params)}
    del start, m
    run.free()
    tokens = tr["batch"] * tr["seq"]
    host, k, traced_at = [], CHECKED_STEPS, None
    t0 = run.open_window()
    while time.monotonic() - t0 < run.seconds:
        run.tracer.tick()
        if traced_at is None and run.tracer.running:
            traced_at = k - CHECKED_STEPS
        with span("train.data"):
            batch = draw(k)
        with span("train.step"):
            t = time.monotonic()
            params, state, m = step_fn(params, state, batch)
            host.append(time.monotonic() - t)
        k += 1
    run.tracer.tick()
    run.sync()
    t1 = time.monotonic()
    run.close_window()
    steps = k - CHECKED_STEPS
    last = float(m["loss"])
    run.e2e["train_tokens_per_s"] = steps * tokens / (t1 - t0)
    run.attempted, run.failed = steps, int(not math.isfinite(last))
    # the steps before the traced span, which all ended by its start
    before = traced_at if traced_at is not None else steps
    run.record.update(cfg=run.cfg, steps=before,
                      window_s=(run.tracer.synced or t1) - t0,
                      host_s=host[:before], batch=tr["batch"], seq=tr["seq"])
    run.log(f"steps in the window {steps} over {t1 - t0!r} s; losses of "
            f"steps 1-3 {losses!r}, last {last!r}")
    del params, state, step_fn, m, batch
    run.free()
    compare(run, make_params, draw, losses, first_grad, change)


def _ref(run, make_params, draw, low: bool):
    opt = dict(run.traffic["optimizer"], **run.traffic["train"])
    with decoder.tf32(low):
        return reference.steps(run.cell.reference, make_params(), run.cfg,
                               [draw(i) for i in range(CHECKED_STEPS)], opt)


def _numbers(got_losses, got_grad, got_change, ref):
    kept = {p for p, g in ref["first_grad"].items()
            if g >= 1e-3 * float(np.median(list(ref["first_grad"].values())))}
    return {"loss_rel": max(abs(a - b) / abs(b) for a, b in
                            zip(got_losses, ref["losses"])),
            "grad_gap": gap(got_grad, ref["first_grad"]),
            "change_gap": gap(got_change, ref["change"], kept)}


def compare(run, make_params, draw, losses, first_grad, change) -> None:
    """Holds the program's numbers to the cell's limits; with
    ``run.control`` the reference in TF32 stands in the program's place
    and its numbers are held instead (the program's go to
    ``run.readings``)."""
    ref = _ref(run, make_params, draw, low=False)
    numbers = _numbers(losses, first_grad, change, ref)
    run.log("reference losses " + repr(ref["losses"]))
    if run.control:
        low = _ref(run, make_params, draw, low=True)
        run.readings.update({f"program_{k}": v for k, v in numbers.items()})
        numbers = _numbers(low["losses"], low["first_grad"], low["change"],
                           ref)
    for name, value in numbers.items():
        run.compare(name, value)
