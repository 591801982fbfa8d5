"""A batch job as the ``backlog`` kind runs it (``kinds/backlog.py``: the
window, its end-to-end metric, the comparison of the served tokens), with
the logits that the window's own server served compared too, for models
whose greedy tokens say little of their state.

Such a model: a large embedding multiplier over random weights makes each
position's logits peak at its own input token by a margin no rounding
reaches, so greedy decoding repeats the prompt's last token whatever the
decode state holds, and the served tokens' gaps (``serving.check``) read 0
for a sound server, for one whose decode step leaves its cache unchanged,
and for the control alike.  The logits below the peak do depend on the
state; they are what this kind compares.

The window is ``backlog.run``'s own, run with this module's server and
comparison in place of ``serving``'s for its length.  The server is
``serving.make_server``'s, which in every wave also keeps, on the device,
the logits (over the real vocabulary) from which it picked the served
tokens of the steps ``logits_every - 1``, ``2 · logits_every - 1``, ... of
each request (position ``prompt_len - 1 + step``): one copy of the
step's logits as its argmax is taken, outside the decode graph, into a row of
one store allocated before the window for :data:`RESERVED_WAVES` waves.
An allocation inside the window can hold the host for seconds (on an
H100, one of 12.8 MB there took 4.6 s with the card idle), which the
window's rate would count; a wave past the store allocates its rows as
it goes.  The first decode step served, the warm-up wave's, copies into
the store once unkept, so the copy does not run for the first time
inside the window.  The comparison takes ``serving.check``'s sample of
the finished requests and runs each prompt and its served tokens once
through the reference in the serving cache's arithmetic
(``cache_rows_from``), padded to the module's ``seq_multiple``.  From
that one pass it reads ``serving.check``'s numbers of the served tokens,
and ``served_logit_err``: the mean, over the kept steps, of
‖program − reference‖₂ / ‖reference‖₂ of the logits.
With ``run.control`` the control (the reference in TF32) stands in the
program's place for both and is held to the limits; the program's
readings go to ``run.readings``.

Traffic parameters: those of ``backlog``, and ``logits_every``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench import serving
from portbench.kinds import backlog
from portbench.reference import decoder

LOGITS = "served_logit_err"
# the waves whose kept rows are allocated before the window: a window of
# the cell holds one whole wave and the start of the next
RESERVED_WAVES = 3


class Kept:
    """The logits a server served at every ``every``-th step of each
    request, by the request's prompt (the array ``serving.request`` was
    given, which the finished pairs hold too).  ``per_wave`` is the kept
    steps of a wave; the store holds :data:`RESERVED_WAVES` waves of
    them, made at the first decode step served."""

    def __init__(self, every: int, vocab: int, per_wave: int):
        self.every, self.vocab, self.per_wave = every, vocab, per_wave
        self.by_prompt = {}
        self.store, self.used = None, 0

    def _row(self, logits, keep: bool = True):
        """``logits`` over the real vocabulary, copied into the store's
        next row (or, with ``keep`` false, into its next row without
        taking it); a new tensor once the store is spent."""
        row = logits[..., :self.vocab]
        if self.store is None:
            self.store = row.new_empty(
                (RESERVED_WAVES * self.per_wave, *row.shape))
        if self.used == len(self.store) or self.store.shape[1:] != row.shape:
            return row.clone()
        out = self.store[self.used].copy_(row)
        self.used += keep
        return out

    def attach(self, server):
        wave_fn, argmax = server._wave, server._argmax
        state = {"warm": False}

        def wave(reqs):
            state.update(step=0, rows={})
            for i, r in enumerate(reqs):
                self.by_prompt[id(r.prompt)] = (i, state["rows"])
            wave_fn(reqs)

        def keep(last):
            step = state["step"]
            if step % self.every == self.every - 1:
                state["rows"][step] = self._row(last)
            elif step and not state["warm"]:
                self._row(last, keep=False)
            state["warm"] = state["warm"] or step > 0
            state["step"] = step + 1
            return argmax(last)
        server._wave, server._argmax = wave, keep
        return server

    def served(self, finished):
        """[(prompt, tokens, {step: logits (V,)})] of ``finished``'s
        (prompt, tokens) pairs; the waves' other rows are let go."""
        out = []
        for prompt, tokens in finished:
            i, rows = self.by_prompt[id(prompt)]
            out.append((prompt, tokens, {s: t[i] for s, t in rows.items()}))
        self.by_prompt.clear()
        return out


@contextlib.contextmanager
def _in_place_of(module, **fns):
    """``module``'s functions ``fns`` replaced until the block ends."""
    was = {name: getattr(module, name) for name in fns}
    for name, fn in fns.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in was.items():
            setattr(module, name, fn)


def run(run, make_params) -> None:
    every = run.traffic["logits_every"]
    kept = Kept(every, run.cfg["vocab_size"],
                run.traffic["new_tokens"] // every)
    make_server = serving.make_server
    done = {}

    def server_keeping(run_, params):
        return kept.attach(make_server(run_, params))

    def compared_after(run_, params, finished):
        done.update(params=params, finished=finished)

    with _in_place_of(serving, make_server=server_keeping,
                      check=compared_after):
        backlog.run(run, make_params)
    check(run, done["params"], kept.served(done["finished"]))


def _rel_err(got, want):
    """‖got − want‖₂ / ‖want‖₂ of each row of (T, V) logits."""
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).cpu()


def _numbers(gaps, errs) -> dict:
    numbers = serving._numbers(torch.cat(gaps) if gaps else torch.zeros(0))
    errs = torch.cat(errs) if errs else torch.zeros(0)
    numbers[LOGITS] = float(errs.mean()) if errs.numel() else float("inf")
    return numbers


@torch.no_grad()
def check(run, params, served) -> None:
    """Holds ``served`` ((prompt, tokens, kept logits) of the finished
    requests) to the reference: ``serving.check``'s numbers of the served
    tokens, and ``served_logit_err`` at the kept steps, each to its limit
    in the cell's ``check.limits``."""
    cfg, model = run.cfg, run.cell.reference
    multiple = model.seq_multiple(cfg)
    gaps, errs, low_gaps, low_errs = [], [], [], []
    for prompt, tokens, rows in serving.sample(
            run, served, run.cell.check["sample_requests"]):
        s = len(prompt)
        seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])
        padded = -(-len(seq) // multiple) * multiple
        ids = torch.zeros((1, padded), dtype=torch.long, device=run.device)
        ids[0, :len(seq)] = torch.from_numpy(seq.astype(np.int64))
        # the positions that served a token: the prompt's last and on
        ref = model.forward(params, cfg, ids, cache_rows_from=s)[0][
            s - 1:len(seq)]
        best = ref.max(-1).values
        got = torch.as_tensor(tokens, dtype=torch.long, device=run.device)
        steps = sorted(rows)
        gaps.append(serving._gaps(ref, best, got).cpu())
        if steps:
            errs.append(_rel_err(torch.stack([rows[j] for j in steps]),
                                 ref[steps]))
        if run.control:
            with decoder.tf32(True):
                low = model.forward(params, cfg, ids, cache_rows_from=s)[0][
                    s - 1:len(seq)]
            low_gaps.append(serving._gaps(ref, best, low.argmax(-1)).cpu())
            if steps:
                low_errs.append(_rel_err(low[steps], ref[steps]))
            del low
        del ref, rows
    numbers = _numbers(gaps, errs)
    run.log(f"served tokens compared {sum(g.numel() for g in gaps)}, mean "
            f"gap {numbers['served_gap_mean']!r}; logits compared at "
            f"{sum(e.numel() for e in errs)} kept steps, mean relative "
            f"error {numbers[LOGITS]!r}, largest "
            f"{max((float(e.max()) for e in errs), default=float('inf'))!r}")
    if run.control:
        run.readings.update({f"program_{k}": v for k, v in numbers.items()})
        numbers = _numbers(low_gaps, low_errs)
        run.log(f"control at the same positions: mean gap "
                f"{numbers['served_gap_mean']!r}, mean relative logit "
                f"error {numbers[LOGITS]!r}")
    for name in run.cell.check["limits"]:
        run.compare(name, numbers[name])
