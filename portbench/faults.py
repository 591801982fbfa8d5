"""Faults planted under the timed path, to show that the comparison which
decides ``correct`` catches them (the tests, and ``calibrate.py
--fault``).  Each patches the port for the length of a ``with`` block;
nothing here runs in a benchmark run.

* ``token_altered`` — a served token changed where the server produces
  it (the first request of each wave gets the next token id);
* ``state_unchanged`` — for serving, a decode step that leaves its cache
  as it was; for training, a step that returns its params and state
  unchanged;
* ``half_batch`` — the training loss taken over the first half of the
  batch's rows, the mean over the rest.
"""
from __future__ import annotations

import contextlib

FAULTS = ("token_altered", "state_unchanged", "half_batch")


@contextlib.contextmanager
def planted(name):
    """Plants fault ``name`` (None plants nothing) until the block ends."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine
    from repro_torch.train import step as TS
    saved = []

    def patch(owner, attr, new):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    if name == "token_altered":
        argmax = engine.BatchServer._argmax

        def altered(self, last):
            out = argmax(self, last).copy()
            out[0] = (out[0] + 1) % self.cfg.vocab_size
            return out
        patch(engine.BatchServer, "_argmax", altered)
    elif name == "state_unchanged":
        decode, apply = T.decode_step, TS._apply

        def frozen_decode(params, cfg, cache, inputs, **kw):
            kept = {k: v.clone() for k, v in cache.items()}
            logits, cache = decode(params, cfg, cache, inputs, **kw)
            for k, v in kept.items():
                cache[k].copy_(v)
            return logits, cache

        def frozen_step(opt, tc, params, state, grad_fn, group, **kw):
            metrics = apply(opt, tc, params, state, grad_fn, group, **kw)[2]
            return params, state, metrics
        patch(T, "decode_step", frozen_decode)
        patch(TS, "_apply", frozen_step)
    elif name == "half_batch":
        token_ce = T.token_ce

        def half(logits, labels, cfg):
            rows = logits.shape[0] // 2
            return token_ce(logits[:rows], labels[:rows], cfg)
        patch(T, "token_ce", half)
    elif name is not None:
        raise ValueError(f"no fault {name!r}; known: {FAULTS}")
    try:
        yield
    finally:
        for owner, attr, old in reversed(saved):
            setattr(owner, attr, old)
