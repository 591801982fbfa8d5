"""What the serving kinds share: the server under test, the prompts drawn
from the seed, the warm-up of the cell's own shapes, the benchmark's spans
around the server's calls into its layers, and the comparison that decides
``correct``.

The comparison for a served model: once the window has closed and the
server is freed, a sample of the finished requests, drawn from the seed and
holding the longest, is run through the configuration's plain reference
(the module its ``reference`` key names, ``cell.reference``) over each
prompt followed by its served tokens, padded to the module's
``seq_multiple``.
At each position that served a token (the prompt's last and on), the gap by
which the served token's reference logit lies below the reference's best is
read; the cell's numbers are the widest and the mean of those gaps.  Under
greedy decoding a sound server reads 0 there, or a rounding's worth at a
near tie.  The control (``calibrate.py --control`` and the card test, never
a benchmark run) is the reference in TF32 put in the program's place: at
the same positions of the same sequences, the token the control puts first
is read the same way, and its numbers are held to the same limits.
"""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import decoder
from portbench.tracing import span


class StopWindow(Exception):
    """Raised by the benchmark's own hook to end a wave at the window's
    close (the backlog kind: a batch job is stopped, not drained)."""


def make_server(run, params):
    from repro_torch.serve.engine import BatchServer
    srv = run.traffic["server"]
    return BatchServer(params, run.arch, n_slots=srv["n_slots"],
                       max_len=srv["max_len"], impl=run.cfg["impl"],
                       device=run.device)


def lengths(run) -> Tuple[List[int], List[float]]:
    mix = run.traffic["prompt_len"]
    return [int(k) for k in mix], [float(v) for v in mix.values()]


def prompts(rng, lens: Sequence[int], vocab: int) -> List[np.ndarray]:
    return [rng.integers(0, vocab, size=n, dtype=np.int64).astype(np.int32)
            for n in lens]


def request(rid: str, prompt, new_tokens: int):
    from repro_torch.serve.engine import Request
    return Request(request_id=rid, prompt=prompt, max_new_tokens=new_tokens)


def warm(run, server, shapes, new_tokens: int) -> None:
    """Serves one wave of each (batch, prompt length) in ``shapes``, so
    the kernels are built and loaded and each shape's graphs have been
    captured once before the window."""
    rng = run.rng("warm")
    for b, s in shapes:
        for i, p in enumerate(prompts(rng, [s] * b, run.cfg["vocab_size"])):
            server.submit(request(f"warm-{b}-{s}-{i}", p, new_tokens))
        server.run(max_requests=b, idle_timeout_s=60.0)


class Hooks:
    """The benchmark's spans around the server's two calls into its layers
    (a wave; a decode step), the tracer's ticks at the starts of decode
    steps, and the requests of each wave with the wave's start, kept by the
    benchmark.  ``cut`` is the (wave, decode step) at which the traced span
    began."""

    def __init__(self, run, server, on_step=None):
        self.run, self.server, self.on_step = run, server, on_step
        self.waves: List[dict] = []
        self.cut = None
        serve_wave, decode = server._serve_wave, server._decode

        def wave_hook(wave):
            info = {"ids": [r.request_id for r in wave],
                    "start": time.monotonic(), "traced": run.tracer.running,
                    "index": len(server.waves)}
            self.waves.append(info)
            with span("server.wave"):
                serve_wave(wave)

        def decode_hook(*args):
            was = run.tracer.running
            run.tracer.tick()
            if run.tracer.running and not was and self.waves:
                self.cut = (len(self.waves) - 1, len(
                    server.waves[self.waves[-1]["index"]]["decode_s"]))
            with span("server.decode"):
                out = decode(*args)
            if self.on_step is not None:
                self.on_step()
            return out

        server._serve_wave = wave_hook
        server._decode = decode_hook

    def split(self):
        """(waves before the traced span, waves inside it): each the
        program's record of the wave with the benchmark's; a wave the
        span began in keeps its decode steps before the span."""
        began = self.run.tracer.synced
        before, inside = [], []
        for i, w in enumerate(self.waves):
            stats = dict(self.server.waves[w["index"]], **w)
            stats["decode_s"] = list(stats["decode_s"])
            if w["traced"]:
                inside.append(stats)
            elif self.cut is not None and i >= self.cut[0]:
                if i == self.cut[0]:
                    stats["decode_s"] = stats["decode_s"][:self.cut[1]]
                    before.append(stats)
            elif began is None or w["start"] < began:
                before.append(stats)
        return before, inside


def sample(run, finished, n: int) -> list:
    """``n`` of the ``finished`` requests drawn from the seed, the longest
    (prompt and served tokens) among them."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: (
        len(finished[i][0]) + len(finished[i][1]), -i))
    rest = [i for i in range(len(finished)) if i != longest]
    picked = run.rng("sample").choice(len(rest), size=min(n - 1, len(rest)),
                                      replace=False) if rest and n > 1 else []
    return [finished[longest]] + [finished[rest[i]] for i in picked]


def _gaps(ref, best, tokens):
    """The gap of each of ``tokens`` below ``best`` under ``ref``."""
    return best - ref.gather(-1, tokens[:, None])[:, 0]


def _numbers(gaps) -> dict:
    if not gaps.numel():
        return {"served_gap": float("inf"), "served_gap_mean": float("inf")}
    return {"served_gap": float(gaps.max()),
            "served_gap_mean": float(gaps.mean())}


@torch.no_grad()
def check(run, params, finished) -> None:
    """Compares the served tokens of a sample of ``finished`` ((prompt,
    tokens) pairs) with the reference, and holds the numbers the cell's
    ``check.limits`` name to their limits: ``served_gap``, the widest gap
    by which a served token's reference logit lies below the reference's
    best, and ``served_gap_mean``, its mean over the served tokens.

    With ``run.control`` the control's tokens stand in the program's place
    at the same positions, and it is the control's numbers that are held
    to the limits (the run should come out not correct); the program's go
    to ``run.readings``."""
    cfg, model = run.cfg, run.cell.reference
    multiple = model.seq_multiple(cfg)
    gaps, low_gaps = [], []
    for prompt, tokens in sample(run, finished,
                                 run.cell.check["sample_requests"]):
        s = len(prompt)
        seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])
        padded = -(-len(seq) // multiple) * multiple
        ids = torch.zeros((1, padded), dtype=torch.long, device=run.device)
        ids[0, :len(seq)] = torch.from_numpy(seq.astype(np.int64))
        # the positions that served a token: the prompt's last and on
        ref = model.forward(params, cfg, ids, cache_rows_from=s)[0]
        served = ref[s - 1:len(seq)]
        del ref
        best = served.max(-1).values
        got = torch.as_tensor(tokens, dtype=torch.long, device=run.device)
        gaps.append(_gaps(served, best, got).cpu())
        if run.control:
            with decoder.tf32(True):
                low = model.forward(params, cfg, ids, cache_rows_from=s)[0]
            pick = low[s - 1:len(seq)].argmax(-1)
            del low
            low_gaps.append(_gaps(served, best, pick).cpu())
        del served
    gaps = torch.cat(gaps) if gaps else torch.zeros(0)
    numbers = _numbers(gaps)
    run.log(f"served tokens compared {gaps.numel()}, widest gap "
            f"{numbers['served_gap']!r}, mean gap "
            f"{numbers['served_gap_mean']!r}, tokens not the reference's "
            f"first {int((gaps > 0).sum())}")
    if run.control:
        low = torch.cat(low_gaps) if low_gaps else torch.zeros(0)
        run.readings.update({f"program_{k}": v for k, v in numbers.items()})
        numbers = _numbers(low)
        run.log(f"control at the same {low.numel()} positions: widest gap "
                f"{numbers['served_gap']!r}, mean gap "
                f"{numbers['served_gap_mean']!r}, tokens not the "
                f"reference's first {int((low > 0).sum())}")
    for name in run.cell.check["limits"]:
        run.compare(name, numbers[name])
