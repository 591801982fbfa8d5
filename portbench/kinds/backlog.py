"""A batch job: a backlog of requests kept queued through the window, so
every wave is full and the server runs above its knee.

Traffic parameters (``traffic/<mix>.json``): ``queued``, the requests
kept waiting beyond the wave being served; ``prompt_len`` (one length);
``new_tokens``; ``server`` (``n_slots``, ``max_len``); ``trace_s``, the
length of a ``--trace 1`` run's traced span at the end of the window.

The window opens as the first wave after the warm-up starts and closes at
the first decode step after ``--seconds``; the wave then running is
stopped there (a job is cut off, not drained).  End-to-end:
``gen_tokens_per_s``, the generated tokens that reached the host inside
the window (each request's ``len(result_tokens)`` at the close, every
request having started inside it) over the window's seconds.
"""
from __future__ import annotations

import time

from portbench import serving


def run(run, make_params) -> None:
    tr = run.traffic
    lens, _ = serving.lengths(run)
    if len(lens) != 1:
        raise ValueError("a backlog mix has one prompt length: the server's "
                         "waves take one length each")
    n_slots = tr["server"]["n_slots"]
    params = make_params()
    server = serving.make_server(run, params)
    stop = {"at": None, "t": None}
    started = []

    def on_step():
        if stop["at"] is not None and time.monotonic() >= stop["at"]:
            stop["t"] = time.monotonic()
            stop["tokens"] = sum(len(r.result_tokens) for r in started)
            raise serving.StopWindow

    hooks = serving.Hooks(run, server, on_step=on_step)
    serving.warm(run, server, [(n_slots, lens[0])], 2)
    hooks.waves.clear()
    rng, made = run.rng("prompts"), []

    def top_up():
        taken = sum(len(w["ids"]) for w in hooks.waves)
        while len(made) - taken < tr["queued"]:
            r = serving.request(f"r{len(made)}", serving.prompts(
                rng, lens, run.cfg["vocab_size"])[0], tr["new_tokens"])
            made.append(r)
            server.submit(r)

    top_up()
    t0 = run.open_window()
    stop["at"] = t0 + run.seconds
    while True:
        top_up()
        started[:] = made[:sum(len(w["ids"]) for w in hooks.waves)
                          + n_slots]
        try:
            server.run(max_requests=n_slots, idle_timeout_s=60.0)
        except serving.StopWindow:
            break
    run.close_window()
    taken = sum(len(w["ids"]) for w in hooks.waves)
    run.e2e["gen_tokens_per_s"] = stop["tokens"] / (stop["t"] - t0)
    run.attempted, run.failed = taken, 0
    waves, _ = hooks.split()
    steps = sum(len(w["decode_s"]) for w in waves)
    run.log(f"waves {len(hooks.waves)}, requests started {taken}, tokens "
            f"delivered {stop['tokens']} in {stop['t'] - t0!r} s; decode "
            f"steps before the traced span {steps}")
    run.record.update(cfg=run.cfg, n_slots=n_slots, waves=waves,
                      delivered=stop["tokens"], window_s=stop["t"] - t0)
    finished = [(r.prompt, list(r.result_tokens)) for r in made
                if r.done.is_set()]
    del server, hooks, made, started
    run.free()
    serving.check(run, params, finished)
