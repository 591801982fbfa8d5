"""Whole runs of each cell at a tiny size on the CPU, the harness's look
for a card skipped: a sound run comes out correct, and each fault the
cell can have, planted under the timed path, comes out not correct.  The
plain reference against the port at a tiny size."""
import numpy as np
import pytest
import torch

from portbench import faults, harness, weights
from portbench.reference import decoder
from portbench.reference import train as reference
from portbench.tests import tiny

SEED = 2 ** 31 + 101
CPU = torch.device("cpu")
SERVING = ("hymba-1.5b.decode_heavy",)
TRAINING = "internlm2-1.8b.train_4x1k"
CASES = ([(c, None, True) for c in SERVING + (TRAINING,)]
         + [(c, f, False) for c in SERVING
            for f in ("token_altered", "state_unchanged")]
         + [(TRAINING, f, False) for f in ("state_unchanged", "half_batch")])


def _run(name, fault=None, seconds=1.5, seed=SEED):
    cell, arch = tiny.cell(name)
    with faults.planted(fault):
        return harness.run_cell(cell, seed, seconds, False, CPU, arch=arch)


@pytest.fixture
def coarse_control(monkeypatch):
    """A stand-in for TF32 on the CPU, where it changes nothing: while the
    reference runs in the control's precision, its logits are jittered
    and its loss scaled."""
    from contextlib import contextmanager
    low = {"on": False}
    forward, token_loss = decoder.forward, decoder.token_loss

    @contextmanager
    def tf32(enabled):
        was, low["on"] = low["on"], enabled
        try:
            yield
        finally:
            low["on"] = was

    def jittered(*args, **kw):
        out = forward(*args, **kw)
        return out + torch.randn_like(out) if low["on"] else out

    def scaled(*args, **kw):
        out = token_loss(*args, **kw)
        return out * 1.01 if low["on"] else out
    monkeypatch.setattr(decoder, "tf32", tf32)
    monkeypatch.setattr(decoder, "forward", jittered)
    monkeypatch.setattr(decoder, "token_loss", scaled)


@pytest.mark.parametrize("name", SERVING + (TRAINING,))
def test_the_control_stands_in_the_programs_place(name, coarse_control):
    cell, arch = tiny.cell(name)
    run = harness.run_cell(cell, SEED, 1.5, False, CPU, arch=arch,
                           control=True)
    assert not run.correct, run.checks
    assert set(run.checks) == set(cell.check["limits"])
    for key, c in run.checks.items():
        assert run.readings[f"program_{key}"] <= c["limit"], run.readings


@pytest.mark.parametrize("name,fault,correct", CASES)
def test_correct_holds_and_each_fault_breaks_it(name, fault, correct):
    run = _run(name, fault)
    assert run.correct is correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    assert set(run.checks) == set(run.cell.check["limits"])
    metrics = harness.metrics_of(run)
    assert set(metrics) == {m["name"] for m in run.cell.end_to_end}
    assert all(m["value"] > 0 for m in metrics.values())


def test_tokens_are_counted_by_delivery_over_a_window_that_cuts_a_wave():
    run = _run("hymba-1.5b.decode_heavy", seconds=1.0)
    rec = run.record
    per_wave = [w["batch"] * (1 + len(w["decode_s"])) for w in rec["waves"]]
    assert rec["delivered"] == sum(per_wave)
    # the window closed inside the last wave, whose tokens count so far
    assert 1 + len(rec["waves"][-1]["decode_s"]) < run.traffic["new_tokens"]
    assert run.e2e["gen_tokens_per_s"] == pytest.approx(
        rec["delivered"] / rec["window_s"])


def _tiny(name):
    cell, arch = tiny.cell(name)
    from repro_torch.models import transformer as T
    params = weights.make(cell.config, T.param_shapes(arch, torch.float32),
                          SEED, CPU)
    return cell.config, arch, params


@pytest.mark.parametrize("name", [SERVING[0], TRAINING])
def test_the_reference_forward_agrees_with_the_port(name):
    from repro_torch.models import transformer as T
    cfg, arch, params = _tiny(name)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg["vocab_size"], (2, 64)))
    with torch.no_grad():
        want = T.forward(params, arch, {"tokens": tokens},
                         impl="kernel")[0][..., :cfg["vocab_size"]]
        got = decoder.forward(params, cfg, tokens)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


def test_the_reference_follows_the_cache_path_of_prefill_and_decode():
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine
    cfg, arch, params = _tiny(SERVING[0])
    prompt, steps = 32, 8
    # one SSD chunk of padding at the end: later tokens change no earlier row
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg["vocab_size"], (1, prompt + 32)))
    with torch.no_grad():
        logits, cache = engine.prefill_with_cache(
            params, arch, {"tokens": tokens[:, :prompt]}, prompt + steps,
            impl="kernel")
        rows = [logits[:, -1]]
        for i in range(steps - 1):
            step = {"tokens": tokens[:, prompt + i:prompt + i + 1],
                    "length": torch.tensor(prompt + i)}
            out, cache = T.decode_step(params, arch, cache, step)
            rows.append(out[:, 0])
        want = torch.stack(rows, 1)[..., :cfg["vocab_size"]]
        got = decoder.forward(params, cfg, tokens, cache_rows_from=prompt)
        plain = decoder.forward(params, cfg, tokens)
    got = got[:, prompt - 1:prompt - 1 + steps]
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)
    # float32 rows there differ by the cache's bfloat16 rounding
    assert not torch.allclose(plain[:, prompt:prompt - 1 + steps],
                              want[:, 1:], rtol=1e-6, atol=1e-7)


def test_the_reference_training_steps_agree_with_the_port():
    from repro_torch.train import step as TS
    cell, arch = tiny.cell(TRAINING)
    cfg, _, params = _tiny(TRAINING)
    tr = cell.traffic
    tc = TS.TrainConfig(**tr["train"])
    run = harness.Run(cell, SEED, 1.0, False, CPU, 0.0, arch=arch)
    from portbench.kinds.train_steps import batches
    draw = batches(run)
    step = TS.make_train_step(arch, tc)
    p, state = params, TS.init_state(arch, tc, params)
    losses = []
    for i in range(3):
        p, state, m = step(p, state, draw(i))
        losses.append(float(m["loss"]))
    ref = reference.steps(cell.reference, params, cfg,
                          [draw(i) for i in range(3)],
                          dict(tr["optimizer"], **tr["train"]))
    assert ref["losses"] == pytest.approx(losses, rel=1e-6)
    for path, t in weights.leaves(p):
        start = dict(weights.leaves(params))[path]
        assert float((t - start).norm()) == pytest.approx(
            ref["change"][path], rel=1e-4, abs=1e-9)
