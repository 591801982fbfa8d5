"""The control on the card, at each cell's own size: the reference in the
precision below the one the configuration states (TF32) put in the
program's place comes out not correct through the harness's own
comparison, while the program's numbers of the same run keep to their
limits.  Skips without an sm_90 card; run it there with

    python -m pytest -q portbench/tests/test_portbench_card.py
"""
import pytest

from portbench import harness

SECONDS = {"internlm2-1.8b.train_4x1k": 3.0,
           "hymba-1.5b.decode_heavy": 22.0}


@pytest.mark.parametrize("name", list(SECONDS))
def test_the_control_fails_where_the_program_passes(card, name):
    cell = harness.load_cell(name)
    run = harness.run_cell(cell, 2 ** 31 + 977, SECONDS[name], False, card,
                           control=True)
    assert not run.correct, (run.checks, run.readings)
    for key, c in run.checks.items():
        assert run.readings[f"program_{key}"] <= c["limit"], run.readings
