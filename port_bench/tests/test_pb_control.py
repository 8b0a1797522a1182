"""The controls and faults at the cells' own sizes, on the card (they skip
without one): put in the program's place and judged by the cell's own
comparison, each comes out not correct, while the program's timed path on
the same seed comes out correct.

    python3 -m pytest port_bench/tests/test_pb_control.py -q

from the root of a checkout with a card (a few minutes with the kernels'
build; ``port_bench.control`` reads the same over many seeds)."""

from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the controls are read at the cells' own sizes")
    from port_bench.run import prepare_environment

    prepare_environment(REPO)
    return torch.device("cuda")


def _run(name, device):
    from port_bench import spec
    from port_bench.run import Run

    return Run(spec.load_cell(name, REPO), 7_100_000_003, 0.0, False, device)


def test_synthesis_control(card):
    from port_bench.control import synth_readings

    run = _run("synth-offline-b20x10", card)
    row = next(synth_readings(run, [run.seed], 1))
    assert row["program"]["correct"] and not row["control"]["correct"], row


def test_training_control_and_faults(card):
    from port_bench.control import train_readings

    run = _run("train-s7-b6", card)
    row = next(train_readings(run, [run.seed], 1))
    assert row["program"]["correct"], row
    for side in ("control", "half_batch", "unchanged"):
        assert not row[side]["correct"], (side, row)
